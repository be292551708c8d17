"""The policy pack: fleet scale-out, shard restart, serving pressure
relief, replica restart and probe-failure restart.

Counterpart of ``deeplearning4j_tpu/control/policies.py``. Each function
returns a :class:`~.plane.ControlPolicy` closed over the actuators the
caller hands it (the pack reaches for no global, so one process can run
several planes against several fleets). Nothing is installed by default::

    plane = get_control_plane()
    plane.add(fleet_scale_policy(group, master),
              shard_restart_policy(group),
              serving_pressure_policy(registry, "char_rnn"))
    plane.start()

Act late (a sustained breach), back off long (cooldown well past the
actuation's latency), and make every step reversible: the serving policy
restores the pre-incident admission knobs on the triggering alert's
resolved edge.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

from .plane import ControlPolicy

log = logging.getLogger(__name__)

__all__ = ["fleet_scale_policy", "shard_restart_policy",
           "serving_pressure_policy", "fleet_replica_policy",
           "probe_failure_policy", "default_control_policies"]


def fleet_scale_policy(group, master, *, rule: str = "fleet_worker_stale",
                       step: int = 1, max_servers: int = 4,
                       cooldown_s: float = 60.0, sustain_s: float = 0.0,
                       name: str = "fleet_scale") -> ControlPolicy:
    """Scale the paramserver fleet out on a sustained staleness alert.

    The action is the rebalance runbook end to end: ``group.scale_to``
    re-splits the merged state across ``+step`` nodes, then
    ``master.remap`` rebinds the training master — which first drains
    any in-flight round on the overlap pipeline, so the membership
    change never splits a logical push across two shard layouts."""

    def scale_fleet(ctx):
        new_n = min(group.num_servers + int(step), int(max_servers))
        if new_n <= group.num_servers:
            return "at_max"
        addrs = group.scale_to(new_n)
        master.remap(addrs)
        return f"scaled_to_{new_n}"

    return ControlPolicy(
        name, scale_fleet, rules=(rule,), action_name="scale_to",
        cooldown_s=cooldown_s, sustain_s=sustain_s,
        description=f"scale paramserver fleet +{step} (cap "
                    f"{max_servers}) on sustained {rule}")


def shard_restart_policy(group, *, event: str = "shard_server_down",
                         cooldown_s: float = 10.0,
                         name: str = "shard_restart") -> ControlPolicy:
    """Auto-restart a dead shard server from its latest latched snapshot
    when a client reports it down (the ``shard_server_down`` flight
    event). A still-running server is left alone — a transient transport
    error must not bounce a healthy node; the client's own retry loop
    owns that case. Restart-from-snapshot keeps version numbering
    intact, so rejoining clients resync one DELTA_FULL and ride frames
    again."""

    def restart_shard(ctx):
        shard = ctx.get("shard")
        if shard is None:
            return "no_shard_in_event"
        shard = int(shard)
        if not 0 <= shard < group.num_servers:
            return "unknown_shard"
        srv = group.servers[shard]
        if getattr(srv, "_running", False):
            return "still_running"
        group.restart(shard, snapshot=group.last_snapshot(shard))
        return "restarted"

    return ControlPolicy(
        name, restart_shard, event=event, action_name="restart",
        cooldown_s=cooldown_s,
        description="restart a down shard server from its latest "
                    "snapshot")


def serving_pressure_policy(registry, model: str, *,
                            rules: Sequence[str] = (
                                "serving_p99_breach",
                                "serving_queue_saturation"),
                            factor: float = 0.5, min_cap: int = 8,
                            initial_cap: int = 64,
                            linger_ms: float = 0.0,
                            cooldown_s: float = 30.0,
                            sustain_s: float = 0.0,
                            name: Optional[str] = None) -> ControlPolicy:
    """Relieve serving pressure on a sustained p99/queue alert: step the
    model's admission cap down (``factor`` of the current cap, floored
    at ``min_cap``; an uncapped model gets ``initial_cap``), drop linger
    to ``linger_ms`` and force a flush — shed load NOW, serve what was
    already admitted. The pre-incident knobs are restored on the
    triggering alert's resolved edge, so the step is an incident-scoped
    clamp, not a permanent downgrade."""
    state = {}

    def step_admission(ctx):
        served = registry.get(model)
        cap = served.batcher.max_queue_examples
        new_cap = (max(int(min_cap), int(cap * factor))
                   if cap is not None else int(initial_cap))
        prev = served.set_admission(max_queue_examples=new_cap,
                                    linger_ms=linger_ms)
        # the FIRST step's knobs are the pre-incident baseline; a
        # repeated step inside one long incident must not "restore" to
        # the already-clamped values
        state.setdefault("prev", prev)
        served.batcher.flush(wait=False)
        return f"cap_{new_cap}"

    def restore_admission(ctx):
        prev = state.pop("prev", None)
        if prev is None:
            return "nothing_to_restore"
        registry.get(model).set_admission(**prev)
        return "restored"

    return ControlPolicy(
        name or f"serving_pressure_{model}", step_admission,
        rules=tuple(rules), action_name="set_admission",
        on_resolve=restore_admission, resolve_name="restore_admission",
        cooldown_s=cooldown_s, sustain_s=sustain_s,
        description=f"step {model!r} admission cap ×{factor} (floor "
                    f"{min_cap}) + flush on sustained serving pressure; "
                    f"restore on resolve")


def fleet_replica_policy(collector, restart, *,
                         rule: str = "fleet_target_down",
                         cooldown_s: float = 30.0,
                         sustain_s: float = 0.0,
                         name: str = "fleet_replica_restart"
                         ) -> ControlPolicy:
    """Bounce unresponsive scraped replicas on a sustained
    ``fleet_target_down`` alert (the scrape-plane pack,
    ``monitor.alerts.default_fleet_scope_rules``).

    ``restart`` is the caller's actuator — ``fn(label, url)`` doing
    whatever "restart" means in its deployment (respawn a process,
    re-create a container, page a human). The policy asks the
    ``collector`` which targets are currently down at FIRE time rather
    than trusting the alert payload: between the rule sustaining and the
    plane acting, a replica may have recovered on its own, and bouncing
    a healthy node is the one thing a remediation loop must never do."""

    def restart_down(ctx):
        down = collector.down_targets()
        if not down:
            return "none_down"
        for t in down:
            restart(t.label, t.url)
        return "restarted_" + ",".join(t.label for t in down)

    return ControlPolicy(
        name, restart_down, rules=(rule,), action_name="restart_replica",
        cooldown_s=cooldown_s, sustain_s=sustain_s,
        description=f"restart scraped replicas that are down at fire "
                    f"time on sustained {rule}")


def probe_failure_policy(prober, restart, *,
                         rules: Sequence[str] = ("probe_mismatch",
                                                 "probe_deadman"),
                         cooldown_s: float = 30.0,
                         sustain_s: float = 0.0,
                         name: str = "probe_failure_restart"
                         ) -> ControlPolicy:
    """Bounce replicas that FAIL PROBES on a sustained probe-plane alert
    (``monitor.alerts.default_probe_rules``: mismatch — wrong answers vs
    the golden set — or deadman — no correct answer inside the window).

    This is the gray-failure remediation no self-reported signal can
    drive: the scrape-plane ``fleet_replica_policy`` only sees a replica
    that stops ANSWERING, while a wedged model keeps ``/telemetry``
    perfectly healthy. ``restart`` is the caller's actuator —
    ``fn(label, url)``, same contract as the scrape-plane policy. The
    policy asks the ``prober`` which targets are failing at FIRE time
    rather than trusting the alert payload: a replica whose probes
    recovered between the rule sustaining and the plane acting must not
    be bounced."""

    def restart_failing(ctx):
        failing = prober.failing_targets()
        if not failing:
            return "none_failing"
        for t in failing:
            restart(t.label, t.url)
        return "restarted_" + ",".join(t.label for t in failing)

    return ControlPolicy(
        name, restart_failing, rules=tuple(rules),
        action_name="restart_replica",
        cooldown_s=cooldown_s, sustain_s=sustain_s,
        description="restart replicas failing synthetic probes "
                    "(mismatch/deadman) at fire time — the gray-failure "
                    "remediation path")


def default_control_policies(*, group=None, master=None, registry=None,
                             model: Optional[str] = None, collector=None,
                             restart=None, prober=None, probe_restart=None,
                             **overrides):
    """The full shipped pack for whatever actuators the caller has:
    fleet scale + shard restart when a ``group`` (and ``master``) is
    given, serving pressure relief when a ``registry`` + ``model`` is,
    replica restart when a scrape-plane ``collector`` + ``restart``
    actuator is, probe-failure restart when a ``prober`` is (its
    actuator is ``probe_restart``, falling back to ``restart``).
    ``overrides`` are forwarded to every policy function that accepts
    them."""
    import inspect
    out = []

    def _kw(fn):
        accepted = set(inspect.signature(fn).parameters)
        return {k: v for k, v in overrides.items() if k in accepted}

    if group is not None and master is not None:
        out.append(fleet_scale_policy(group, master,
                                      **_kw(fleet_scale_policy)))
    if group is not None:
        out.append(shard_restart_policy(group,
                                        **_kw(shard_restart_policy)))
    if registry is not None and model is not None:
        out.append(serving_pressure_policy(
            registry, model, **_kw(serving_pressure_policy)))
    if collector is not None and restart is not None:
        out.append(fleet_replica_policy(collector, restart,
                                        **_kw(fleet_replica_policy)))
    probe_actuator = probe_restart if probe_restart is not None else restart
    if prober is not None and probe_actuator is not None:
        out.append(probe_failure_policy(prober, probe_actuator,
                                        **_kw(probe_failure_policy)))
    return out
