"""The closed-loop control plane: alert edges in, actuator calls out.

Counterpart of ``deeplearning4j_tpu/control/plane.py``, under its series
(``control_actions_total{policy,action,outcome}``,
``control_cooldown_active{policy}``), its flight event (``control_action``)
and its document keys.

A :class:`ControlPlane` is an opt-in daemon (nothing starts implicitly,
``start()`` is idempotent, ``stop()`` joins) that maps alert
firing/resolved edges and flight-recorder events through declarative
:class:`ControlPolicy` rules to actuator calls: the sharded group's
``scale_to``/``restart``, the training master's ``remap``, a served
model's ``set_admission`` (:mod:`.policies`).

Every policy runs an OK -> PENDING -> COOLDOWN machine:

- **edge-triggered**: a policy acts on the ``alert_firing`` edge (or a
  watched flight event), never on the level: one incident, one action.
- **hysteresis** (``sustain_s``): the alert must stay firing that long
  past the edge before the action runs; a resolve inside the window
  cancels.
- **cooldown** (``cooldown_s``): after acting, the policy stays latched in
  COOLDOWN (further firing edges are counted as suppressed) and re-arms
  only once the cooldown has elapsed and the triggering alert resolved
  (flight-event policies re-arm on the cooldown alone; no resolve edge
  exists for them).

Threading: the subscription callback only appends to a lock-free deque
(it runs under ``AlertEngine._eval_lock``); the tick drains it, runs the
state machine under ``ControlPlane._lock`` and calls actuators with no
lock held, so that lock is a leaf. ``tick(now=)`` is the deterministic
seam.

Every action is a ``control_action`` flight event carrying the triggering
alert's rule and exemplar trace id, bumps ``control_actions_total`` and
holds ``control_cooldown_active`` at 1 while latched. Routes: ``GET
/control`` on every server of the port, and the ``control`` block of
``GET /profile`` (:func:`control_block`). No policy is installed by
default.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..monitor.lockwatch import make_lock

log = logging.getLogger(__name__)

__all__ = ["ControlPolicy", "ControlPlane", "get_control_plane",
           "control_block"]

OK, PENDING, COOLDOWN = "OK", "PENDING", "COOLDOWN"

#: default daemon cadence; tests bypass it entirely via tick()
DEFAULT_INTERVAL_S = 0.5


def _action_counter(policy: str, action: str, outcome: str):
    from ..monitor.registry import get_registry
    return get_registry().counter(
        "control_actions_total",
        "control-plane actuator invocations by policy, actuator, and "
        "outcome (suppressed = edge arrived while latched in cooldown)",
        policy=policy, action=action, outcome=outcome)


def _cooldown_gauge(policy: str):
    from ..monitor.registry import get_registry
    return get_registry().gauge(
        "control_cooldown_active",
        "1 while the policy's OK→COOLDOWN machine is latched — firing "
        "edges are suppressed until it re-arms", policy=policy)


class ControlPolicy:
    """One declarative rule: *when* (alert rule names or a flight event)
    → *what* (the actuator callable) under the anti-flap state machine.

    ``action(ctx)`` receives the triggering edge's payload (``rule``,
    ``exemplar_trace_id``, ``value``, ``detail`` for alert edges; the
    recorded fields for flight events) and returns a short outcome
    string (``None`` → ``"ok"``); raising records ``outcome="error"``
    and still latches the cooldown (a failed actuator retrying every
    tick is exactly the flapping the latch exists to stop).
    ``on_resolve(ctx)``, when given, runs on the triggering alert's
    resolved edge — the restore half of a step-down actuator."""

    def __init__(self, name: str, action: Callable[[Dict[str, Any]],
                                                   Optional[str]], *,
                 rules: Sequence[str] = (), event: Optional[str] = None,
                 action_name: Optional[str] = None,
                 on_resolve: Optional[Callable[[Dict[str, Any]],
                                               Optional[str]]] = None,
                 resolve_name: Optional[str] = None,
                 cooldown_s: float = 30.0, sustain_s: float = 0.0,
                 description: str = ""):
        if not rules and event is None:
            raise ValueError(f"policy {name!r} matches nothing: give "
                             f"rules=(...) and/or event=...")
        self.name = str(name)
        self.action = action
        self.action_name = str(action_name or getattr(
            action, "__name__", "action"))
        self.on_resolve = on_resolve
        self.resolve_name = str(resolve_name or self.action_name
                                + "_restore")
        self.rules = tuple(str(r) for r in rules)
        self.event = str(event) if event is not None else None
        self.cooldown_s = float(cooldown_s)
        self.sustain_s = float(sustain_s)
        self.description = description
        # ---- state machine (guarded by the owning plane's _lock) ----
        self.state = OK
        self.pending_since: Optional[float] = None
        self.pending_ctx: Optional[Dict[str, Any]] = None
        self.cooldown_until: Optional[float] = None
        self.resolved_seen = False
        self.fired_count = 0
        self.suppressed_count = 0
        self.last_action: Optional[Dict[str, Any]] = None

    def _reset(self):
        self.state = OK
        self.pending_since = None
        self.pending_ctx = None
        self.cooldown_until = None
        self.resolved_seen = False

    def to_dict(self, now: float) -> Dict[str, Any]:
        remaining = 0.0
        if self.state == COOLDOWN and self.cooldown_until is not None:
            remaining = max(0.0, self.cooldown_until - now)
        return {"policy": self.name, "state": self.state,
                "rules": list(self.rules), "event": self.event,
                "action": self.action_name,
                "cooldown_s": self.cooldown_s,
                "sustain_s": self.sustain_s,
                "cooldown_remaining_s": remaining,
                "fired_count": self.fired_count,
                "suppressed_count": self.suppressed_count,
                "last_action": self.last_action,
                "description": self.description}


class ControlPlane:
    """Holds policies, drives their state machines, invokes actuators.

    One plane per process (:func:`get_control_plane`). ``start()``
    subscribes to the alert engine's edge stream and runs the tick
    thread; ``tick()`` is the deterministic test seam. Policies may be
    added/removed live — removal while that policy's action is mid-
    flight is safe (the detached policy's bookkeeping is discarded and
    its cooldown gauge zeroed; see ``_finish_action``)."""

    def __init__(self, engine=None):
        self._lock = make_lock("ControlPlane._lock")
        self._engine = engine
        self._policies: Dict[str, ControlPolicy] = {}
        # lock-free handoff from the alert-engine fan-out thread: the
        # subscription callback must not take ANY lock (it runs under
        # AlertEngine._eval_lock — an actuator there would graft the
        # whole actuator lock tree onto the evaluation lock)
        self._edges: deque = deque(maxlen=1024)
        self._actions: deque = deque(maxlen=256)
        self._event_seq: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.interval_s = DEFAULT_INTERVAL_S
        self.last_tick: Optional[float] = None

    @property
    def engine(self):
        if self._engine is not None:
            return self._engine
        from ..monitor.alerts import get_alert_engine
        return get_alert_engine()

    # ------------------------------------------------------------ policies
    def add(self, *policies: ControlPolicy) -> "ControlPlane":
        with self._lock:
            for p in policies:
                if p.name in self._policies:
                    raise ValueError(f"control policy {p.name!r} already "
                                     f"registered")
                self._policies[p.name] = p
        return self

    def remove(self, name: str):
        """Detach a policy. An action already handed to the executor may
        still complete (the actuator ran for a real edge), but its state
        is discarded and no FUTURE edge can fire it."""
        with self._lock:
            p = self._policies.pop(name, None)
            if p is not None:
                p._reset()
        if p is not None:
            # outside the lock (registry takes its own): a removed
            # policy must not strand its cooldown gauge at 1
            _cooldown_gauge(name).set(0.0)

    def policies(self) -> List[ControlPolicy]:
        with self._lock:
            return [self._policies[n] for n in sorted(self._policies)]

    def clear(self):
        """Full reset: policies, pending edges, the action ring, and the
        flight-event cursor (the next tick re-primes) — a cleared plane
        must surface as empty, not replay a previous wiring's history."""
        with self._lock:
            names, self._policies = list(self._policies), {}
            self._actions.clear()
            self._edges.clear()
            self._event_seq = None
        for name in names:
            _cooldown_gauge(name).set(0.0)

    # ----------------------------------------------------------- lifecycle
    def _on_edge(self, event: str, payload: Dict[str, Any]):
        """AlertEngine subscription callback — enqueue only, never act:
        this runs on the evaluation thread under ``_eval_lock``."""
        self._edges.append((event, payload))

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def start(self, interval_s: Optional[float] = None) -> "ControlPlane":
        """Subscribe + start the tick daemon (idempotent)."""
        if interval_s is not None:
            self.interval_s = float(interval_s)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="control-plane", daemon=True)
            thread = self._thread
        # outside our lock: each takes its own (flight recorder, engine)
        self._prime_cursor()
        self.engine.subscribe(self._on_edge)
        thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        """Unsubscribe and join the tick thread. Queued-but-unprocessed
        edges survive in the deque — a later start() resumes them."""
        self.engine.unsubscribe(self._on_edge)
        with self._lock:
            thread, self._thread = self._thread, None
            if thread is not None:
                # inside the lock for the same reason MetricsHistory.stop
                # sets inside: a concurrent start() serializes behind us
                self._stop.set()
        if thread is not None:
            thread.join(timeout=timeout)

    def _loop(self):
        self.tick()
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("control-plane tick failed")

    # ---------------------------------------------------------------- tick
    def _prime_cursor(self):
        """Fast-forward the flight-event cursor to 'now' without
        reacting — the plane only answers for events recorded after it
        came up, never replays history as fresh incidents. The recorder
        read happens OUTSIDE ``_lock`` (it takes its own; ours stays a
        leaf), only the cursor store goes under it: the cursor is
        written here on start()'s thread AND on the tick thread, and
        cleared by clear() on any caller's — all under ``_lock``."""
        from ..monitor.flightrec import get_flight_recorder
        events = get_flight_recorder().events()
        seq = int(events[-1]["seq"]) if events else 0
        with self._lock:
            self._event_seq = seq

    def _new_flight_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            watched = {p.event for p in self._policies.values()
                       if p.event is not None}
            cursor = self._event_seq
        if not watched:
            return []
        if cursor is None:
            self._prime_cursor()
            return []
        from ..monitor.flightrec import get_flight_recorder
        events = get_flight_recorder().events()
        fresh = [e for e in events
                 if int(e.get("seq", 0)) > cursor
                 and e.get("event") in watched]
        if events:
            with self._lock:
                if self._event_seq is not None:
                    # clear() raced the recorder read: stay reset so the
                    # next tick re-primes instead of resurrecting the
                    # pre-clear cursor
                    self._event_seq = max(cursor, int(events[-1]["seq"]))
        return fresh

    def tick(self, now: Optional[float] = None) -> int:
        """One control pass: drain queued alert edges, scan new flight
        events, run timers (sustain maturation, cooldown re-arm), then
        execute the surviving actions outside every lock. Returns the
        number of actuator/bookkeeping executions this pass."""
        now = float(now) if now is not None else time.time()
        flight = self._new_flight_events()
        drained: List[Tuple[str, Dict[str, Any]]] = []
        while True:
            try:
                drained.append(self._edges.popleft())
            except IndexError:
                break
        todo: List[Optional[Tuple[ControlPolicy, str, Dict[str, Any]]]] = []
        armed: Dict[str, int] = {}
        with self._lock:
            self.last_tick = now
            for event, payload in drained:
                self._edge_locked(event, payload, now, todo, armed)
            for ev in flight:
                self._flight_locked(ev, now, todo, armed)
            self._timers_locked(now, todo, armed)
        ran = 0
        for entry in todo:
            if entry is None:
                continue            # cancelled by a same-batch resolve
            self._execute(*entry, now=now)
            ran += 1
        return ran

    # ------------------------------------------------- state machine (locked)
    def _arm(self, p: ControlPolicy, ctx: Dict[str, Any], now: float,
             todo: list, armed: Dict[str, int]):
        p.state = COOLDOWN
        p.cooldown_until = now + p.cooldown_s
        # flight-event policies re-arm on cooldown alone: there is no
        # resolved edge to wait for (the restart IS the resolution)
        p.resolved_seen = ctx.get("_from_event", False)
        p.fired_count += 1
        armed[p.name] = len(todo)
        todo.append((p, "act", ctx))

    def _edge_locked(self, event: str, payload: Dict[str, Any],
                     now: float, todo: list, armed: Dict[str, int]):
        rule = payload.get("rule")
        firing = event == "alert_firing"
        for p in self._policies.values():
            if rule not in p.rules:
                continue
            if firing:
                if p.state == OK:
                    if p.sustain_s > 0:
                        p.state = PENDING
                        p.pending_since = now
                        p.pending_ctx = dict(payload)
                    else:
                        self._arm(p, dict(payload), now, todo, armed)
                elif p.state == COOLDOWN:
                    p.suppressed_count += 1
                    todo.append((p, "suppress", dict(payload)))
                # PENDING: already waiting out its sustain window
            else:
                if p.state == PENDING:
                    # resolve inside the sustain window: the hysteresis
                    # did its job — no action for a transient breach
                    p._reset()
                elif p.state == COOLDOWN:
                    idx = armed.pop(p.name, None)
                    if idx is not None:
                        # armed earlier in THIS batch, resolved before
                        # anything executed: cancel, never act
                        todo[idx] = None
                        p._reset()
                        continue
                    p.resolved_seen = True
                    if p.on_resolve is not None:
                        todo.append((p, "resolve", dict(payload)))
                    if p.cooldown_until is not None \
                            and now >= p.cooldown_until:
                        p._reset()
                        todo.append((p, "rearm", {}))

    def _flight_locked(self, ev: Dict[str, Any], now: float, todo: list,
                       armed: Dict[str, int]):
        kind = ev.get("event")
        for p in self._policies.values():
            if p.event != kind:
                continue
            if p.state == OK:
                ctx = {k: v for k, v in ev.items()
                       if k not in ("t", "seq", "event")}
                ctx.setdefault("rule", kind)
                ctx.setdefault("exemplar_trace_id", None)
                ctx["_from_event"] = True
                if p.sustain_s > 0:
                    p.state = PENDING
                    p.pending_since = now
                    p.pending_ctx = ctx
                else:
                    self._arm(p, ctx, now, todo, armed)
            elif p.state == COOLDOWN:
                p.suppressed_count += 1
                todo.append((p, "suppress", {"rule": kind}))

    def _timers_locked(self, now: float, todo: list,
                       armed: Dict[str, int]):
        for p in self._policies.values():
            if p.state == PENDING and p.pending_since is not None \
                    and now - p.pending_since >= p.sustain_s:
                # still firing: edges are reliable, so no resolved edge
                # since the firing one means the breach persists
                ctx = p.pending_ctx or {}
                p.pending_since = None
                p.pending_ctx = None
                self._arm(p, ctx, now, todo, armed)
            elif p.state == COOLDOWN and p.resolved_seen \
                    and p.cooldown_until is not None \
                    and now >= p.cooldown_until:
                p._reset()
                todo.append((p, "rearm", {}))

    # ------------------------------------------------- execution (unlocked)
    def _execute(self, p: ControlPolicy, kind: str, ctx: Dict[str, Any],
                 now: float):
        if kind == "rearm":
            _cooldown_gauge(p.name).set(0.0)
            return
        if kind == "suppress":
            _action_counter(p.name, p.action_name, "suppressed").inc()
            return
        if kind == "resolve":
            self._run_actuator(p, p.on_resolve, p.resolve_name, ctx, now)
            return
        _cooldown_gauge(p.name).set(1.0)
        self._run_actuator(p, p.action, p.action_name, ctx, now)

    def _run_actuator(self, p: ControlPolicy, fn, action_name: str,
                      ctx: Dict[str, Any], now: float):
        """Invoke one actuator with NO lock held, then record: flight
        event (rule + exemplar — the /events reconstruction contract),
        counter, and the plane's recent-actions ring."""
        try:
            outcome = fn(ctx) or "ok"
        except Exception as e:
            outcome = "error"
            log.exception("control policy %r actuator %s failed",
                          p.name, action_name)
            detail = f"{type(e).__name__}: {e}"
        else:
            detail = ctx.get("detail")
        from ..monitor.flightrec import get_flight_recorder
        row = {"t": now, "policy": p.name, "action": action_name,
               "outcome": str(outcome), "rule": ctx.get("rule"),
               "exemplar_trace_id": ctx.get("exemplar_trace_id"),
               "detail": detail}
        get_flight_recorder().record(
            "control_action", policy=p.name, action=action_name,
            outcome=str(outcome), rule=ctx.get("rule"),
            exemplar_trace_id=ctx.get("exemplar_trace_id"),
            detail=detail)
        _action_counter(p.name, action_name, str(outcome)).inc()
        with self._lock:
            still_installed = self._policies.get(p.name) is p
            if still_installed:
                p.last_action = row
                self._actions.append(row)
        if not still_installed:
            # removed mid-action: the actuator ran for a real edge (the
            # flight event stands), but the latch must not outlive the
            # policy — zero the gauge remove() may have raced with
            _cooldown_gauge(p.name).set(0.0)

    # -------------------------------------------------------------- reading
    def actions(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self._actions]

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /control`` payload (always HTTP 200, like
        ``/alerts`` — the control surface must stay readable exactly
        when the loop is busy)."""
        now = time.time()
        with self._lock:
            rows = [self._policies[n].to_dict(now)
                    for n in sorted(self._policies)]
            actions = [dict(a) for a in self._actions]
            last = self.last_tick
            running = self._thread is not None and self._thread.is_alive()
        return {"policies": rows,
                "cooldowns_active": [r["policy"] for r in rows
                                     if r["state"] == COOLDOWN],
                "actions": actions,
                "running": running,
                "evaluated_at": last}

    def block(self) -> Dict[str, Any]:
        """The compact ``control`` block for ``GET /profile``."""
        now = time.time()
        with self._lock:
            if not self._policies and not self._actions:
                return {}
            states = [p.state for p in self._policies.values()]
            fired = sum(p.fired_count for p in self._policies.values())
            last = self._actions[-1] if self._actions else None
            running = self._thread is not None and self._thread.is_alive()
        return {"policies": len(states), "running": running,
                "cooldowns_active": states.count(COOLDOWN),
                "pending": states.count(PENDING),
                "actions_total": fired,
                "last_action": dict(last) if last else None}


#: the process-global plane every surface reads (zero policies, not
#: started until a caller opts in)
_PLANE = ControlPlane()


def get_control_plane() -> ControlPlane:
    return _PLANE


def control_block() -> Dict[str, Any]:
    """Module-level hook ``profile_report`` reads via ``sys.modules``
    (the mesh-block pattern: an un-imported control plane costs /profile
    nothing)."""
    return _PLANE.block()
