"""Declarative alert rules over metric history.

Counterpart of ``deeplearning4j_tpu/monitor/alerts.py``, under its rule
names, series, flight events and document keys. Rules are evaluated over
:class:`~deeplearning4j_torch.monitor.history.MetricsHistory` windows and
run a three-state machine per rule::

    OK --breach--> PENDING --breach held for_seconds--> FIRING
    FIRING --breach clears--> OK (resolved)

- PENDING is the hold-down: the breach must persist for the rule's
  ``for_seconds`` before it fires.
- FIRING is edge-triggered: one ``alert_firing`` flight event, one health
  problem (``kind="alert"``, on ``/healthz``) and ``alerts_firing{rule=}``
  set to 1. Resolution mirrors it (``alert_resolved``, gauge back to 0).
- A firing latency alert carries an exemplar trace id, the worst recent
  sample's trace latched by the serving latency histogram
  (``LatencyHistogram.record(..., exemplar=)``, dropped after
  ``EXEMPLAR_TTL_S``), which ``GET /trace`` resolves.

Rule types: :class:`ThresholdRule` (current value, windowed rate, max or
quantile vs a threshold), :class:`BurnRateRule` (multi-window error-budget
burn for availability, windowed quantile for latency; ``per_label`` reads
the worst label value), :class:`HealthRule` (training stall, or
``health_problem`` flight events within ``within_s``) and
:class:`FleetStalenessRule` (stale workers on the fleet table).

``action``: ``"warn"`` records the problem, ``"halt"`` also requests the
graceful training stop (``HealthState.record_halt``), ``"raise"`` raises
:class:`AlertError` out of a strict ``evaluate``; the sampler and the HTTP
routes evaluate with ``strict=False``, which downgrades raise to warn.
Listeners and the flight, health and registry writes run outside the
engine lock. The rule packs (``default_*_rules``) install nothing by
themselves: the process engine starts with no rules.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .lockwatch import make_lock
from .history import MetricsHistory, get_history

log = logging.getLogger(__name__)

__all__ = ["AlertError", "AlertRule", "ThresholdRule", "BurnRateRule",
           "HealthRule", "FleetStalenessRule", "AlertEngine",
           "get_alert_engine", "default_serving_rules",
           "default_training_rules", "default_fleet_rules",
           "default_fleet_scope_rules", "default_probe_rules",
           "default_rules"]

OK, PENDING, FIRING = "OK", "PENDING", "FIRING"

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class AlertError(RuntimeError):
    """Raised by a strict ``AlertEngine.evaluate`` when a rule with
    ``action="raise"`` fires. ``rule`` names the offender."""

    def __init__(self, rule: str, message: str):
        super().__init__(message)
        self.rule = rule


class AlertRule:
    """One named rule: subclasses implement :meth:`check`; the engine owns
    the OK/PENDING/FIRING state machine, hold-down, and event fan-out."""

    ACTIONS = ("warn", "raise", "halt")

    def __init__(self, name: str, *, for_seconds: float = 0.0,
                 severity: str = "page", action: str = "warn",
                 description: str = ""):
        if action not in self.ACTIONS:
            raise ValueError(f"action must be one of {self.ACTIONS}, "
                             f"got {action!r}")
        self.name = str(name)
        self.for_seconds = float(for_seconds)
        self.severity = str(severity)
        self.action = action
        self.description = description
        # state machine (engine-owned, engine-lock-guarded)
        self.state = OK
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.fired_count = 0
        self.last_value: Optional[float] = None
        self.last_detail: str = ""
        self.last_exemplar: Optional[str] = None

    def check(self, history: MetricsHistory, now: float
              ) -> Tuple[bool, Optional[float], str, Optional[str]]:
        """(breached, observed value, human detail, exemplar trace id)."""
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.name,
            "state": self.state,
            "severity": self.severity,
            "action": self.action,
            "for_seconds": self.for_seconds,
            "description": self.description,
            "pending_since": self.pending_since,
            "firing_since": self.firing_since,
            "fired_count": self.fired_count,
            "value": self.last_value,
            "detail": self.last_detail,
            "exemplar_trace_id": self.last_exemplar,
        }


class ThresholdRule(AlertRule):
    """``mode``: ``"value"`` (newest sample), ``"rate"`` (counter
    increase/s over ``window_s``), ``"max"`` (gauge max over the window),
    or ``"quantile"`` (windowed histogram quantile ``q``, in the family's
    unit). A metric with no data does not breach — absence of traffic is
    not an incident for a threshold rule."""

    def __init__(self, name: str, metric: str, *, threshold: float,
                 op: str = ">", mode: str = "value", window_s: float = 60.0,
                 q: float = 0.99, labels: Optional[Dict[str, str]] = None,
                 agg: str = "sum",
                 exemplar_lookup: Optional[
                     Callable[[], Optional[str]]] = None,
                 detail_lookup: Optional[Callable[[], str]] = None,
                 **kw):
        super().__init__(name, **kw)
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
        if mode not in ("value", "rate", "max", "quantile"):
            raise ValueError(f"unknown mode {mode!r}")
        if agg not in ("sum", "max", "min"):
            raise ValueError(f"agg must be sum|max|min, got {agg!r}")
        self.metric = metric
        #: optional breach-time annotation seams (the probe rules use
        #: them: a deadman/mismatch breach should name the guilty target
        #: and carry a trace id resolvable on THAT replica's /trace) —
        #: ``exemplar_lookup() -> trace id``, ``detail_lookup() -> str``
        #: appended to the numeric detail; both failure-isolated
        self.exemplar_lookup = exemplar_lookup
        self.detail_lookup = detail_lookup
        self.threshold = float(threshold)
        self.op = op
        self.mode = mode
        self.window_s = float(window_s)
        self.q = float(q)
        self.labels = dict(labels) if labels else None
        #: child aggregation for value/max modes: "sum" across matching
        #: children, or "max" (worst single child — the right reading
        #: when the threshold is a PER-child cap, e.g. queue depth vs
        #: one model's admission cap)
        self.agg = agg

    def _observe(self, history: MetricsHistory, now: float
                 ) -> Optional[float]:
        if self.mode == "value":
            return history.current(self.metric, self.labels, agg=self.agg)
        if self.mode == "rate":
            # rate normalizes by the ACTUAL sample span, so it stays
            # honest on a young ring — no coverage guard needed
            return history.rate(self.metric, self.window_s, self.labels,
                                now=now)
        if not history.covers(self.window_s, now=now):
            # max/quantile over an uncovered window would silently
            # describe a shorter span — the same dishonesty the
            # burn-rate windows guard against
            return None
        if self.mode == "max":
            return history.max_over(self.metric, self.window_s, self.labels,
                                    now=now, agg=self.agg)
        return history.quantile_over(self.metric, self.q, self.window_s,
                                     self.labels, now=now)

    def check(self, history, now):
        v = self._observe(history, now)
        if v is None:
            return False, None, f"{self.metric}: no data", None
        breached = _OPS[self.op](v, self.threshold)
        what = {"value": self.metric,
                "rate": f"rate({self.metric})/s",
                "max": f"max_{self.window_s:g}s({self.metric})",
                "quantile": f"p{int(self.q * 100)}({self.metric})"}[self.mode]
        detail = f"{what} = {v:.6g} {self.op} {self.threshold:g}"
        exemplar = None
        if breached:
            if self.detail_lookup is not None:
                try:
                    extra = self.detail_lookup()
                    if extra:
                        detail += f" — {extra}"
                except Exception:
                    log.exception("detail lookup for rule %r failed",
                                  self.name)
            if self.exemplar_lookup is not None:
                try:
                    exemplar = self.exemplar_lookup()
                except Exception:
                    log.exception("exemplar lookup for rule %r failed",
                                  self.name)
        return breached, v, detail, exemplar


class BurnRateRule(AlertRule):
    """Multi-window SLO burn rate.

    ``kind="availability"``: availability = 1 − bad/total over a window
    (``bad_labels`` rows of ``total_metric`` — the serving default counts
    ``outcome`` in ``error``/``deadline``, the 5xx outcomes). Burn rate =
    (bad/total) / (1 − slo); breach when burn > ``burn_factor`` on BOTH
    windows. With the defaults (slo 0.999, factor 14.4, 60s/300s) a full
    outage fires in ~one minute while a 0.1% error trickle never does —
    exactly the SRE multiwindow table.

    ``kind="latency"``: windowed p-``q`` of ``latency_metric`` over
    ``target_ms`` on BOTH windows; the exemplar is the worst latched
    trace id of the latency histogram (requests route it via the serving
    batcher).

    ``per_label`` (latency kind): evaluate the windowed quantile
    SEPARATELY for each observed value of that label — "max over
    replicas" instead of "quantile of the merged fleet histogram", the
    fleet-scope reading where one slow replica must not be averaged
    away by N healthy ones. Breach when ANY value breaches on both
    windows; the detail names the guilty label value.

    ``exemplar_lookup``: ``fn(guilty_label_value_or_None) -> trace id``
    replaces the live-registry exemplar read — fleet-scope rules
    evaluate over a MERGED history whose exemplars live on the remote
    replicas; the fleet table stores what ``/telemetry`` shipped
    (``FleetState.worst_exemplar``)."""

    def __init__(self, name: str, *, kind: str = "availability",
                 slo: float = 0.999, burn_factor: float = 14.4,
                 windows: Sequence[float] = (60.0, 300.0),
                 total_metric: str = "serving_requests_total",
                 total_labels: Optional[Dict[str, str]] = None,
                 bad_labels: Optional[Sequence[Dict[str, str]]] = None,
                 latency_metric: str = "serving_request_latency_ms",
                 latency_labels: Optional[Dict[str, str]] = None,
                 target_ms: float = 250.0, q: float = 0.99,
                 min_requests: float = 1.0,
                 per_label: Optional[str] = None,
                 exemplar_lookup: Optional[
                     Callable[[Optional[str]], Optional[str]]] = None,
                 **kw):
        super().__init__(name, **kw)
        if kind not in ("availability", "latency"):
            raise ValueError(f"kind must be availability|latency, "
                             f"got {kind!r}")
        self.kind = kind
        self.slo = float(slo)
        self.burn_factor = float(burn_factor)
        self.windows = tuple(float(w) for w in windows)
        self.total_metric = total_metric
        self.total_labels = dict(total_labels) if total_labels else None
        self.bad_labels = ([dict(b) for b in bad_labels] if bad_labels
                           else [{"outcome": "error"},
                                 {"outcome": "deadline"}])
        self.latency_metric = latency_metric
        self.latency_labels = dict(latency_labels) if latency_labels \
            else None
        self.target_ms = float(target_ms)
        self.q = float(q)
        self.min_requests = float(min_requests)
        self.per_label = per_label
        self.exemplar_lookup = exemplar_lookup

    def _bad_delta(self, history, window, now) -> float:
        total = 0.0
        for bl in self.bad_labels:
            labels = dict(self.total_labels or {})
            labels.update(bl)
            d = history.delta(self.total_metric, window, labels, now=now)
            if d:
                total += d
        return total

    def _availability(self, history, now):
        budget = max(1.0 - self.slo, 1e-9)
        burns = []
        for w in self.windows:
            if not history.covers(w, now=now):
                # a ring younger than the window would make the long
                # window equal to the short one — the multiwindow
                # protection must not degenerate to a single window
                return False, None, (f"history does not cover the "
                                     f"{w:g}s window yet"), None
            total = history.delta(self.total_metric, w, self.total_labels,
                                  now=now)
            if total is None or total < self.min_requests:
                return False, None, (f"error budget: <{self.min_requests:g} "
                                     f"requests in {w:g}s window"), None
            ratio = self._bad_delta(history, w, now) / max(total, 1.0)
            burns.append(ratio / budget)
        breached = all(b > self.burn_factor for b in burns)
        detail = (f"error-budget burn "
                  + "/".join(f"{b:.1f}x@{w:g}s"
                             for b, w in zip(burns, self.windows))
                  + f" vs {self.burn_factor:g}x (slo {self.slo})")
        return breached, max(burns), detail, None

    def _exemplar(self, guilty: Optional[str]) -> Optional[str]:
        if self.exemplar_lookup is not None:
            try:
                return self.exemplar_lookup(guilty)
            except Exception:
                log.exception("exemplar lookup for rule %r failed",
                              self.name)
                return None
        return self._worst_trace()

    def _per_label_values(self, history) -> List[str]:
        """Observed values of ``per_label`` in the NEWEST sample's
        latency family (restricted to ``latency_labels``) — the replica
        roster the per-replica quantiles iterate."""
        samples = history.samples()
        if not samples:
            return []
        from .history import _match
        fam = samples[-1][1].get(self.latency_metric) or {}
        values = set()
        for row in fam.get("children", []):
            labels = row.get("labels", {})
            if not _match(labels, self.latency_labels):
                continue
            v = labels.get(self.per_label)
            if v is not None:
                values.add(v)
        return sorted(values)

    def _latency(self, history, now):
        for w in self.windows:
            if not history.covers(w, now=now):
                return False, None, (f"history does not cover the "
                                     f"{w:g}s window yet"), None
        if self.per_label is None:
            ps = []
            for w in self.windows:
                p = history.quantile_over(self.latency_metric, self.q, w,
                                          self.latency_labels, now=now)
                if p is None:
                    return False, None, (f"p{int(self.q * 100)}: no "
                                         f"samples in {w:g}s window"), None
                ps.append(p)
            breached = all(p > self.target_ms for p in ps)
            exemplar = self._exemplar(None) if breached else None
            detail = (f"p{int(self.q * 100)} "
                      + "/".join(f"{p:.1f}ms@{w:g}s"
                                 for p, w in zip(ps, self.windows))
                      + f" vs target {self.target_ms:g}ms")
            return breached, max(ps), detail, exemplar
        # per-label (fleet-scope): the quantile is computed per value of
        # per_label and the rule reads the WORST one — a merged-histogram
        # quantile would let N fast replicas dilute one slow replica
        # below the target (the exact failure mode a router cares about)
        worst = None          # (peak_p, value_breached, label, ps)
        for v in self._per_label_values(history):
            labels = {**(self.latency_labels or {}), self.per_label: v}
            ps = []
            for w in self.windows:
                p = history.quantile_over(self.latency_metric, self.q, w,
                                          labels, now=now)
                if p is None:
                    ps = None       # idle on this window: not a breach,
                    break           # not a candidate for "worst" either
                ps.append(p)
            if ps is None:
                continue
            breached = all(p > self.target_ms for p in ps)
            peak = max(ps)
            # breaching values outrank non-breaching ones — the guilty
            # replica named in the detail must actually be a breacher
            rank = (breached, peak)
            if worst is None or rank > (worst[1], worst[0]):
                worst = (peak, breached, v, ps)
        if worst is None:
            return False, None, (f"p{int(self.q * 100)}: no "
                                 f"{self.per_label} series with samples "
                                 f"in window"), None
        peak, breached, guilty, ps = worst
        exemplar = self._exemplar(guilty) if breached else None
        detail = (f"worst {self.per_label}={guilty} p{int(self.q * 100)} "
                  + "/".join(f"{p:.1f}ms@{w:g}s"
                             for p, w in zip(ps, self.windows))
                  + f" vs target {self.target_ms:g}ms")
        return breached, peak, detail, exemplar

    def _worst_trace(self) -> Optional[str]:
        """Worst latched exemplar across the latency histogram's matching
        children — read from the LIVE registry (exemplars are local, not
        part of the history dumps)."""
        from .registry import get_registry
        reg = get_registry()
        dump = reg.dump().get(self.latency_metric)
        if not dump:
            return None
        from .history import _match
        worst = None
        for row in dump.get("children", []):
            labels = row.get("labels", {})
            if not _match(labels, self.latency_labels):
                continue
            child = reg.histogram(self.latency_metric, **labels)
            ex = child.worst_exemplar()
            if ex and (worst is None or ex["value"] > worst["value"]):
                worst = ex
        return worst["exemplar"] if worst else None

    def check(self, history, now):
        return (self._availability(history, now) if self.kind ==
                "availability" else self._latency(history, now))


class HealthRule(AlertRule):
    """Training health as a stateful alert. ``kind="stall"`` breaches when
    iterations have happened but the last one is older than
    ``stall_after_s``; ``kind="problem"`` breaches while a
    ``health_problem`` flight-recorder event whose kind matches
    ``problem_kinds`` (divergence / nan / retrace — the watchdog already
    classified it) was recorded within the trailing ``within_s``. Flight
    events carry timestamps, so the alert RESOLVES once the problems age
    out — the health snapshot's 8-slot problem ring is append-only for
    the process lifetime (and shared with every other problem source), so
    reading it directly would either never resolve or resolve spuriously
    on eviction."""

    def __init__(self, name: str, *, kind: str = "stall",
                 stall_after_s: float = 120.0,
                 problem_kinds: Sequence[str] = ("nan", "divergence"),
                 within_s: float = 300.0, **kw):
        super().__init__(name, **kw)
        if kind not in ("stall", "problem"):
            raise ValueError(f"kind must be stall|problem, got {kind!r}")
        self.kind = kind
        self.stall_after_s = float(stall_after_s)
        self.problem_kinds = tuple(problem_kinds)
        self.within_s = float(within_s)

    def check(self, history, now):
        if self.kind == "stall":
            from .health import get_health
            snap = get_health().snapshot()
            age = snap.get("last_iteration_age_s")
            if age is None:
                return False, None, "no training iterations yet", None
            return (age > self.stall_after_s, age,
                    f"last iteration {age:.1f}s ago "
                    f"(stall_after={self.stall_after_s:g}s)", None)
        from .flightrec import get_flight_recorder
        hits = [e for e in get_flight_recorder().events()
                if e.get("event") == "health_problem"
                and e.get("kind") in self.problem_kinds
                and now - e.get("t", 0.0) <= self.within_s]
        return (bool(hits), float(len(hits)),
                (f"{hits[-1].get('kind')}: {hits[-1].get('message')}"
                 if hits else
                 f"no {'/'.join(self.problem_kinds)} problems in the "
                 f"last {self.within_s:g}s"), None)


class FleetStalenessRule(AlertRule):
    """Workers stale on the fleet table (no OP_TELEMETRY report within the
    fleet's staleness horizon) — only meaningful on the process where
    reports land (the paramserver server)."""

    def __init__(self, name: str, *, min_stale: int = 1, **kw):
        super().__init__(name, **kw)
        self.min_stale = int(min_stale)

    def check(self, history, now):
        from .fleet import get_fleet
        live = get_fleet().liveness()
        stale = live.get("stale", [])
        if not live.get("workers"):
            return False, None, "no fleet workers reporting", None
        return (len(stale) >= self.min_stale, float(len(stale)),
                f"stale workers: {sorted(stale)}" if stale
                else "all workers fresh", None)


class AlertEngine:
    """Holds rules, drives their state machines, fans out events.

    One engine per process (:func:`get_alert_engine`), sharing the global
    :class:`MetricsHistory`. ``attach()`` registers the engine on the
    history sampler so every tick evaluates; the ``/alerts`` endpoints
    additionally evaluate at request time so a snapshot is never staler
    than the scrape that asked for it."""

    def __init__(self, history: Optional[MetricsHistory] = None):
        self._lock = make_lock("AlertEngine._lock")
        # serializes whole evaluation passes INCLUDING their event
        # fan-out, and remove()/clear()'s closing edges: without it a
        # sampler-tick evaluate and a request-time /alerts evaluate (or a
        # concurrent remove) could emit alert_resolved before the queued
        # alert_firing, stranding the gauge at 1 with no owner. Ordered
        # strictly before _lock; never held while a rule fires an
        # exception into the caller (release happens in the finally).
        self._eval_lock = make_lock("AlertEngine._eval_lock")
        self._history = history
        self._rules: Dict[str, AlertRule] = {}
        self._listeners: List[Callable[[str, Dict[str, Any]], None]] = []
        self._attached = False
        self.last_evaluated: Optional[float] = None

    @property
    def history(self) -> MetricsHistory:
        return self._history if self._history is not None else get_history()

    # ------------------------------------------------------------- rules
    def add(self, *rules: AlertRule) -> "AlertEngine":
        with self._lock:
            for r in rules:
                if r.name in self._rules:
                    raise ValueError(f"alert rule {r.name!r} already "
                                     f"registered")
                self._rules[r.name] = r
        return self

    def _resolve_dangling(self, name: str):
        """A FIRING rule leaving the engine (remove/clear) must not leave
        an unmatched ``alert_firing`` edge: zero the gauge, record the
        closing ``alert_resolved``, AND deliver the same edge to every
        subscribed listener — a controller tracking the incident must see
        it close, not keep a cooldown latched for a rule that no longer
        exists. Runs under ``_eval_lock`` (the remove/clear callers hold
        it), so no listener can observe a firing edge for the deleted
        rule after this returns."""
        AlertEngine._gauge(name).set(0.0)
        from .flightrec import get_flight_recorder
        get_flight_recorder().record("alert_resolved", rule=name,
                                     detail="rule removed from engine")
        self._notify("alert_resolved", {
            "rule": name, "severity": None, "value": None,
            "detail": "rule removed from engine",
            "exemplar_trace_id": None})

    def remove(self, name: str):
        with self._eval_lock:      # never interleave with an in-flight
            with self._lock:       # evaluation's transition fan-out
                rule = self._rules.pop(name, None)
                was_firing = rule is not None and rule.state == FIRING
            if was_firing:
                self._resolve_dangling(name)

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return [self._rules[n] for n in sorted(self._rules)]

    def clear(self):
        with self._eval_lock:
            with self._lock:
                rules, self._rules = list(self._rules.values()), {}
                firing = [r.name for r in rules if r.state == FIRING]
            for name in firing:
                self._resolve_dangling(name)

    def attach(self) -> "AlertEngine":
        """Evaluate on every history sampler tick (idempotent)."""
        with self._lock:
            if self._attached:
                return self
            self._attached = True
        self.history.add_listener(lambda _h: self.evaluate(strict=False))
        return self

    # ---------------------------------------------------------- listeners
    def subscribe(self, fn: Callable[[str, Dict[str, Any]], None]
                  ) -> "AlertEngine":
        """Register ``fn(event, payload)`` for every firing/resolved edge.

        ``event`` is ``"alert_firing"`` or ``"alert_resolved"``; the
        payload mirrors the flight-recorder record (``rule``,
        ``severity``, ``value``, ``detail``, ``exemplar_trace_id``).
        Delivery runs outside ``_lock`` but inside ``_eval_lock``, so a
        listener sees edges in the exact order the state machine emitted
        them — and, crucially for controllers, ``remove()``/``clear()``
        deliver the closing resolved edge under the same lock, so no
        firing callback for a deleted rule can trail the removal. This
        replaces controllers polling :meth:`snapshot` (which sees levels,
        not edges, and so cannot distinguish one long incident from N).
        Listener errors are logged, never fatal. Idempotent per ``fn``."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)
        return self

    def unsubscribe(self, fn: Callable[[str, Dict[str, Any]], None]):
        """Remove a subscribed listener (no-op when absent). An edge
        fan-out already in flight may still deliver to ``fn`` once —
        callers that need a hard cut synchronize on their own state, as
        the JAX package's ``ControlPlane`` does."""
        with self._lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def _notify(self, event: str, payload: Dict[str, Any]):
        """Listener fan-out OUTSIDE ``_lock`` (listeners run arbitrary
        actuator code and take their own locks — THR004 discipline)."""
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(event, dict(payload))
            except Exception:
                log.exception("alert listener %r failed on %s(%s)",
                              fn, event, payload.get("rule"))

    # --------------------------------------------------------- evaluation
    @staticmethod
    def _gauge(name: str):
        from .registry import get_registry
        return get_registry().gauge(
            "alerts_firing", "alert rules currently FIRING (1) by rule",
            rule=name)

    def evaluate(self, now: Optional[float] = None,
                 strict: bool = True) -> List[Dict[str, Any]]:
        """One evaluation pass over every rule; returns the snapshot rows.
        ``strict=False`` (sampler/endpoints) downgrades ``action="raise"``
        to a warning — background evaluation must never throw."""
        now = float(now) if now is not None else time.time()
        history = self.history
        with self._eval_lock:
            return self._evaluate_locked(now, history, strict)

    def _evaluate_locked(self, now: float, history: MetricsHistory,
                         strict: bool) -> List[Dict[str, Any]]:
        transitions: List[Tuple[AlertRule, str]] = []
        with self._lock:
            rules = list(self._rules.values())
            self.last_evaluated = now
        raise_after: Optional[AlertError] = None
        for rule in rules:
            try:
                breached, value, detail, exemplar = rule.check(history, now)
            except Exception:
                log.exception("alert rule %r check failed", rule.name)
                continue
            with self._lock:
                if self._rules.get(rule.name) is not rule:
                    # removed (or replaced) while its check ran: firing
                    # now would strand the gauge/health problem with no
                    # registered owner to ever resolve them
                    continue
                rule.last_value = value
                rule.last_detail = detail
                if exemplar is not None:
                    rule.last_exemplar = exemplar
                if breached:
                    if rule.state == OK:
                        rule.state = PENDING
                        rule.pending_since = now
                    if (rule.state == PENDING
                            and now - rule.pending_since
                            >= rule.for_seconds):
                        rule.state = FIRING
                        rule.firing_since = now
                        rule.fired_count += 1
                        transitions.append((rule, "alert_firing"))
                else:
                    if rule.state == FIRING:
                        transitions.append((rule, "alert_resolved"))
                    if rule.state != OK:
                        rule.state = OK
                        rule.pending_since = None
                        rule.firing_since = None
                        # the exemplar belongs to THIS incident: a later
                        # firing with no fresh exemplar must not surface
                        # a trace id from hours ago that no longer
                        # resolves (EXEMPLAR_TTL_S's point, end to end)
                        rule.last_exemplar = None
        for rule, event in transitions:
            err = self._fire(rule, event)
            if err is not None and raise_after is None:
                raise_after = err
        if strict and raise_after is not None:
            raise raise_after
        return self.snapshot()["alerts"]

    def _fire(self, rule: AlertRule, event: str) -> Optional[AlertError]:
        """Event fan-out OUTSIDE the engine lock (flight recorder, health
        and registry each take their own locks — holding ours across them
        would hand THR004 a real finding)."""
        from .flightrec import get_flight_recorder
        firing = event == "alert_firing"
        self._gauge(rule.name).set(1.0 if firing else 0.0)
        get_flight_recorder().record(
            event, rule=rule.name, severity=rule.severity,
            value=rule.last_value, detail=rule.last_detail,
            exemplar_trace_id=rule.last_exemplar if firing else None)
        self._notify(event, {
            "rule": rule.name, "severity": rule.severity,
            "value": rule.last_value, "detail": rule.last_detail,
            "exemplar_trace_id": rule.last_exemplar if firing else None})
        if not firing:
            log.info("alert resolved: %s (%s)", rule.name, rule.last_detail)
            return None
        msg = (f"alert {rule.name} FIRING: {rule.last_detail}"
               + (f" — exemplar trace {rule.last_exemplar}"
                  if rule.last_exemplar else ""))
        log.warning("%s", msg)
        from .health import get_health
        get_health().record_problem("alert", msg)
        if rule.action == "halt":
            get_health().record_halt(msg)
        elif rule.action == "raise":
            return AlertError(rule.name, msg)
        return None

    # ------------------------------------------------------------ reading
    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, r in self._rules.items()
                          if r.state == FIRING)

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /alerts`` payload (always HTTP 200 — an alerting
        endpoint that 503s while alerting would blind the prober exactly
        when it matters)."""
        with self._lock:
            rows = [self._rules[n].to_dict() for n in sorted(self._rules)]
            evaluated = self.last_evaluated
        return {"alerts": rows,
                "firing": [r["rule"] for r in rows
                           if r["state"] == FIRING],
                "pending": [r["rule"] for r in rows
                            if r["state"] == PENDING],
                "evaluated_at": evaluated}


# ------------------------------------------------------- default rule packs
#: default hold-down for the shipped rule packs: a breach must persist
#: this long before paging, so one transient sample (a queue blip, a
#: single slow scrape) never fires — the state-machine invariant the
#: module docstring promises. Pass for_seconds=0.0 for instant-fire
#: (tests, demos).
DEFAULT_FOR_SECONDS = 30.0


def default_serving_rules(model: Optional[str] = None, *,
                          slo: float = 0.999, burn_factor: float = 14.4,
                          windows: Sequence[float] = (60.0, 300.0),
                          p99_target_ms: float = 250.0,
                          queue_cap: int = 256,
                          queue_frac: float = 0.8,
                          reject_rate_per_s: float = 1.0,
                          for_seconds: float = DEFAULT_FOR_SECONDS
                          ) -> List[AlertRule]:
    """The serving pack: error-budget burn, p99 breach, queue saturation,
    reject rate. ``model=None`` aggregates across hosted models."""
    labels = {"model": model} if model else None
    suffix = f"/{model}" if model else ""
    return [
        BurnRateRule(f"serving_error_burn{suffix}", kind="availability",
                     slo=slo, burn_factor=burn_factor, windows=windows,
                     total_labels=labels, for_seconds=for_seconds,
                     description="5xx error-budget burn on both windows"),
        BurnRateRule(f"serving_p99_breach{suffix}", kind="latency",
                     target_ms=p99_target_ms, windows=windows,
                     latency_labels=labels, for_seconds=for_seconds,
                     description="windowed p99 over target on both windows"),
        ThresholdRule(f"serving_queue_saturation{suffix}",
                      "serving_queue_examples", labels=labels,
                      threshold=queue_frac * queue_cap, op=">=",
                      mode="value", agg="max", for_seconds=for_seconds,
                      severity="ticket",
                      description="a batcher queue near its admission cap "
                                  "(queued EXAMPLES vs max_queue_examples "
                                  "— same unit as admission; worst single "
                                  "model, the cap is per-model)"),
        ThresholdRule(f"serving_reject_rate{suffix}",
                      "serving_requests_total",
                      labels={**(labels or {}), "outcome": "rejected"},
                      threshold=reject_rate_per_s, op=">", mode="rate",
                      window_s=windows[0], for_seconds=for_seconds,
                      severity="ticket",
                      description="sustained admission rejects (429s)"),
    ]


def default_training_rules(stall_after_s: float = 120.0,
                           for_seconds: float = DEFAULT_FOR_SECONDS
                           ) -> List[AlertRule]:
    return [
        HealthRule("training_stall", kind="stall",
                   stall_after_s=stall_after_s, for_seconds=for_seconds,
                   description="training iterations stopped arriving"),
        HealthRule("training_divergence", kind="problem",
                   problem_kinds=("nan", "divergence"),
                   for_seconds=for_seconds,
                   description="watchdog NaN/divergence problems present"),
    ]


def default_fleet_rules(for_seconds: float = DEFAULT_FOR_SECONDS
                        ) -> List[AlertRule]:
    return [
        FleetStalenessRule("fleet_worker_stale", for_seconds=for_seconds,
                           severity="ticket",
                           description="worker missed its telemetry "
                                       "interval on /fleet"),
    ]


def default_fleet_scope_rules(*, fleet=None, slo: float = 0.999,
                              burn_factor: float = 14.4,
                              windows: Sequence[float] = (60.0, 300.0),
                              p99_target_ms: float = 250.0,
                              per_label: str = "worker",
                              for_seconds: float = DEFAULT_FOR_SECONDS
                              ) -> List[AlertRule]:
    """The scrape-plane pack, evaluated against a history ring fed by
    :meth:`TelemetryCollector.fleet_dump` (where every series carries a
    ``worker=<label>`` re-label):

    - ``fleet_error_burn`` — error-budget burn on the SUM across
      replicas (one replica's 5xx storm burns the shared budget);
    - ``fleet_p99_worst_replica`` — windowed p99 per replica, rule
      reads the worst one (``per_label``), exemplar resolved from the
      guilty replica's scraped exemplar table;
    - ``fleet_target_down`` — any configured scrape target failing
      (min over ``fleet_target_up`` gauges below 1).
    """
    if fleet is None:
        from .fleet import get_fleet
        fleet = get_fleet()
    return [
        BurnRateRule("fleet_error_burn", kind="availability",
                     slo=slo, burn_factor=burn_factor, windows=windows,
                     for_seconds=for_seconds,
                     description="aggregate 5xx error-budget burn "
                                 "across scraped replicas"),
        BurnRateRule("fleet_p99_worst_replica", kind="latency",
                     target_ms=p99_target_ms, windows=windows,
                     per_label=per_label, for_seconds=for_seconds,
                     exemplar_lookup=lambda w: fleet.worst_exemplar(
                         "serving_request_latency_ms", w),
                     description="worst single replica's windowed p99 "
                                 "over target on both windows"),
        ThresholdRule("fleet_target_down", "fleet_target_up",
                      threshold=1.0, op="<", mode="value", agg="min",
                      for_seconds=for_seconds, severity="page",
                      description="a configured scrape target is not "
                                  "answering /telemetry"),
    ]


def default_probe_rules(prober=None, *, slo: float = 0.999,
                        burn_factor: float = 14.4,
                        windows: Sequence[float] = (60.0, 300.0),
                        p99_target_ms: float = 500.0,
                        deadman_s: float = 60.0,
                        for_seconds: float = DEFAULT_FOR_SECONDS
                        ) -> List[AlertRule]:
    """The probe-plane pack (attach to ``prober.engine``, which samples
    the registry where the probe SLIs land):

    - ``probe_availability_burn`` — error-budget burn over
      ``probe_requests_total`` where EVERY non-ok outcome is bad: a
      wrong answer (mismatch) burns the budget exactly like a 5xx;
    - ``probe_p99_client`` — client-observed windowed p99 per target
      (the latency the FRONT DOOR sees, network included), worst target
      read via ``per_label``;
    - ``probe_mismatch`` — ANY mismatch in the short window pages
      immediately: correctness has no error budget;
    - ``probe_deadman`` — ``probe_last_success_age_s`` over
      ``deadman_s``: only a CORRECT answer resets it, so a replica
      answering quickly but wrongly still trips it.

    ``prober`` (optional) wires breach-time annotations: mismatch and
    deadman breaches name the guilty target and carry the failing
    probe's own trace id — resolvable on that replica's ``/trace``."""
    ex = prober.last_failure_trace if prober is not None else None
    why = prober.failure_detail if prober is not None else None
    return [
        BurnRateRule("probe_availability_burn", kind="availability",
                     slo=slo, burn_factor=burn_factor, windows=windows,
                     total_metric="probe_requests_total",
                     bad_labels=[{"outcome": "error"},
                                 {"outcome": "timeout"},
                                 {"outcome": "mismatch"}],
                     for_seconds=for_seconds,
                     description="synthetic-probe error-budget burn "
                                 "(any non-ok outcome is bad)"),
        BurnRateRule("probe_p99_client", kind="latency",
                     latency_metric="probe_latency_ms",
                     target_ms=p99_target_ms, windows=windows,
                     per_label="target", for_seconds=for_seconds,
                     description="worst target's client-observed probe "
                                 "p99 over target on both windows"),
        ThresholdRule("probe_mismatch", "probe_requests_total",
                      threshold=0.0, op=">", mode="rate",
                      window_s=windows[0],
                      labels={"outcome": "mismatch"},
                      for_seconds=for_seconds, severity="page",
                      exemplar_lookup=ex, detail_lookup=why,
                      description="a probed replica returned an answer "
                                  "diverging from its golden set"),
        ThresholdRule("probe_deadman", "probe_last_success_age_s",
                      threshold=deadman_s, op=">", mode="value",
                      agg="max", for_seconds=for_seconds, severity="page",
                      exemplar_lookup=ex, detail_lookup=why,
                      description="a probe target has not answered "
                                  "correctly within the deadman window"),
    ]


def default_rules(*, stall_after_s: float = 120.0,
                  for_seconds: float = DEFAULT_FOR_SECONDS,
                  **serving_kw) -> List[AlertRule]:
    """Every shipped pack (serving aggregated across models + training +
    fleet) — the one-call setup for a monitored process. ``for_seconds``
    and ``stall_after_s`` apply across packs; the remaining keywords go
    to :func:`default_serving_rules`."""
    return (default_serving_rules(for_seconds=for_seconds, **serving_kw)
            + default_training_rules(stall_after_s=stall_after_s,
                                     for_seconds=for_seconds)
            + default_fleet_rules(for_seconds=for_seconds))


#: the process-global engine the endpoints/CLI serve — empty (no rules,
#: nothing evaluating) until someone adds rules and attaches/evaluates
_ENGINE = AlertEngine()


def get_alert_engine() -> AlertEngine:
    return _ENGINE
