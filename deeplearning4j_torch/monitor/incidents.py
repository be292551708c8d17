"""The incident plane: evidence captured at the alert's fire edge.

Counterpart of ``deeplearning4j_tpu/monitor/incidents.py``, under its
series, flight events, document keys, environment variable and bundle
format (``dl4jinc/1``), so a ``.dl4jinc`` bundle that one package writes
loads and renders in the other.

:class:`IncidentRecorder` subscribes to an :class:`~deeplearning4j_torch.
monitor.alerts.AlertEngine`'s edges. At a *fire* edge, before any ring
evicts, it copies into an :class:`Incident`:

- the metric-history window ``[first PENDING - lookback, fire]``, so the
  breach's onset is in the bundle, not only its crossing;
- the exemplar trace's spans, copied out of the tracer ring, so neither
  the ring's wraparound nor the exemplar latch's TTL can hollow out an
  open incident;
- the flight events back to the window's start, and at close every event
  recorded while the incident was open (each ``control_action`` taken
  under it among them);
- the firing rule's alert state and every co-firing rule's: overlapping
  firing windows merge into one incident;
- the jit table, the lock census, and the prober's and the collector's
  snapshots when those planes exist (read through ``sys.modules``: a plane
  nobody made is never made here).

When every member rule has resolved, the incident closes; with
``dump_dir=`` or ``DL4J_TPU_INCIDENT_DIR`` it persists as the
content-addressed JSON bundle ``<id>-<digest16>.dl4jinc``
(:func:`load_bundle`, :func:`render_incident_text`). A halt
(``HealthState.record_halt``) flushes an open incident the same way with
``status="aborted"``.

Threading: the subscription callback only appends to a lock-free deque
(it runs under ``AlertEngine._eval_lock``); ``tick(now=)``, the
deterministic seam the ``start(interval_s)``/``stop()`` daemon drives,
drains it and captures with no lock held; only the incident table's
bookkeeping takes ``IncidentRecorder._lock``, a leaf. Nothing is made or
started by default.

Series: ``incidents_open``, ``incident_captures_total{outcome}``
(``captured``, ``merged``, ``error``), ``incident_capture_ms``. Routes:
``GET /incidents`` and ``GET /incidents/<id>`` on every server of the port
(``ui/server.py``).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .lockwatch import make_lock

log = logging.getLogger(__name__)

__all__ = ["Incident", "IncidentRecorder", "get_incident_recorder",
           "abort_open_incidents", "load_bundle", "render_incident_text"]

#: default daemon cadence; tests bypass it entirely via tick()
DEFAULT_INTERVAL_S = 0.5

#: history runway captured BEFORE the first rule's PENDING edge — the
#: onset of the breach, not just its threshold crossing
DEFAULT_LOOKBACK_S = 120.0

#: bounded incident table (oldest CLOSED incidents evicted first)
DEFAULT_MAX_INCIDENTS = 32

#: bundle format tag (bumped on incompatible schema changes)
BUNDLE_FORMAT = "dl4jinc/1"

#: flight-event kinds the rendered timeline shows (the rest
#: are counted, not printed — a 4096-event window would drown the story)
_TIMELINE_EVENTS = ("alert_firing", "alert_resolved", "control_action",
                    "probe_target_failing", "probe_target_recovered",
                    "incident_open", "incident_closed", "halt",
                    "shard_server_down", "health_problem")


def _open_gauge():
    from .registry import get_registry
    return get_registry().gauge(
        "incidents_open",
        "incidents currently open on the incident recorder (co-firing "
        "rules merge, so this is almost always 0 or 1)")


def _capture_counter(outcome: str):
    from .registry import get_registry
    return get_registry().counter(
        "incident_captures_total",
        "fire-edge evidence captures by outcome (captured = opened a "
        "new incident, merged = joined the open one)", outcome=outcome)


def _capture_hist():
    from .registry import get_registry
    return get_registry().histogram(
        "incident_capture_ms",
        "wall time of one fire-edge evidence capture (history window + "
        "exemplar pin + context blocks), off the serving path")


class Incident:
    """One merged incident: every co-firing rule's evidence under one id.

    Mutated ONLY under the owning recorder's ``_lock`` (the capture
    payloads attached here are built lock-free beforehand); ``bundle``
    is set once at close and immutable afterwards."""

    def __init__(self, incident_id: str, opened_t: float):
        self.id = incident_id
        self.status = "open"              # open | resolved | aborted
        self.opened_t = opened_t
        self.closed_t: Optional[float] = None
        #: rule name → {fired_t, resolved_t, alert, exemplar_trace_id,
        #: exemplar_spans, resolve_detail}
        self.rules: Dict[str, Dict[str, Any]] = {}
        self.window_start: Optional[float] = None
        self.history: List[Tuple[float, dict]] = []
        self.flight_events: List[Dict[str, Any]] = []
        self.open_last_seq = 0            # tail events appended at close
        self.context: Dict[str, Any] = {} # jit table, lock census, ...
        self.captures: List[Dict[str, Any]] = []
        self.bundle: Optional[Dict[str, Any]] = None
        self.path: Optional[str] = None
        self.bundle_bytes: Optional[int] = None

    def row(self) -> Dict[str, Any]:
        """One ``GET /incidents`` summary row."""
        return {"id": self.id, "status": self.status,
                "opened_t": self.opened_t, "closed_t": self.closed_t,
                "rules": sorted(self.rules),
                "captures": len(self.captures),
                "history_samples": len(self.history),
                "flight_events": len(self.flight_events),
                "path": self.path, "bundle_bytes": self.bundle_bytes}


class IncidentRecorder:
    """Subscribes to alert edges, captures at fire, persists at resolve.

    One recorder per process (:func:`get_incident_recorder`); nothing is
    constructed or started implicitly. ``start()`` subscribes to the
    engine's edge stream and runs the tick daemon; ``tick(now=)`` is the
    deterministic seam tests drive instead of sleeping."""

    def __init__(self, engine=None, history=None, *,
                 max_incidents: int = DEFAULT_MAX_INCIDENTS,
                 lookback_s: float = DEFAULT_LOOKBACK_S,
                 dump_dir: Optional[str] = None):
        self._lock = make_lock("IncidentRecorder._lock")
        self._engine = engine
        self._history = history
        self.max_incidents = int(max_incidents)
        self.lookback_s = float(lookback_s)
        self.dump_dir = dump_dir
        # lock-free handoff from the alert-engine fan-out thread: the
        # subscription callback must not take ANY lock (it runs under
        # AlertEngine._eval_lock — a capture there would graft the
        # tracer/history/registry lock trees onto the evaluation lock)
        self._edges: deque = deque(maxlen=1024)
        self._incidents: Dict[str, Incident] = {}   # insertion = age order
        self._open_id: Optional[str] = None
        self._seq = 0
        self.evicted = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.interval_s = DEFAULT_INTERVAL_S
        self.last_tick: Optional[float] = None

    @property
    def engine(self):
        if self._engine is not None:
            return self._engine
        from .alerts import get_alert_engine
        return get_alert_engine()

    @property
    def history(self):
        if self._history is not None:
            return self._history
        return self.engine.history

    # ----------------------------------------------------------- lifecycle
    def _on_edge(self, event: str, payload: Dict[str, Any]):
        """AlertEngine subscription callback — enqueue only, never
        capture: this runs on the evaluation thread under ``_eval_lock``."""
        self._edges.append((event, payload))

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def start(self, interval_s: Optional[float] = None
              ) -> "IncidentRecorder":
        """Subscribe + start the tick daemon (idempotent)."""
        if interval_s is not None:
            self.interval_s = float(interval_s)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="incident-recorder", daemon=True)
            thread = self._thread
        # outside our lock: the engine takes its own
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
                log.exception("incident-recorder tick failed")

    def clear(self):
        """Full reset: incidents, queued edges. The open gauge zeroes —
        a cleared recorder must surface as empty, not replay history."""
        with self._lock:
            self._incidents = {}
            self._open_id = None
            self._edges.clear()
            self.evicted = 0
        _open_gauge().set(0.0)

    # ---------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> int:
        """One pass: drain queued alert edges, capture fires, close on
        the final resolve. Returns the number of edges that changed
        incident state this pass."""
        now = float(now) if now is not None else time.time()
        drained: List[Tuple[str, Dict[str, Any]]] = []
        while True:
            try:
                drained.append(self._edges.popleft())
            except IndexError:
                break
        changed = 0
        for event, payload in drained:
            if event == "alert_firing":
                self._capture_fire(payload, now)
                changed += 1
            elif event == "alert_resolved":
                if self._resolve(payload, now):
                    changed += 1
        with self._lock:
            self.last_tick = now
        return changed

    # ----------------------------------------------------- capture (fire)
    def _capture_fire(self, payload: Dict[str, Any], now: float):
        """Snapshot the diagnostic state for one firing edge — all the
        expensive reads run with NO lock held (each source takes its
        own; ours stays a leaf), then the bookkeeping enters the lock."""
        rule = payload.get("rule")
        t0 = time.perf_counter()
        outcome = "captured"
        try:
            evidence = self._snapshot_evidence(payload, now)
        except Exception:
            log.exception("incident capture for rule %r failed", rule)
            evidence = None
            outcome = "error"
        capture_ms = (time.perf_counter() - t0) * 1000.0
        opened = None
        with self._lock:
            inc = (self._incidents.get(self._open_id)
                   if self._open_id else None)
            if inc is None:
                self._seq += 1
                inc = Incident(f"inc-{self._seq:04d}", now)
                self._incidents[inc.id] = inc
                self._open_id = inc.id
                opened = inc.id
                if evidence is not None:
                    inc.window_start = evidence["window_start"]
                    inc.history = evidence["history"]
                    inc.flight_events = evidence["flight_events"]
                    inc.open_last_seq = evidence["last_seq"]
                    inc.context = evidence["context"]
            elif outcome == "captured":
                # overlapping firing windows merge: the chaos drill's
                # p99 + burn + shard-down edges are ONE incident
                outcome = "merged"
            if evidence is not None:
                entry = inc.rules.get(rule)
                if entry is None:
                    entry = {}
                    inc.rules[rule] = entry
                entry.update({
                    "fired_t": now, "resolved_t": None,
                    "severity": payload.get("severity"),
                    "value": payload.get("value"),
                    "detail": payload.get("detail"),
                    "exemplar_trace_id": payload.get("exemplar_trace_id"),
                    "exemplar_spans": evidence["exemplar_spans"],
                    "alert": evidence["alert"],
                })
            inc.captures.append({"rule": rule, "t": now,
                                 "capture_ms": capture_ms,
                                 "outcome": outcome})
            open_count = 1 if self._open_id else 0
            self._evict_locked()
        # metric writes outside the lock (registry takes its own)
        _capture_counter(outcome).inc()
        _capture_hist().observe(capture_ms)
        _open_gauge().set(float(open_count))
        if opened is not None:
            from .flightrec import get_flight_recorder
            get_flight_recorder().record("incident_open", id=opened,
                                         rule=rule)

    def _snapshot_evidence(self, payload: Dict[str, Any], now: float
                           ) -> Dict[str, Any]:
        """The unlocked evidence read for one firing edge."""
        rule = payload.get("rule")
        alert, start = None, now
        for r in self.engine.rules():
            if r.name == rule:
                alert = r.to_dict()
                # pending_since survives into FIRING — the breach's
                # onset, not its threshold crossing, starts the window
                start = r.pending_since or r.firing_since or now
                break
        window_start = start - self.lookback_s
        history = [(t, d) for t, d in self.history.samples()
                   if t >= window_start]
        from .flightrec import get_flight_recorder
        events = get_flight_recorder().events()
        last_seq = int(events[-1]["seq"]) if events else 0
        flight = [e for e in events
                  if float(e.get("t", 0.0)) >= window_start]
        return {
            "window_start": window_start,
            "history": history,
            "flight_events": flight,
            "last_seq": last_seq,
            "alert": alert,
            "exemplar_spans": self._pin_exemplar(
                payload.get("exemplar_trace_id")),
            "context": self._context_blocks(),
        }

    @staticmethod
    def _pin_exemplar(trace_id: Optional[str]) -> List[Dict[str, Any]]:
        """COPY the exemplar trace's spans out of the tracer ring at
        fire time: ring wraparound and the 600 s exemplar TTL must never
        hollow out an open incident's bundle."""
        if not trace_id:
            return []
        from .tracer import get_tracer
        spans = []
        for ev in get_tracer().events():
            args = ev.get("args") or {}
            if args.get("trace_id") == trace_id:
                pinned = dict(ev)
                pinned["args"] = dict(args)
                spans.append(pinned)
        return spans

    @staticmethod
    def _context_blocks() -> Dict[str, Any]:
        """Jit table + lock census always; probe/collector snapshots
        only when those planes are WIRED (lazy global already
        constructed) — never construct a plane as a capture side
        effect. Each block is failure-isolated: one broken source must
        not cost the bundle the others."""
        ctx: Dict[str, Any] = {}
        try:
            from .jitwatch import get_jit_registry
            ctx["jit_table"] = get_jit_registry().table()
        except Exception:
            log.exception("incident capture: jit table read failed")
        try:
            from . import lockwatch
            ctx["lock_census"] = lockwatch.contention_table()
        except Exception:
            log.exception("incident capture: lock census read failed")
        for key, mod_name, attr in (
                ("probes", "deeplearning4j_torch.monitor.probes",
                 "_PROBER"),
                ("collector", "deeplearning4j_torch.monitor.collector",
                 "_COLLECTOR")):
            mod = sys.modules.get(mod_name)
            obj = getattr(mod, attr, None) if mod is not None else None
            if obj is None:
                continue
            try:
                ctx[key] = obj.snapshot()
            except Exception:
                log.exception("incident capture: %s snapshot failed", key)
        return ctx

    # --------------------------------------------------- resolve / close
    def _resolve(self, payload: Dict[str, Any], now: float) -> bool:
        rule = payload.get("rule")
        with self._lock:
            inc = (self._incidents.get(self._open_id)
                   if self._open_id else None)
            if inc is None or rule not in inc.rules:
                # a resolve for a rule no incident tracks (e.g. the
                # recorder came up mid-flight) is not an incident edge
                return False
            entry = inc.rules[rule]
            if entry.get("resolved_t") is None:
                entry["resolved_t"] = now
                entry["resolve_detail"] = payload.get("detail")
            if any(e.get("resolved_t") is None
                   for e in inc.rules.values()):
                return True
            # every member rule resolved: the incident closes
            inc.status = "resolved"
            inc.closed_t = now
            self._open_id = None
        self._close(inc, now)
        return True

    def abort_open(self, reason: str = "halt") -> List[str]:
        """Flush any open incident as ``status="aborted"`` — the
        ``record_halt`` crash-dump path: a process dying mid-incident
        leaves evidence on disk rather than nothing. Returns the
        persisted bundle paths (empty without a dump dir)."""
        with self._lock:
            inc = (self._incidents.get(self._open_id)
                   if self._open_id else None)
            if inc is None:
                return []
            inc.status = "aborted"
            inc.closed_t = time.time()
            self._open_id = None
        self._close(inc, inc.closed_t, reason=reason)
        return [inc.path] if inc.path else []

    def _close(self, inc: Incident, now: float, reason: str = "resolved"):
        """Finalize one incident OUTSIDE the lock: append the flight
        tail recorded while it was open, build + persist the bundle,
        then re-enter the lock only to publish the results."""
        from .flightrec import get_flight_recorder
        tail = [e for e in get_flight_recorder().events()
                if int(e.get("seq", 0)) > inc.open_last_seq]
        with self._lock:
            inc.flight_events = inc.flight_events + tail
            bundle = self._bundle_locked(inc)
        persisted = self._persist(inc.id, bundle)
        with self._lock:
            inc.bundle = bundle
            if persisted is not None:
                inc.path, inc.bundle_bytes = persisted
            still_open = self._open_id is not None
        _open_gauge().set(1.0 if still_open else 0.0)
        get_flight_recorder().record(
            "incident_closed", id=inc.id, status=inc.status,
            rules=sorted(inc.rules), path=inc.path, reason=reason)
        log.info("incident %s closed (%s): %d rule(s), %d flight "
                 "event(s)%s", inc.id, inc.status, len(inc.rules),
                 len(inc.flight_events),
                 f", bundle {inc.path}" if inc.path else "")

    @staticmethod
    def _bundle_locked(inc: Incident) -> Dict[str, Any]:
        """The offline-reconstruction schema (caller holds ``_lock``;
        every container is copied out so the bundle never aliases live
        incident state)."""
        return {
            "format": BUNDLE_FORMAT,
            "id": inc.id,
            "status": inc.status,
            "opened_t": inc.opened_t,
            "closed_t": inc.closed_t,
            "window_start": inc.window_start,
            "rules": {n: dict(e) for n, e in inc.rules.items()},
            "history": [[t, d] for t, d in inc.history],
            "flight_events": [dict(e) for e in inc.flight_events],
            "control_actions": [dict(e) for e in inc.flight_events
                                if e.get("event") == "control_action"],
            "context": dict(inc.context),
            "captures": [dict(c) for c in inc.captures],
        }

    def _persist(self, incident_id: str, bundle: Dict[str, Any]
                 ) -> Optional[Tuple[str, int]]:
        """Content-addressed write under the FlightRecorder dump
        convention: explicit ``dump_dir`` beats the
        ``DL4J_TPU_INCIDENT_DIR`` env var; neither → in-memory only. A
        failed write logs and returns None — closing an incident must
        never die harder because its black box had no disk."""
        base = self.dump_dir or os.environ.get("DL4J_TPU_INCIDENT_DIR")
        if not base:
            return None
        payload = json.dumps(bundle, sort_keys=True, default=repr)
        digest = hashlib.sha256(payload.encode("utf-8")).hexdigest()[:16]
        path = os.path.join(base, f"{incident_id}-{digest}.dl4jinc")
        try:
            with open(path, "w") as fh:
                fh.write(payload)
        except OSError as e:
            log.warning("incident bundle write to %s failed: %s", path, e)
            return None
        return path, len(payload)

    # ------------------------------------------------------ bounded table
    def _evict_locked(self):
        """Oldest CLOSED incidents leave first; the open incident is
        evidence-in-progress and only goes when it is the whole table."""
        while len(self._incidents) > self.max_incidents:
            victim = None
            for iid, inc in self._incidents.items():
                if inc.status != "open":
                    victim = iid
                    break
            if victim is None:
                victim = next(iter(self._incidents))
                if victim == self._open_id:
                    self._open_id = None
            del self._incidents[victim]
            self.evicted += 1

    # -------------------------------------------------------------- reading
    def incidents(self) -> List[Incident]:
        with self._lock:
            return list(self._incidents.values())

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /incidents`` payload (always HTTP 200, like
        ``/alerts`` — the incident surface must stay readable exactly
        while an incident is open)."""
        with self._lock:
            rows = [inc.row() for inc in self._incidents.values()]
            open_ids = [self._open_id] if self._open_id else []
            running = (self._thread is not None
                       and self._thread.is_alive())
            last = self.last_tick
            evicted = self.evicted
        return {"incidents": rows, "open": open_ids,
                "max_incidents": self.max_incidents,
                "lookback_s": self.lookback_s, "evicted": evicted,
                "running": running, "evaluated_at": last}

    def bundle(self, incident_id: str) -> Optional[Dict[str, Any]]:
        """The full bundle for ``GET /incidents/<id>``: the persisted
        schema for closed incidents, a provisional copy (no flight
        tail yet) for the open one. ``None`` for unknown ids."""
        with self._lock:
            inc = self._incidents.get(incident_id)
            if inc is None:
                return None
            if inc.bundle is not None:
                return inc.bundle
            return self._bundle_locked(inc)


# ------------------------------------------------------------ bundle I/O
def load_bundle(path: str) -> Dict[str, Any]:
    """Re-load a persisted ``.dl4jinc`` bundle, verifying the content
    address when the filename carries one (``<id>-<digest16>.dl4jinc``)
    — a truncated or edited bundle must fail loudly, not render a
    partial story as the whole one."""
    with open(path, "r") as fh:
        raw = fh.read()
    name = os.path.basename(path)
    if name.endswith(".dl4jinc") and "-" in name:
        want = name[:-len(".dl4jinc")].rsplit("-", 1)[-1]
        if len(want) == 16:
            got = hashlib.sha256(raw.encode("utf-8")).hexdigest()[:16]
            if got != want:
                raise ValueError(
                    f"bundle {path} fails its content address "
                    f"({got} != {want}): truncated or edited")
    return json.loads(raw)


def _fmt_t(t: Optional[float], t0: Optional[float]) -> str:
    if t is None:
        return "-"
    if t0 is not None:
        return f"{t - t0:+.2f}s"
    return f"{t:.3f}"


def _render_trace(spans: List[Dict[str, Any]]) -> List[str]:
    """Indent the pinned Chrome-trace spans into a parent→child tree
    (roots = spans whose parent is outside the pinned set)."""
    by_id: Dict[str, Dict[str, Any]] = {}
    for ev in spans:
        sid = (ev.get("args") or {}).get("span_id")
        if sid:
            by_id[sid] = ev
    children: Dict[str, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for ev in spans:
        parent = (ev.get("args") or {}).get("parent_span_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(ev)
        else:
            roots.append(ev)
    lines: List[str] = []

    def walk(ev, depth):
        dur_ms = float(ev.get("dur", 0.0)) / 1000.0
        cat = ev.get("cat", "")
        lines.append(f"    {'  ' * depth}- {ev.get('name')} "
                     f"[{cat}] {dur_ms:.2f}ms")
        sid = (ev.get("args") or {}).get("span_id")
        for child in sorted(children.get(sid, []),
                            key=lambda e: e.get("ts", 0.0)):
            walk(child, depth + 1)

    for root in sorted(roots, key=lambda e: e.get("ts", 0.0)):
        walk(root, 0)
    return lines


def render_incident_text(bundle: Dict[str, Any]) -> str:
    """The text rendering of a bundle: header, per-rule summary, the
    seq-ordered merged timeline (alert edges → probe outcomes → control
    actions), and each rule's pinned exemplar trace tree inlined."""
    t0 = bundle.get("opened_t")
    lines = [f"# incident {bundle.get('id')} — {bundle.get('status')}"]
    closed = bundle.get("closed_t")
    dur = (f", duration {closed - t0:.2f}s"
           if closed is not None and t0 is not None else "")
    lines.append(f"opened_t={t0} closed_t={closed}{dur}")
    rules = bundle.get("rules") or {}
    lines.append(f"rules ({len(rules)} merged):")
    for name in sorted(rules):
        e = rules[name]
        lines.append(
            f"  {name}  severity={e.get('severity')}  "
            f"fired={_fmt_t(e.get('fired_t'), t0)}  "
            f"resolved={_fmt_t(e.get('resolved_t'), t0)}  "
            f"value={e.get('value')}")
        if e.get("detail"):
            lines.append(f"    detail: {e['detail']}")
    history = bundle.get("history") or []
    if history:
        lines.append(f"history: {len(history)} sample(s) spanning "
                     f"{history[-1][0] - history[0][0]:.1f}s "
                     f"(window_start={bundle.get('window_start')})")
    events = sorted(bundle.get("flight_events") or [],
                    key=lambda e: int(e.get("seq", 0)))
    shown = [e for e in events if e.get("event") in _TIMELINE_EVENTS]
    lines.append(f"timeline ({len(shown)} of {len(events)} flight "
                 f"event(s), seq order):")
    for e in shown:
        kind = e.get("event")
        extra = " ".join(
            f"{k}={v}" for k, v in sorted(e.items())
            if k not in ("t", "seq", "event") and v is not None)
        lines.append(f"  [{e.get('seq')}] {_fmt_t(e.get('t'), t0)} "
                     f"{kind}  {extra}".rstrip())
    actions = bundle.get("control_actions") or []
    if actions:
        lines.append(f"control actions under this incident: "
                     f"{len(actions)}")
    for name in sorted(rules):
        spans = rules[name].get("exemplar_spans") or []
        if not spans:
            continue
        lines.append(f"exemplar trace "
                     f"{rules[name].get('exemplar_trace_id')} "
                     f"(rule {name}, {len(spans)} span(s)):")
        lines.extend(_render_trace(spans))
    return "\n".join(lines)


# --------------------------------------------------------- module globals
#: lazy: a bare process has no recorder object at all — the halt hook
#: and the HTTP endpoints check this before constructing anything
_RECORDER: Optional[IncidentRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_incident_recorder() -> IncidentRecorder:
    """The process-global recorder (constructed on first use; never
    started implicitly)."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = IncidentRecorder()
        return _RECORDER


def abort_open_incidents(reason: str = "halt") -> List[str]:
    """Module-level hook ``HealthState.record_halt`` calls via
    ``sys.modules`` (the control-block pattern): flush any open
    incident as an ``aborted`` bundle. No-op when no recorder was ever
    constructed — a bare process pays nothing."""
    rec = _RECORDER
    if rec is None:
        return []
    # drain any queued-but-unprocessed edges first: the halt may be the
    # direct consequence of a firing edge still sitting in the deque
    try:
        rec.tick()
    except Exception:
        log.exception("incident flush tick on halt failed")
    return rec.abort_open(reason=reason)
