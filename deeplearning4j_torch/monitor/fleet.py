"""Fleet state: per-worker telemetry aggregated at the parameter server.

Counterpart of ``deeplearning4j_tpu/monitor/fleet.py``. A data-parallel run
over the parameter server is N processes with N registries, N trace rings
and N health states. Workers ship a compact report over ``OP_TELEMETRY``
(``paramserver/client.py::send_telemetry``); the server lands every report
in the process-global :class:`FleetState` (:func:`get_fleet`), which gives

- the merged registry view (:meth:`FleetState.render_prometheus`): every
  worker's series re-labeled ``worker=<id>`` through
  ``registry.render_prometheus_dump``, plus ``fleet_worker_up`` /
  ``fleet_worker_last_seen_age_s``;
- a merged Chrome trace (:meth:`FleetState.merged_trace`,
  :func:`merge_traces`): each process on its own stable ``pid`` row, the
  propagated trace ids tying a client ``ps/push`` span to the server's
  ``ps/apply_push`` span across rows;
- per-worker liveness (:meth:`FleetState.liveness`), which
  ``HealthState.snapshot`` folds in: a worker whose last report is older
  than ``stale_after`` is listed as stale.

The HTTP routes that serve these in the JAX package (``GET /fleet``,
``/fleet/trace``, ``/healthz``) are ``ui/``'s and not ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

from .registry import render_prometheus_dump

__all__ = ["FleetState", "get_fleet", "merge_traces"]

#: seconds without a telemetry report before a worker counts as stale
DEFAULT_STALE_AFTER = 15.0

#: per-worker merged-trace retention (events). Reports ACCUMULATE here
#: (each one ships only the newest ring tail, so replacement would drop
#: spans older than one report); the bound keeps a chatty worker from
#: growing the fleet table without limit.
TRACE_EVENTS_PER_WORKER = 4096


def _span_key(ev: dict):
    """Identity of one span occurrence: (trace_id, span_id, ts). The
    telemetry clients ship the newest ring TAIL each report, so
    consecutive reports overlap — this key is what merge-time dedup
    collapses on. Events without the full key (metadata rows, foreign
    formats) get None: never deduped."""
    args = ev.get("args") or {}
    tid, sid, ts = args.get("trace_id"), args.get("span_id"), ev.get("ts")
    if tid is None or sid is None or ts is None:
        return None
    return (tid, sid, ts)


def merge_traces(named_events: Dict[str, List[dict]],
                 pids: Optional[Dict[str, int]] = None) -> dict:
    """Merge per-process trace-event lists into ONE Chrome-trace document:
    each label gets its own ``pid`` row (with a ``process_name`` metadata
    event, so Perfetto shows 'worker:w1' instead of a bare number) while
    ``tid`` and the propagated ``trace_id``/``span_id`` args survive
    untouched — causality across rows stays visible.

    ``pids`` maps label → pid row; labels not in the map are numbered
    after the mapped rows in sorted order. Without a map, pids follow
    sorted-label enumeration — which RENUMBERS every row when a label
    joins or leaves, so callers exporting repeatedly (the fleet table)
    pass their stable assignment. Duplicate span occurrences (same
    ``(trace_id, span_id, ts)`` — overlapping telemetry report windows)
    are dropped after their first appearance."""
    pids = dict(pids or {})
    next_pid = max(pids.values(), default=-1) + 1
    for label in sorted(named_events):
        if label not in pids:
            pids[label] = next_pid
            next_pid += 1
    events: List[dict] = []
    seen = set()
    for label in sorted(named_events, key=lambda lb: pids[lb]):
        pid = pids[label]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": label}})
        for ev in named_events[label]:
            key = _span_key(ev)
            if key is not None:
                if key in seen:
                    continue
                seen.add(key)
            ev = dict(ev)
            ev["pid"] = pid
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class FleetState:
    """Thread-safe per-worker last-report table.

    One per process via :func:`get_fleet` (the parameter server feeds it;
    the UI server and ``/healthz`` read it), or standalone in tests.
    Staleness is computed at READ time from ``last_seen`` — a silent
    worker's age keeps growing, exactly like ``/healthz``'s
    ``last_iteration_age_s``.
    """

    def __init__(self, stale_after: float = DEFAULT_STALE_AFTER):
        self.stale_after = float(stale_after)
        from .lockwatch import make_lock
        self._lock = make_lock("FleetState._lock")
        self._workers: Dict[str, dict] = {}
        #: stable label → pid assignment for merged traces: a label keeps
        #: its pid for the table's lifetime, so a replica joining or
        #: leaving never renumbers the other Perfetto process rows
        #: between successive exports
        self._pids: Dict[str, int] = {}

    def _pid_for_locked(self, label: str) -> int:
        """First-seen pid assignment (caller holds ``_lock``). Pids are
        never reused or renumbered while the table lives; ``clear()``
        resets the assignment with everything else."""
        if label not in self._pids:
            self._pids[label] = max(self._pids.values(), default=-1) + 1
        return self._pids[label]

    # ------------------------------------------------------------- feeding
    def record_report(self, worker: str, report: dict, *,
                      append_flight: bool = False):
        """Land one telemetry report — pushed over ``OP_TELEMETRY`` or
        pulled by the scrape-plane collector (monitor/collector.py), the
        table cannot tell and the merged surfaces must not: ``registry``
        (a ``MetricsRegistry.dump()``), optional ``trace_events`` (Chrome
        trace events), ``flight_events``, ``exemplars`` and ``health`` —
        all already plain JSON from the wire.

        Trace events ACCUMULATE into a bounded per-worker ring, deduped
        by ``(trace_id, span_id, ts)`` — clients ship the newest ring
        tail each report, so consecutive reports overlap; replacement
        would drop history, blind appending would duplicate every
        overlapped span. ``append_flight=True`` (the collector's
        cursored feed, where each report carries only NEW events)
        extends the flight-event ring instead of replacing it."""
        worker = str(worker)
        with self._lock:
            entry = self._workers.setdefault(
                worker, {"first_seen": time.time(), "reports": 0})
            self._pid_for_locked(f"worker:{worker}")
            entry["last_seen"] = time.time()
            entry["reports"] += 1
            entry["registry"] = report.get("registry") or {}
            if report.get("trace_events") is not None:
                ring = entry.setdefault(
                    "trace_events", deque(maxlen=TRACE_EVENTS_PER_WORKER))
                seen = {_span_key(ev) for ev in ring}
                seen.discard(None)
                for ev in report["trace_events"]:
                    key = _span_key(ev)
                    if key is not None and key in seen:
                        continue
                    if key is not None:
                        seen.add(key)
                    ring.append(ev)
            if report.get("flight_events") is not None:
                if append_flight:
                    ring = entry.setdefault(
                        "flight_events",
                        deque(maxlen=TRACE_EVENTS_PER_WORKER))
                    ring.extend(report["flight_events"])
                else:
                    entry["flight_events"] = list(report["flight_events"])
            if report.get("exemplars") is not None:
                entry["exemplars"] = dict(report["exemplars"])
            if report.get("health") is not None:
                entry["health"] = report["health"]

    def clear(self):
        with self._lock:
            self._workers.clear()
            self._pids.clear()

    # ------------------------------------------------------------- reading
    def liveness(self) -> dict:
        """JSON liveness table: the ``/fleet?format=json`` payload and the
        block ``/healthz`` folds in. When workers report sharded-
        paramserver series, a per-shard rollup rides along as
        ``"shards"`` (see :meth:`shard_block`)."""
        now = time.time()
        with self._lock:
            workers = {
                w: {"last_seen_age_s": now - e["last_seen"],
                    "stale": (now - e["last_seen"]) > self.stale_after,
                    "reports": e["reports"],
                    "series": len(e.get("registry") or {})}
                for w, e in self._workers.items()}
        out = {"stale_after_s": self.stale_after,
               "workers": workers,
               "stale": sorted(w for w, i in workers.items()
                               if i["stale"])}
        shards = self.shard_block()
        if shards:
            out["shards"] = shards
        return out

    def shard_block(self) -> Dict[str, dict]:
        """Per-shard rollup of the sharded-paramserver series workers ship
        over OP_TELEMETRY (docs/PARALLELISM.md "Sharded parameter-server
        fleet"): for each shard label, the max ``paramserver_shard_
        staleness`` across workers (and the per-worker values — the
        rebalance/dead-shard audit view), plus ``paramserver_wire_bytes_
        total`` summed over ops/directions/workers. Empty when no worker
        reports the series (a fleet without the sharded client)."""
        with self._lock:
            regs = {w: e.get("registry") or {}
                    for w, e in self._workers.items()}
        shards: Dict[str, dict] = {}

        def entry(label: str) -> dict:
            return shards.setdefault(label, {
                "staleness_max": 0.0, "staleness": {},
                "wire_bytes": {"tx": 0.0, "rx": 0.0}})

        for worker, reg in regs.items():
            fam = reg.get("paramserver_shard_staleness") or {}
            for row in fam.get("children", []):
                label = row.get("labels", {}).get("shard")
                if label is None:
                    continue
                ent = entry(label)
                value = float(row.get("value", 0.0))
                ent["staleness"][worker] = value
                ent["staleness_max"] = max(ent["staleness_max"], value)
            fam = reg.get("paramserver_wire_bytes_total") or {}
            for row in fam.get("children", []):
                labels = row.get("labels", {})
                label = labels.get("shard")
                direction = labels.get("direction")
                # client rows only: a worker co-hosting a shard node ships
                # BOTH roles in one registry, and the server rows are the
                # same bytes seen from the other end — summing both would
                # double-count every frame
                if label is None or direction not in ("tx", "rx") \
                        or labels.get("role") != "client":
                    continue
                entry(label)["wire_bytes"][direction] += \
                    float(row.get("value", 0.0))
        return shards

    def merged_dump(self) -> Dict[str, dict]:
        """The merged fleet registry view as a DUMP (the wire shape
        ``MetricsRegistry.dump()`` produces): every worker's shipped
        series re-labeled ``worker=<id>``, preceded by the synthesized
        ``fleet_worker_up`` / ``fleet_worker_last_seen_age_s`` liveness
        series (staleness computed at read time, as always). This is
        what ``/fleet`` renders AND what the scrape-plane collector's
        history ring samples — one merge, two surfaces, so alert rules
        evaluated over the fleet history see exactly the series a
        Prometheus scrape would. Type conflicts across workers (same
        family name, different type — a half-upgraded fleet) keep the
        first-seen type and drop the conflicting worker's children for
        that family rather than emitting an invalid exposition; the
        per-family ``unit`` rides along so windowed quantiles over the
        merged dump read bucket edges in the right unit."""
        now = time.time()
        with self._lock:
            items = [(w, e.get("registry") or {}, now - e["last_seen"])
                     for w, e in sorted(self._workers.items())]
        up = {"type": "gauge", "help": "1 while the worker's telemetry is "
              "fresh, 0 once stale", "children": []}
        age = {"type": "gauge",
               "help": "seconds since the worker's last telemetry report",
               "children": []}
        merged: Dict[str, dict] = {"fleet_worker_up": up,
                                   "fleet_worker_last_seen_age_s": age}
        for worker, dump, age_s in items:
            up["children"].append(
                {"labels": {"worker": worker},
                 "value": 0.0 if age_s > self.stale_after else 1.0})
            age["children"].append(
                {"labels": {"worker": worker}, "value": age_s})
            for name, fam in dump.items():
                tgt = merged.setdefault(
                    name, {"type": fam["type"],
                           "help": fam.get("help", ""), "children": []})
                if tgt["type"] != fam["type"]:
                    continue        # mixed-version fleet: skip, don't lie
                if "unit" in fam:
                    tgt.setdefault("unit", fam["unit"])
                for row in fam["children"]:
                    row = dict(row)
                    row["labels"] = {**row["labels"], "worker": worker}
                    tgt["children"].append(row)
        return merged

    def render_prometheus(self) -> str:
        """The merged fleet scrape: :meth:`merged_dump` as Prometheus
        text."""
        return render_prometheus_dump(self.merged_dump())

    def worst_exemplar(self, metric: str,
                       worker: Optional[str] = None) -> Optional[str]:
        """The worst latched exemplar trace id a worker shipped for
        ``metric`` (``worker=None``: across the whole fleet). Exemplars
        live only in each replica's LIVE registry, so the ``/telemetry``
        reply carries them explicitly and the fleet-scope latency rules
        read them here — a fleet p99 alert must point at the guilty
        replica's offending request, resolvable on THAT replica's
        ``/trace``."""
        with self._lock:
            rows = [(w, e.get("exemplars") or {})
                    for w, e in self._workers.items()
                    if worker is None or w == str(worker)]
        worst = None
        for _w, exemplars in rows:
            for row in exemplars.get(metric) or []:
                if row.get("exemplar") is None:
                    continue
                if worst is None or row.get("value", 0.0) > worst[0]:
                    worst = (row.get("value", 0.0), row["exemplar"])
        return worst[1] if worst else None

    def merged_trace(self, local_events: Optional[List[dict]] = None,
                     local_label: str = "server") -> dict:
        """One Chrome-trace document for the whole fleet: every worker's
        shipped trace events plus this process's own (default: the global
        tracer — the server-side ``ps/apply`` spans live there), each on
        its own STABLE ``pid`` row (first-seen assignment, so a replica
        joining or leaving between exports never renumbers the others),
        overlapping report windows deduped by (trace_id, span_id, ts)."""
        with self._lock:
            named = {f"worker:{w}": list(e.get("trace_events") or [])
                     for w, e in self._workers.items()}
            pids = {label: self._pid_for_locked(label)
                    for label in list(named) + [local_label]}
        if local_events is None:
            from .tracer import get_tracer
            local_events = get_tracer().events()
        named[local_label] = list(local_events)
        return merge_traces(named, pids=pids)


#: the process-global fleet table (the parameter server writes, the UI
#: server and /healthz read)
_FLEET = FleetState()


def get_fleet() -> FleetState:
    return _FLEET
