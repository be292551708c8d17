"""The scrape plane: pull-based telemetry federation.

Counterpart of ``deeplearning4j_tpu/monitor/collector.py``, under its
series, flight events and document keys, and on the same wire: a port
collector scrapes a JAX replica's ``/telemetry`` and the other way round.

- :func:`telemetry_snapshot`: the ``GET /telemetry`` payload every server
  of the port serves (``ui/server.py``'s ``JsonRequestHandler``): the
  registry dump, the trace-ring tail, flight events cursored by seq, the
  health snapshot and the latency histograms' latched exemplars, in one
  round trip.
- :class:`TelemetryCollector`: an opt-in daemon (idempotent
  ``start(interval_s)``, ``stop()`` joins its thread, ``tick(now=)`` the
  deterministic seam) that polls each :class:`ScrapeTarget` over HTTP and
  lands the reply in a :class:`~.fleet.FleetState` via ``record_report``,
  so ``/fleet``, ``/fleet/trace`` and the liveness fold-in serve scraped
  replicas as they serve parameter-server workers.

Cursoring: a target's first scrape carries no ``since_seq`` and gets only
``last_seq`` back, so a replica's earlier flight events never replay as
fresh. Later scrapes pass the cursor; the events they return are recorded
again in the local flight recorder with ``target=``, ``origin_seq`` and
``origin_t``. An event that already carries a ``target`` (a replica that
runs a collector, or a collector scraping its own process) keeps it as
``origin_target``, where the JAX package's relay raises ``TypeError``.

Each tick samples the merged fleet dump (:meth:`TelemetryCollector.
fleet_dump`) into the collector's own history ring and evaluates its own
:class:`~.alerts.AlertEngine`, so ``default_fleet_scope_rules`` (burn
across replicas, the worst replica's p99, ``fleet_target_up`` gaps) run on
the alert machinery unchanged. Each scrape is observed:
``fleet_scrape_duration_ms{target=}``, ``fleet_scrape_errors_total
{target=}``, ``fleet_target_up{target=}``. The collector's lock is a leaf:
it guards the target table, cursors and counters only; scrapes, fleet
writes, sampling and evaluation run with no lock held.
"""
from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Dict, List, Optional

from .lockwatch import make_lock

log = logging.getLogger(__name__)

__all__ = ["ScrapeTarget", "TelemetryCollector", "telemetry_snapshot",
           "get_collector"]

#: default scrape cadence (seconds) — slower than the history sampler's
#: 2s: a scrape is N HTTP round trips, not one in-process dump
DEFAULT_INTERVAL_S = 5.0

#: per-target HTTP timeout (seconds); a hung replica costs one scrape
#: slot, never the whole tick loop
DEFAULT_TIMEOUT_S = 5.0

#: newest trace-ring tail shipped per /telemetry reply — same sizing as
#: the push path's TELEMETRY_TRACE_EVENTS (paramserver/client.py);
#: consecutive replies overlap, which the fleet merge dedups by
#: (trace_id, span_id, ts)
TELEMETRY_TRACE_EVENTS = 512


def telemetry_snapshot(since_seq: Optional[int] = None,
                       trace_tail: int = TELEMETRY_TRACE_EVENTS) -> dict:
    """The ``GET /telemetry`` payload: everything a fleet collector
    needs from one replica in ONE round trip.

    - ``registry``: the full ``MetricsRegistry.dump()`` wire format.
    - ``trace_events``: the newest ``trace_tail`` Chrome-trace events.
    - ``flight_events``: ``since_seq`` given → only events with
      ``seq > since_seq``; omitted → NONE (the cursor-priming reply —
      a collector must opt into history with ``since_seq=-1``, never
      receive it by accident and replay it as fresh).
    - ``last_seq``: the newest flight-recorder sequence number — the
      cursor the caller passes next time.
    - ``health``: the ``/healthz`` snapshot (liveness folded into the
      same round trip).
    - ``exemplars``: per latency-histogram child, the worst latched
      exemplar trace id — exemplars live only in the live registry, not
      in dumps, and a fleet-scope p99 alert must surface the GUILTY
      replica's trace id.
    """
    from .flightrec import get_flight_recorder
    from .health import get_health
    from .registry import get_registry
    from .tracer import get_tracer

    reg = get_registry()
    dump = reg.dump()
    exemplars: Dict[str, List[dict]] = {}
    for name, fam in dump.items():
        if fam.get("type") != "histogram":
            continue
        rows = []
        for row in fam.get("children", []):
            labels = row.get("labels", {})
            ex = reg.histogram(name, **labels).worst_exemplar()
            if ex:
                rows.append({"labels": labels, "value": ex["value"],
                             "exemplar": ex["exemplar"]})
        if rows:
            exemplars[name] = rows
    rec = get_flight_recorder()
    events = rec.events()
    last_seq = events[-1]["seq"] if events else 0
    fresh = ([e for e in events if e.get("seq", 0) > since_seq]
             if since_seq is not None else [])
    return {
        "registry": dump,
        "trace_events": get_tracer().events()[-int(trace_tail):],
        "flight_events": fresh,
        "last_seq": last_seq,
        "health": get_health().snapshot(),
        "exemplars": exemplars,
    }


class ScrapeTarget:
    """One pull-plane endpoint: a label (the fleet table's worker key —
    series re-label as ``worker=<label>`` on ``/fleet``) and the
    replica's base URL (scheme optional; ``/telemetry`` is appended)."""

    def __init__(self, label: str, url: str):
        self.label = str(label)
        url = str(url)
        if "://" not in url:
            url = f"http://{url}"
        self.url = url.rstrip("/")

    def to_dict(self) -> dict:
        return {"label": self.label, "url": self.url}

    def __repr__(self):
        return f"ScrapeTarget({self.label!r}, {self.url!r})"


class _FleetDumpSource:
    """Registry-shaped adapter (`.dump()`) so the collector's
    :class:`MetricsHistory` samples the MERGED fleet dump instead of the
    process registry — the seam that lets the existing alert machinery
    evaluate fleet-scope SLOs unchanged."""

    def __init__(self, collector: "TelemetryCollector"):
        self._collector = collector

    def dump(self) -> dict:
        return self._collector.fleet_dump()


class TelemetryCollector:
    """Pull-based fleet collector daemon. Opt-in like the history
    sampler and the control plane: construction starts nothing; tests
    drive :meth:`tick` deterministically; production calls
    ``start(interval_s)`` and ``stop()`` timed-joins the thread.

    ``fleet`` defaults to the process-global table (so ``GET /fleet``,
    ``/fleet/trace`` and the ``/healthz`` fleet fold-in serve the
    scraped replicas with zero extra wiring); pass a private
    :class:`~.fleet.FleetState` for isolation. ``history`` and
    ``engine`` default to private instances sampling the merged fleet
    dump — attach fleet-scope rules with
    ``collector.engine.add(*default_fleet_scope_rules(fleet=collector.fleet))``.
    """

    def __init__(self, fleet=None, history=None, engine=None, *,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 trace_tail: int = TELEMETRY_TRACE_EVENTS):
        from .fleet import get_fleet
        from .history import MetricsHistory
        from .alerts import AlertEngine
        self.fleet = fleet if fleet is not None else get_fleet()
        self.history = (history if history is not None
                        else MetricsHistory(registry=_FleetDumpSource(self)))
        self.engine = (engine if engine is not None
                       else AlertEngine(history=self.history))
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.trace_tail = int(trace_tail)
        self._lock = make_lock("TelemetryCollector._lock")
        self._targets: Dict[str, ScrapeTarget] = {}
        self._cursors: Dict[str, int] = {}
        self._up: Dict[str, bool] = {}
        self._errors: Dict[str, int] = {}
        self._last_scrape_t: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ targets
    def add_target(self, label: str, url: str) -> "TelemetryCollector":
        target = ScrapeTarget(label, url)
        with self._lock:
            self._targets[target.label] = target
        return self

    def remove_target(self, label: str):
        with self._lock:
            self._targets.pop(str(label), None)
            self._cursors.pop(str(label), None)
            self._up.pop(str(label), None)
            self._errors.pop(str(label), None)
            self._last_scrape_t.pop(str(label), None)

    def targets(self) -> List[ScrapeTarget]:
        with self._lock:
            return [self._targets[k] for k in sorted(self._targets)]

    def down_targets(self) -> List[ScrapeTarget]:
        """Targets whose LAST scrape failed (the view a fleet policy
        reads at fire time)."""
        with self._lock:
            return [self._targets[k] for k in sorted(self._targets)
                    if k in self._up and not self._up[k]]

    # ----------------------------------------------------------- scraping
    def _scrape(self, target: ScrapeTarget,
                cursor: Optional[int]) -> dict:
        """One UNLOCKED HTTP round trip to ``<url>/telemetry``. The
        first scrape for a target has no cursor and therefore gets no
        flight events back — that reply only primes ``last_seq``."""
        path = "/telemetry"
        if cursor is not None:
            path += f"?since_seq={int(cursor)}"
        with urllib.request.urlopen(target.url + path,
                                    timeout=self.timeout_s) as r:
            return json.loads(r.read().decode("utf-8"))

    @staticmethod
    def _scrape_metrics(label: str):
        from .registry import get_registry
        reg = get_registry()
        return (reg.histogram("fleet_scrape_duration_ms",
                              "wall-clock per /telemetry scrape by target",
                              target=label),
                reg.counter("fleet_scrape_errors_total",
                            "failed /telemetry scrapes by target",
                            target=label),
                reg.gauge("fleet_target_up",
                          "1 while the target's last scrape succeeded",
                          target=label))

    def tick(self, now: Optional[float] = None) -> dict:
        """One collection pass (the daemon's beat; also the test seam).

        Scrapes every configured target with NO lock held, lands each
        reply in the fleet table, re-records cursor-fresh remote flight
        events locally, then samples the merged fleet dump into the
        collector's history ring and evaluates the fleet-scope alert
        engine. Returns a per-tick summary (labels scraped, per-target
        scrape ms, errors) so tests latch exact numbers
        instead of diffing process-global counters."""
        from .flightrec import get_flight_recorder
        t_tick0 = time.perf_counter()
        now = float(now) if now is not None else time.time()
        with self._lock:
            targets = [self._targets[k] for k in sorted(self._targets)]
            cursors = dict(self._cursors)
        scraped: List[str] = []
        errors: Dict[str, str] = {}
        scrape_ms: Dict[str, float] = {}
        for target in targets:
            hist, err_counter, up_gauge = self._scrape_metrics(target.label)
            cursor = cursors.get(target.label)
            t0 = time.perf_counter()
            try:
                doc = self._scrape(target, cursor)
            except Exception as e:      # refused/timeout/bad JSON alike:
                ms = (time.perf_counter() - t0) * 1e3
                hist.observe(ms)        # a down replica is a DATA point,
                scrape_ms[target.label] = ms   # never a collector crash
                err_counter.inc()
                up_gauge.set(0.0)
                errors[target.label] = f"{type(e).__name__}: {e}"
                with self._lock:
                    was_up = self._up.get(target.label)
                    self._up[target.label] = False
                    self._errors[target.label] = \
                        self._errors.get(target.label, 0) + 1
                if was_up is not False:   # edge-triggered, never per-tick
                    get_flight_recorder().record(
                        "fleet_target_down", target=target.label,
                        url=target.url, error=errors[target.label])
                log.warning("fleet scrape of %s (%s) failed: %s",
                            target.label, target.url,
                            errors[target.label])
                continue
            ms = (time.perf_counter() - t0) * 1e3
            hist.observe(ms)
            scrape_ms[target.label] = ms
            up_gauge.set(1.0)
            fresh = list(doc.get("flight_events") or [])
            with self._lock:
                was_up = self._up.get(target.label)
                self._up[target.label] = True
                self._cursors[target.label] = int(doc.get("last_seq") or 0)
                self._last_scrape_t[target.label] = now
            self.fleet.record_report(target.label, {
                "registry": doc.get("registry") or {},
                "trace_events": doc.get("trace_events"),
                "flight_events": fresh or None,
                "exemplars": doc.get("exemplars"),
                "health": doc.get("health"),
            }, append_flight=True)
            if was_up is False:
                get_flight_recorder().record("fleet_target_recovered",
                                             target=target.label,
                                             url=target.url)
            # cursor-fresh remote incidents become LOCAL edges (with
            # provenance) so event-triggered policies see them; the
            # primed cursor guarantees pre-existing history never lands
            for ev in fresh:
                # an event that already carries provenance (relayed by a
                # collector on the replica, or this process scraping
                # itself) takes this hop's; its target stays as
                # origin_target (the JAX package's relay raises TypeError)
                fields = {k: v for k, v in ev.items()
                          if k not in ("t", "seq", "event", "target", "origin_seq",
                                       "origin_t", "origin_target")}
                if "target" in ev:
                    fields["origin_target"] = ev["target"]
                get_flight_recorder().record(
                    str(ev.get("event", "fleet_event")),
                    target=target.label, origin_seq=ev.get("seq"),
                    origin_t=ev.get("t"), **fields)
            scraped.append(target.label)
        # upward loop: merged fleet dump -> history ring -> SLO engine
        if targets:
            self.history.sample(now=now)
            self.engine.evaluate(now=now, strict=False)
        return {"t": now, "scraped": scraped, "errors": errors,
                "scrape_ms": scrape_ms,
                "duration_ms": (time.perf_counter() - t_tick0) * 1e3}

    # ------------------------------------------------------- merged dump
    def fleet_dump(self) -> dict:
        """The merged fleet dump the collector's history samples: every
        landed report's series re-labeled ``worker=<label>`` plus the
        synthesized liveness series (``FleetState.merged_dump``), with
        the collector's OWN scrape series grafted in — filtered to the
        CURRENT target set, so a long-lived process registry cannot leak
        a retired target's ``fleet_target_up 0`` into a gap rule."""
        from .registry import get_registry
        dump = self.fleet.merged_dump()
        with self._lock:
            current = set(self._targets)
        reg_dump = get_registry().dump()
        for name in ("fleet_target_up", "fleet_scrape_errors_total",
                     "fleet_scrape_duration_ms"):
            fam = reg_dump.get(name)
            if not fam:
                continue
            rows = [r for r in fam.get("children", [])
                    if r.get("labels", {}).get("target") in current]
            if rows:
                dump[name] = {**{k: v for k, v in fam.items()
                                 if k != "children"}, "children": rows}
        return dump

    def snapshot(self) -> dict:
        """The collector's own state (targets, cursors, liveness) — the
        ``monitor --collect`` / debugging view."""
        with self._lock:
            targets = {
                k: {"url": t.url,
                    "up": self._up.get(k),
                    "cursor": self._cursors.get(k),
                    "errors": self._errors.get(k, 0),
                    "last_scrape_t": self._last_scrape_t.get(k)}
                for k, t in sorted(self._targets.items())}
        return {"interval_s": self.interval_s,
                "timeout_s": self.timeout_s,
                "running": self.running(),
                "targets": targets}

    # ---------------------------------------------------------- lifecycle
    def start(self, interval_s: Optional[float] = None
              ) -> "TelemetryCollector":
        """Start the background scrape loop (idempotent). The thread is
        a daemon AND joined by :meth:`stop` — THR002 discipline."""
        if interval_s is not None:
            self.interval_s = float(interval_s)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="telemetry-collector", daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        # first scrape immediately: a rule pack attached at start sees
        # fleet data after one interval, not two
        self._safe_tick()
        while not self._stop.wait(self.interval_s):
            self._safe_tick()

    def _safe_tick(self):
        try:
            self.tick()
        except Exception:
            log.exception("telemetry-collector tick failed")

    def stop(self, timeout: float = 5.0):
        with self._lock:
            thread, self._thread = self._thread, None
            if thread is not None:
                # set the event INSIDE the lock: a concurrent start()
                # serializes behind us and clears it for ITS thread —
                # setting after release could kill the fresh loop on its
                # first wait() (same invariant as MetricsHistory.stop)
                self._stop.set()
        if thread is not None:
            thread.join(timeout)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()


#: lazily-created process-global collector (no thread, no targets until
#: someone configures and starts it — tier-1 suites run with zero
#: collectors); feeds the process-global FleetState so /fleet serves it
_COLLECTOR: Optional[TelemetryCollector] = None
_COLLECTOR_LOCK = threading.Lock()


def get_collector() -> TelemetryCollector:
    global _COLLECTOR
    with _COLLECTOR_LOCK:
        if _COLLECTOR is None:
            _COLLECTOR = TelemetryCollector()
        return _COLLECTOR
