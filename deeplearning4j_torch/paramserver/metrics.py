"""Parameter-server observability: per-op counters and latency histograms.

Counterpart of ``deeplearning4j_tpu/paramserver/metrics.py``.
:class:`LatencyHistogram` is the monitor registry's (re-exported here).
Every :class:`ParamServerMetrics` is a registry-backed facade: its exact
per-instance counters and histograms keep the ``snapshot()`` shape (the
listener bus, ``OP_STATS``), while every increment is mirrored into the
process registry under ``paramserver_<counter>_total{role=}`` and
``paramserver_push_ms``/``paramserver_pull_ms{role=}`` (``role`` is
``client`` or ``server``). :class:`TrainStepPhases` times the training
master's phases as ``train/<phase>`` tracer spans and
``train_step_phase_ms{phase=}`` / ``train_step_wall_ms`` histograms, and
keeps running totals for :meth:`TrainStepPhases.hidden_share`.
:class:`ParamServerMetricsListener` surfaces a client's numbers on the
training listener bus.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List

from ..monitor import get_tracer
from ..monitor.lockwatch import make_lock
from ..monitor.registry import LatencyHistogram, get_registry
from ..optimize.listeners import TrainingListener

__all__ = ["LatencyHistogram", "COUNTERS", "ParamServerMetrics",
           "ParamServerMetricsListener", "TrainStepPhases"]

log = logging.getLogger(__name__)

#: counter names every metrics object carries (a fixed schema)
COUNTERS = ("pushes", "pulls", "push_bytes", "pull_bytes", "retries",
            "staleness_hits", "errors")


class ParamServerMetrics:
    """Thread-safe counters and push/pull latency histograms of one
    :class:`~.server.ParameterServer` (ops served, ``role="server"``) or
    :class:`~.client.ParameterServerClient` (ops issued, retries, staleness
    skips, ``role="client"``). ``snapshot()`` reads this instance's own
    numbers; the registry children are shared per role, so N clients
    aggregate into one scrape series."""

    def __init__(self, role: str = "client"):
        self.role = str(role)
        reg = get_registry()
        self._reg_counters = {
            k: reg.counter(f"paramserver_{k}_total",
                           "parameter-server op counter", role=self.role)
            for k in COUNTERS}
        self._reg_push = reg.histogram(
            "paramserver_push_ms", "push round-trip latency", role=self.role)
        self._reg_pull = reg.histogram(
            "paramserver_pull_ms", "pull round-trip latency", role=self.role)
        self._lock = make_lock("ParamServerMetrics._lock")
        self.counters: Dict[str, int] = {k: 0 for k in COUNTERS}
        self.push_latency = LatencyHistogram()
        self.pull_latency = LatencyHistogram()

    def add(self, counter: str, value: int = 1):
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0) + value
        child = self._reg_counters.get(counter)
        if child is None:
            child = self._reg_counters[counter] = get_registry().counter(
                f"paramserver_{counter}_total",
                "parameter-server op counter", role=self.role)
        child.inc(value)

    def record_push(self, ms: float, nbytes: int):
        with self._lock:
            self.counters["pushes"] += 1
            self.counters["push_bytes"] += int(nbytes)
            self.push_latency.record(ms)
        self._reg_counters["pushes"].inc()
        self._reg_counters["push_bytes"].inc(int(nbytes))
        self._reg_push.observe(ms)

    def record_pull(self, ms: float, nbytes: int):
        with self._lock:
            self.counters["pulls"] += 1
            self.counters["pull_bytes"] += int(nbytes)
            self.pull_latency.record(ms)
        self._reg_counters["pulls"].inc()
        self._reg_counters["pull_bytes"].inc(int(nbytes))
        self._reg_pull.observe(ms)

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time copy: counters and histogram summaries."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "push_latency": self.push_latency.summary(),
                    "pull_latency": self.pull_latency.summary()}


class TrainStepPhases:
    """Per-phase timing of the parameter-server training loop: compute,
    d2h, encode and push each get a ``train/<phase>`` span in ``tracer``
    (default the process tracer), a ``train_step_phase_ms{phase=}``
    histogram child and a running total; ``wall`` records whole steps
    (``train_step_wall_ms``). In overlap mode encode and push run on the
    comms worker while the training thread computes the next step, so the
    wall time falls below the sum of the phases; :meth:`hidden_share` is
    the share of d2h + encode + push that the wall time did not pay."""

    PHASES = ("compute", "d2h", "encode", "push")

    def __init__(self, tracer=None, overlap: bool = False):
        reg = get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.overlap = bool(overlap)
        self._reg_hist = {p: reg.histogram(
            "train_step_phase_ms",
            "paramserver training hot-loop phase latency", phase=p)
            for p in self.PHASES}
        self._reg_wall = reg.histogram(
            "train_step_wall_ms", "paramserver training wall time per step")
        reg.gauge(
            "train_overlap_active",
            "1 while the latency-hiding comms pipeline is on"
        ).set(1.0 if overlap else 0.0)
        self._lock = threading.Lock()
        self.hist = {p: LatencyHistogram() for p in self.PHASES}
        self.totals_ms = {p: 0.0 for p in self.PHASES}
        self.wall_hist = LatencyHistogram()
        self.wall_total_ms = 0.0

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with self.tracer.span(f"train/{name}", cat="train"):
            yield
        ms = (time.perf_counter() - t0) * 1e3
        self._reg_hist[name].observe(ms)
        with self._lock:
            self.hist[name].record(ms)
            self.totals_ms[name] += ms

    def wall(self, ms: float):
        self._reg_wall.observe(ms)
        with self._lock:
            self.wall_hist.record(ms)
            self.wall_total_ms += float(ms)

    def hidden_share(self) -> float:
        """(sum of the phases - wall) / (d2h + encode + push), clipped to
        [0, 1]; 0 before any comms time was recorded."""
        with self._lock:
            comms = sum(self.totals_ms[p] for p in ("d2h", "encode", "push"))
            total = sum(self.totals_ms.values())
            wall = self.wall_total_ms
        if comms <= 0.0:
            return 0.0
        return min(max((total - wall) / comms, 0.0), 1.0)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"phases": {p: h.summary() for p, h in self.hist.items()},
                    "totals_ms": dict(self.totals_ms),
                    "wall": self.wall_hist.summary(),
                    "wall_total_ms": self.wall_total_ms}


class ParamServerMetricsListener(TrainingListener):
    """Listener-bus bridge: every ``frequency`` iterations, a snapshot of a
    client's metrics goes into ``rows`` and the deltas (pushes, pulls, wire
    bytes, retries, staleness skips) into the log."""

    def __init__(self, client, frequency: int = 10):
        self.client = client
        self.frequency = max(1, frequency)
        self.rows: List[Dict[str, object]] = []
        self._prev: Dict[str, int] = {}

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency != 0:
            return
        snap = self.client.metrics.snapshot()
        snap["iteration"] = iteration
        self.rows.append(snap)
        cur = snap["counters"]
        delta = {k: cur[k] - self._prev.get(k, 0) for k in COUNTERS}
        self._prev = dict(cur)
        log.info("paramserver @%d: +%d push / +%d pull, +%dB out / +%dB in, "
                 "%d retries, %d staleness skips", iteration, delta["pushes"],
                 delta["pulls"], delta["push_bytes"], delta["pull_bytes"],
                 delta["retries"], delta["staleness_hits"])
