"""Parameter-server observability: per-op counters and latency histograms.

Counterpart of ``deeplearning4j_tpu/paramserver/metrics.py``. The JAX
package mirrors every increment into its process-wide metrics registry and
every phase into its tracer (the monitor planes, ROADMAP A 17); until the
port has those, the numbers live on these objects: a
:class:`ParamServerMetrics` per client and per server (``snapshot()``, the
``OP_STATS`` shape), and a :class:`TrainStepPhases` per training master
(each phase's histogram and running total). :class:`LatencyHistogram` is
the port's own copy of the JAX registry's log2-bucketed histogram, without
exemplars. :class:`ParamServerMetricsListener` surfaces a client's numbers
on the training listener bus.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, List

from ..optimize.listeners import TrainingListener

__all__ = ["LatencyHistogram", "COUNTERS", "ParamServerMetrics",
           "ParamServerMetricsListener", "TrainStepPhases"]

log = logging.getLogger(__name__)

#: counter names every metrics object carries (a fixed schema)
COUNTERS = ("pushes", "pulls", "push_bytes", "pull_bytes", "retries",
            "staleness_hits", "errors")

_UNIT_BASE = {"ms": 0.1, "s": 1e-4}


class LatencyHistogram:
    """Log2-bucketed latency histogram: bucket b covers ``[base * 2^b,
    base * 2^(b+1))`` with base 0.1 ms (``unit="ms"``) or 1e-4 s
    (``unit="s"``); the mean is exact, p50/p95/p99 are the upper edges of
    their buckets (capped at the largest sample)."""

    N_BUCKETS = 24

    def __init__(self, unit: str = "ms"):
        if unit not in _UNIT_BASE:
            raise ValueError(f"unit must be one of {sorted(_UNIT_BASE)}, got {unit!r}")
        self.unit = unit
        self._base = _UNIT_BASE[unit]
        self.counts = [0] * self.N_BUCKETS
        self.total_ms = 0.0      # in self.unit
        self.n = 0
        self.max_ms = 0.0        # in self.unit

    def _bucket(self, value: float) -> int:
        b = 0
        edge = self._base
        while value >= edge * 2 and b < self.N_BUCKETS - 1:
            edge *= 2
            b += 1
        return b

    def record(self, ms: float):
        ms = max(float(ms), 0.0)
        self.counts[self._bucket(ms)] += 1
        self.total_ms += ms
        self.n += 1
        self.max_ms = max(self.max_ms, ms)

    @classmethod
    def bucket_edges(cls, unit: str = "ms") -> List[float]:
        base = _UNIT_BASE[unit]
        return [base * (2 ** (b + 1)) for b in range(cls.N_BUCKETS)]

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile sample."""
        if not self.n:
            return 0.0
        rank = q * (self.n - 1)
        seen = 0
        edge = self._base
        for c in self.counts:
            seen += c
            if seen > rank:
                return min(edge * 2, self.max_ms) if c else edge * 2
            edge *= 2
        return self.max_ms

    def summary(self) -> Dict[str, float]:
        if not self.n:
            return {}
        u = self.unit
        return {f"mean_{u}": self.total_ms / self.n,
                f"p50_{u}": self.quantile(0.50),
                f"p95_{u}": self.quantile(0.95),
                f"p99_{u}": self.quantile(0.99),
                f"max_{u}": self.max_ms, "n": float(self.n)}


class ParamServerMetrics:
    """Thread-safe counters and push/pull latency histograms of one
    :class:`~.server.ParameterServer` (ops served, ``role="server"``) or
    :class:`~.client.ParameterServerClient` (ops issued, retries, staleness
    skips, ``role="client"``)."""

    def __init__(self, role: str = "client"):
        self.role = str(role)
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {k: 0 for k in COUNTERS}
        self.push_latency = LatencyHistogram()
        self.pull_latency = LatencyHistogram()

    def add(self, counter: str, value: int = 1):
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0) + value

    def record_push(self, ms: float, nbytes: int):
        with self._lock:
            self.counters["pushes"] += 1
            self.counters["push_bytes"] += int(nbytes)
            self.push_latency.record(ms)

    def record_pull(self, ms: float, nbytes: int):
        with self._lock:
            self.counters["pulls"] += 1
            self.counters["pull_bytes"] += int(nbytes)
            self.pull_latency.record(ms)

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time copy: counters and histogram summaries."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "push_latency": self.push_latency.summary(),
                    "pull_latency": self.pull_latency.summary()}


class TrainStepPhases:
    """Per-phase timing of the parameter-server training loop: compute,
    d2h, encode and push each get a histogram and a running total, and
    ``wall`` records whole steps. In overlap mode encode and push run on
    the comms worker while the training thread computes the next step, so
    the wall time falls below the sum of the phases; :meth:`hidden_share`
    is the share of d2h + encode + push that the wall time did not pay."""

    PHASES = ("compute", "d2h", "encode", "push")

    def __init__(self, overlap: bool = False):
        self.overlap = bool(overlap)
        self._lock = threading.Lock()
        self.hist = {p: LatencyHistogram() for p in self.PHASES}
        self.totals_ms = {p: 0.0 for p in self.PHASES}
        self.wall_hist = LatencyHistogram()
        self.wall_total_ms = 0.0

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.hist[name].record(ms)
            self.totals_ms[name] += ms

    def wall(self, ms: float):
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
