"""Metric history: a bounded ring of timestamped registry snapshots.

Counterpart of ``deeplearning4j_tpu/monitor/history.py``. A bounded deque
of ``(wall-clock t, MetricsRegistry.dump())`` samples, taken by a
background sampler thread (interval ``DL4J_TPU_HISTORY_INTERVAL``, default
2 s; capacity ``DL4J_TPU_HISTORY_SIZE``, default 512), and the
window/rate/delta/quantile readers that ``GET /history`` and the
``trends`` block of ``GET /profile`` read.

Windowed histogram quantiles subtract the bucket counts of the oldest
in-window sample from the newest, so a quantile describes only the samples
recorded inside the window. Units ride the dump's per-family ``unit``
field.

The sampler is opt-in: nothing starts it implicitly, ``start()`` is
idempotent and ``stop()`` joins the thread. Each tick also runs the
registered listeners.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .lockwatch import make_lock
from .registry import LatencyHistogram, get_registry

log = logging.getLogger(__name__)

__all__ = ["MetricsHistory", "get_history"]

#: background sampler cadence (seconds); the alert engine's hold-down and
#: burn-rate windows quantize to it
DEFAULT_INTERVAL_S = float(os.environ.get("DL4J_TPU_HISTORY_INTERVAL", "2"))

#: ring capacity (samples); oldest evicted first
DEFAULT_CAPACITY = int(os.environ.get("DL4J_TPU_HISTORY_SIZE", "512"))


def _match(row_labels: Dict[str, str], labels: Optional[Dict[str, str]]
           ) -> bool:
    """True when every requested label matches the child's (subset match —
    ``labels=None`` matches every child of the family)."""
    if not labels:
        return True
    return all(row_labels.get(k) == str(v) for k, v in labels.items())


class MetricsHistory:
    """Bounded ring of ``(t, dump)`` samples + windowed readers.

    All readers tolerate an empty or too-short ring by returning ``None``
    — an alert rule evaluated before two samples exist simply does not
    breach, it never crashes the sampler.
    """

    def __init__(self, capacity: Optional[int] = None,
                 interval_s: Optional[float] = None, registry=None):
        self.capacity = int(capacity or DEFAULT_CAPACITY)
        self.interval_s = float(interval_s or DEFAULT_INTERVAL_S)
        self._registry = registry
        self._lock = make_lock("MetricsHistory._lock")
        self._ring: deque = deque(maxlen=self.capacity)
        self._listeners: List[Callable[["MetricsHistory"], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ sampling
    def sample(self, now: Optional[float] = None) -> float:
        """Take one snapshot NOW (the sampler's tick; also the test seam —
        tests drive time explicitly instead of sleeping). Returns the
        sample's timestamp."""
        reg = self._registry if self._registry is not None else get_registry()
        dump = reg.dump()         # registry lock NOT held under ours
        t = float(now) if now is not None else time.time()
        with self._lock:
            self._ring.append((t, dump))
        return t

    def add_listener(self, fn: Callable[["MetricsHistory"], None]):
        """``fn(history)`` runs after every sampler tick (the alert
        engine's evaluation hook). Listener errors are logged, never
        fatal — a broken rule must not kill the sampler."""
        with self._lock:
            self._listeners.append(fn)

    def _tick(self):
        self.sample()
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(self)
            except Exception:
                log.exception("metrics-history listener %r failed", fn)

    def start(self, interval_s: Optional[float] = None) -> "MetricsHistory":
        """Start the background sampler (idempotent). The thread is a
        daemon AND joined by :meth:`stop` — tier-1's THR002 discipline."""
        if interval_s is not None:
            self.interval_s = float(interval_s)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="metrics-history-sampler",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        # first sample immediately: an alert engine attached at start
        # should see data after one interval, not two
        self._tick()
        while not self._stop.wait(self.interval_s):
            self._tick()

    def stop(self, timeout: float = 5.0):
        with self._lock:
            thread, self._thread = self._thread, None
            if thread is not None:
                # set the event INSIDE the lock: a concurrent start()
                # serializes behind us and clears it for ITS thread —
                # setting after release could kill the freshly started
                # sampler on its first wait()
                self._stop.set()
        if thread is not None:
            thread.join(timeout)

    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    # ------------------------------------------------------------- reading
    def samples(self) -> List[Tuple[float, dict]]:
        with self._lock:
            return list(self._ring)

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()

    def window(self, seconds: float, now: Optional[float] = None
               ) -> List[Tuple[float, dict]]:
        """Samples no older than ``seconds`` (oldest first)."""
        now = float(now) if now is not None else time.time()
        cut = now - float(seconds)
        return [(t, d) for t, d in self.samples() if t >= cut]

    def covers(self, seconds: float, now: Optional[float] = None,
               tolerance_s: Optional[float] = None) -> bool:
        """True when the in-window samples actually SPAN the window (the
        oldest one sits within ``tolerance_s`` — default a quarter-window
        — of the far edge). Windowed math over an uncovered window
        silently describes a shorter span: a 30s-old ring would make a
        5-minute burn-rate window equal to the 30s one, and the
        multi-window SLO protection would degenerate to a single window
        (monitor/alerts.py guards every window with this)."""
        win = self.window(seconds, now=now)
        if len(win) < 2:
            return False
        tol = (float(tolerance_s) if tolerance_s is not None
               else 0.25 * float(seconds))
        return (win[-1][0] - win[0][0]) >= float(seconds) - tol

    def at_age(self, age_s: float, now: Optional[float] = None,
               tolerance_s: Optional[float] = None
               ) -> Optional[Tuple[float, dict]]:
        """The sample closest to ``now - age_s`` (None on an empty ring).
        ``tolerance_s`` rejects the match when nothing landed within that
        distance of the target — a 15s-old ring must answer "what was it
        5 minutes ago" with None, not with a 15s-old value silently
        mislabeled as 5-minutes-old (the trends block passes one)."""
        now = float(now) if now is not None else time.time()
        target = now - float(age_s)
        best = None
        for t, d in self.samples():
            if best is None or abs(t - target) < abs(best[0] - target):
                best = (t, d)
        if best is not None and tolerance_s is not None \
                and abs(best[0] - target) > float(tolerance_s):
            return None
        return best

    # ------------------------------------------------------- scalar math
    @staticmethod
    def value_of(dump: dict, metric: str,
                 labels: Optional[Dict[str, str]] = None,
                 agg: str = "sum") -> Optional[float]:
        """Aggregate of a dump family's matching scalar children (None
        when the family or a matching child is absent). ``agg="sum"``
        (counters, totals), ``"max"`` (the worst single child — e.g.
        "any one model's queue near ITS cap", where a sum across models
        would compare apples to one model's cap) or ``"min"`` (the
        weakest child — e.g. "any scrape target down" reads min of
        ``fleet_target_up`` across targets)."""
        fam = dump.get(metric)
        if not fam:
            return None
        vals = [row["value"] for row in fam.get("children", [])
                if "value" in row and _match(row.get("labels", {}), labels)]
        if not vals:
            return None
        if agg == "max":
            return float(max(vals))
        if agg == "min":
            return float(min(vals))
        return float(sum(vals))

    def current(self, metric: str,
                labels: Optional[Dict[str, str]] = None,
                agg: str = "sum") -> Optional[float]:
        """The newest sample's value (scrape-lag at most one interval)."""
        samples = self.samples()
        return (self.value_of(samples[-1][1], metric, labels, agg=agg)
                if samples else None)

    def delta(self, metric: str, seconds: float,
              labels: Optional[Dict[str, str]] = None,
              now: Optional[float] = None) -> Optional[float]:
        """newest − oldest-in-window for a counter family (None without at
        least two in-window samples). Missing-then-present families read
        as growth from 0 — a counter that first increments mid-window."""
        win = self.window(seconds, now=now)
        if len(win) < 2:
            return None
        v1 = self.value_of(win[-1][1], metric, labels)
        if v1 is None:
            return None
        v0 = self.value_of(win[0][1], metric, labels) or 0.0
        return v1 - v0

    def rate(self, metric: str, seconds: float,
             labels: Optional[Dict[str, str]] = None,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second increase of a counter over the trailing window
        (one ring pass — delta and dt come from the same slice)."""
        win = self.window(seconds, now=now)
        if len(win) < 2:
            return None
        dt = win[-1][0] - win[0][0]
        if dt <= 0:
            return None
        v1 = self.value_of(win[-1][1], metric, labels)
        if v1 is None:
            return None
        v0 = self.value_of(win[0][1], metric, labels) or 0.0
        return (v1 - v0) / dt

    def max_over(self, metric: str, seconds: float,
                 labels: Optional[Dict[str, str]] = None,
                 now: Optional[float] = None,
                 agg: str = "sum") -> Optional[float]:
        """Max of a gauge across the in-window samples."""
        vals = [self.value_of(d, metric, labels, agg=agg)
                for _, d in self.window(seconds, now=now)]
        vals = [v for v in vals if v is not None]
        return max(vals) if vals else None

    # ---------------------------------------------------- histogram math
    @staticmethod
    def _hist_state(dump: dict, metric: str,
                    labels: Optional[Dict[str, str]]
                    ) -> Optional[Tuple[List[int], float, str]]:
        """Merged (bucket counts, count, unit) of matching histogram
        children in one dump."""
        fam = dump.get(metric)
        if not fam or fam.get("type") != "histogram":
            return None
        counts = None
        n = 0.0
        for row in fam.get("children", []):
            if "buckets" not in row or not _match(row.get("labels", {}),
                                                 labels):
                continue
            if counts is None:
                counts = [0] * len(row["buckets"])
            for i, c in enumerate(row["buckets"]):
                counts[i] += c
            n += row.get("count", 0)
        if counts is None:
            return None
        return counts, n, fam.get("unit") or "ms"

    def quantile_over(self, metric: str, q: float, seconds: float,
                      labels: Optional[Dict[str, str]] = None,
                      now: Optional[float] = None) -> Optional[float]:
        """The q-quantile of ONLY the histogram samples recorded inside
        the trailing window, from bucket-count deltas (newest − oldest
        in-window) — bucket-upper-edge resolution, in the family's unit.
        None without two in-window samples or with zero in-window
        recordings (an idle histogram has no windowed p99, which alert
        rules treat as "no breach")."""
        win = self.window(seconds, now=now)
        if len(win) < 2:
            return None
        newest = self._hist_state(win[-1][1], metric, labels)
        if newest is None:
            return None
        counts1, n1, unit = newest
        oldest = self._hist_state(win[0][1], metric, labels)
        counts0, n0 = (oldest[0], oldest[1]) if oldest else \
            ([0] * len(counts1), 0.0)
        d_counts = [max(c1 - c0, 0) for c1, c0 in zip(counts1, counts0)]
        d_n = n1 - n0
        if d_n <= 0:
            return None
        edges = LatencyHistogram.bucket_edges(unit)
        rank = q * (d_n - 1)
        seen = 0
        for b, c in enumerate(d_counts):
            seen += c
            if seen > rank:
                return edges[b]
        return edges[-1]

    # ------------------------------------------------------- HTTP payload
    def describe(self) -> Dict[str, object]:
        """The ``GET /history`` default payload: ring meta + family names
        (series are fetched one at a time with ``?metric=``)."""
        samples = self.samples()
        return {
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "samples": len(samples),
            "running": self.running(),
            "oldest_t": samples[0][0] if samples else None,
            "newest_t": samples[-1][0] if samples else None,
            "metrics": sorted(samples[-1][1]) if samples else [],
        }

    def series(self, metric: str, seconds: Optional[float] = None,
               labels: Optional[Dict[str, str]] = None
               ) -> Dict[str, object]:
        """One metric's time series for ``GET /history?metric=``: scalars
        as ``{"t", "value"}`` points (summed across matching children),
        histograms as ``{"t", "count", "sum"}``."""
        samples = (self.window(seconds) if seconds is not None
                   else self.samples())
        points = []
        for t, dump in samples:
            fam = dump.get(metric)
            if not fam:
                continue
            if fam.get("type") == "histogram":
                st = self._hist_state(dump, metric, labels)
                if st is not None:
                    counts, n, _unit = st
                    total = sum(row.get("sum", 0.0)
                                for row in fam.get("children", [])
                                if _match(row.get("labels", {}), labels))
                    points.append({"t": t, "count": n, "sum": total})
            else:
                v = self.value_of(dump, metric, labels)
                if v is not None:
                    points.append({"t": t, "value": v})
        fam = samples[-1][1].get(metric) if samples else None
        return {"metric": metric,
                "type": fam.get("type") if fam else None,
                "unit": fam.get("unit") if fam else None,
                "points": points}


#: the process-global history the sampler/alert engine/endpoints share —
#: created eagerly (cheap: no thread until start())
_HISTORY = MetricsHistory()


def get_history() -> MetricsHistory:
    return _HISTORY
