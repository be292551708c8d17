"""Process-global metrics registry: labeled counters, gauges, histograms.

Counterpart of ``deeplearning4j_tpu/monitor/registry.py``, line for line:
the same family names, label sets, bucket geometry and Prometheus text
exposition 0.0.4, so the same sequence of operations renders the same
bytes in both packages and a dump written by either re-renders in the
other (``render_prometheus_dump``). One thread-safe
:class:`MetricsRegistry` per process (:func:`get_registry`) holds metric
*families* (name + type + help) with labeled children; every subsystem of
the port that the JAX package instruments (the fit loops, the transport,
the input pipeline, the parameter server and its sharded fleet) writes
here.

:class:`LatencyHistogram` is the log2-bucketed fixed-memory histogram
``paramserver/metrics.py`` re-exports.

Handles are cheap and cached: ``REGISTRY.counter("x_total", peer="0")``
returns the same :class:`Counter` child every time, so hot paths can either
hold the handle or re-look it up per call.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

#: first bucket's upper-edge base per unit: the same log2 geometry either
#: way, expressed in the series' own unit — ms series resolve from 0.1 ms,
#: seconds series from 1e-4 s (also 0.1 ms), so sub-100ms seconds-valued
#: samples land in real buckets instead of all collapsing into bucket 0
#: (why seconds-valued series take ``unit="s"``)
_UNIT_BASE = {"ms": 0.1, "s": 1e-4}

#: how many worst-bucket exemplars a histogram latches (newest-worst win)
MAX_EXEMPLARS = 8

#: exemplars older than this stop counting as "recent" and are evicted at
#: the next latch/read — without a TTL, 8 multi-second cold-start compiles
#: would squat the latch forever and a genuine p99 breach hours later
#: would surface an hours-old trace id the tracer ring evicted long ago
EXEMPLAR_TTL_S = 600.0


class LatencyHistogram:
    """Log2-bucketed latency histogram (0.1 ms granularity floor): O(1)
    memory regardless of op count, with mean exact and p50/p95 read from the
    bucket upper edges — the shape ``StepTimerListener.summary()`` reports,
    without retaining every sample.

    ``unit`` picks the bucket geometry: ``"ms"`` (default — bucket b covers
    ``[0.1·2^b, 0.1·2^(b+1))`` ms) or ``"s"`` (same geometry from 1e-4 s,
    for seconds-valued series like ``lock_wait_seconds``). Summary keys
    carry the unit (``mean_ms``/``p95_ms`` vs ``mean_s``/``p95_s``) so a
    reader can never mistake one for the other.

    ``record(value, exemplar=...)`` optionally latches an **exemplar** (an
    opaque string — in this stack, a trace id) for the worst recent
    samples: the histogram keeps the ``MAX_EXEMPLARS`` largest-valued
    exemplared samples, so a firing latency alert can surface a concrete
    trace id resolvable against ``GET /trace`` (monitor/alerts.py)."""

    #: 24 log2 buckets reach ~28 min from a 0.1 ms floor
    N_BUCKETS = 24

    def __init__(self, unit: str = "ms",
                 exemplar_ttl_s: float = EXEMPLAR_TTL_S):
        if unit not in _UNIT_BASE:
            raise ValueError(f"unit must be one of {sorted(_UNIT_BASE)}, "
                             f"got {unit!r}")
        self.unit = unit
        self._base = _UNIT_BASE[unit]
        self.counts = [0] * self.N_BUCKETS
        self.total_ms = 0.0      # in self.unit (name predates unit="s")
        self.n = 0
        self.max_ms = 0.0        # in self.unit
        self.exemplar_ttl_s = float(exemplar_ttl_s)
        self.exemplars: deque = deque(maxlen=MAX_EXEMPLARS)

    def _bucket(self, value: float) -> int:
        b = 0
        edge = self._base
        while value >= edge * 2 and b < self.N_BUCKETS - 1:
            edge *= 2
            b += 1
        return b

    def record(self, ms: float, exemplar: Optional[str] = None):
        ms = max(float(ms), 0.0)
        self.counts[self._bucket(ms)] += 1
        self.total_ms += ms
        self.n += 1
        self.max_ms = max(self.max_ms, ms)
        if exemplar is not None:
            self._latch_exemplar(ms, exemplar)

    def _expire_exemplars(self, now: float):
        alive = [e for e in self.exemplars
                 if now - e["t"] <= self.exemplar_ttl_s]
        if len(alive) != len(self.exemplars):
            self.exemplars.clear()
            self.exemplars.extend(alive)

    def _latch_exemplar(self, value: float, exemplar: str):
        """Keep the largest-valued RECENT exemplared samples: expired
        entries (older than ``exemplar_ttl_s``) are evicted first, then
        append while there is room, else displace the smallest kept value
        when this one beats it (ties keep the newer sample — recency
        matters for alert forensics)."""
        now = time.monotonic()
        self._expire_exemplars(now)
        entry = {"value": value, "exemplar": str(exemplar), "t": now}
        if len(self.exemplars) < self.exemplars.maxlen:
            self.exemplars.append(entry)
            return
        worst_i, worst_v = 0, None
        for i, e in enumerate(self.exemplars):
            if worst_v is None or e["value"] < worst_v:
                worst_i, worst_v = i, e["value"]
        if value >= worst_v:
            del self.exemplars[worst_i]
            self.exemplars.append(entry)

    def worst_exemplar(self) -> Optional[Dict[str, object]]:
        """The exemplar of the largest RECENT latched sample (None when no
        unexpired sample carried one) — what a firing latency alert
        surfaces. Expiry applies at read time too, so a long-idle
        histogram never hands an alert a trace id the tracer ring evicted
        long ago."""
        self._expire_exemplars(time.monotonic())
        worst = None
        for e in self.exemplars:
            if worst is None or e["value"] > worst["value"]:
                worst = e
        return dict(worst) if worst else None

    @classmethod
    def bucket_edges(cls, unit: str = "ms") -> List[float]:
        """Upper edge of every bucket in the given unit — the Prometheus
        ``le`` values (ms for ms-series, seconds for ``unit="s"``)."""
        base = _UNIT_BASE[unit]
        return [base * (2 ** (b + 1)) for b in range(cls.N_BUCKETS)]

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile sample."""
        if not self.n:
            return 0.0
        rank = q * (self.n - 1)
        seen = 0
        edge = self._base
        for b, c in enumerate(self.counts):
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
                # tail latency is the serving tier's SLO currency
                # (docs/SERVING.md); bucket-edge resolution like p50/p95
                f"p99_{u}": self.quantile(0.99),
                f"max_{u}": self.max_ms, "n": float(self.n)}


class Counter:
    """Monotonic counter child. ``inc`` only — decreasing is a bug the
    registry refuses to express (use a Gauge)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, value: float = 1.0):
        if value < 0:
            raise ValueError(f"counter increments must be >= 0, got {value}")
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Settable instantaneous value child."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0):
        with self._lock:
            self._value += value

    def dec(self, value: float = 1.0):
        self.inc(-value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Thread-safe wrapper over :class:`LatencyHistogram` (samples in the
    family's unit — ms by default, seconds for ``unit="s"`` families)."""

    __slots__ = ("_lock", "_hist")

    def __init__(self, unit: str = "ms"):
        self._lock = threading.Lock()
        self._hist = LatencyHistogram(unit=unit)

    def observe(self, ms: float, exemplar: Optional[str] = None):
        with self._lock:
            self._hist.record(ms, exemplar=exemplar)

    record = observe

    @property
    def unit(self) -> str:
        return self._hist.unit

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return self._hist.summary()

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._hist.quantile(q)

    def worst_exemplar(self) -> Optional[Dict[str, object]]:
        with self._lock:
            return self._hist.worst_exemplar()

    def retarget_unit(self, unit: str) -> bool:
        """Swap in a fresh histogram on the new unit geometry — only
        while EMPTY (the registry's claim-the-unit seam for families a
        read-path lookup created first). Cached handles stay valid: the
        wrapper is the handle, only its inner histogram is replaced.
        Returns False when samples were already recorded."""
        with self._lock:
            if self._hist.n:
                return self._hist.unit == unit
            if self._hist.unit != unit:
                self._hist = LatencyHistogram(unit=unit)
            return True

    def state(self) -> Tuple[List[int], float, int]:
        """(bucket counts, value sum, n) snapshot for rendering — the sum
        is in the family's unit."""
        with self._lock:
            return list(self._hist.counts), self._hist.total_ms, self._hist.n


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One metric name: type, help text, unit (histograms), and labeled
    children."""

    def __init__(self, name: str, mtype: str, help_text: str,
                 unit: Optional[str] = None):
        self.name = name
        self.type = mtype
        self.help = help_text
        #: bucket geometry (histogram families only). None = no creator
        #: has claimed a unit yet (a read-path lookup created the family)
        #: — renders as ms, and the FIRST explicit unit= claims it.
        self.unit = unit
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    # integral values render without a trailing .0 (Prometheus style)
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class MetricsRegistry:
    """Thread-safe registry of metric families with labeled children.

    ``counter``/``gauge``/``histogram`` create-or-return a child; re-using a
    name with a different type raises (one name, one meaning). ``snapshot``
    gives a point-in-time dict for programmatic use; ``render_prometheus``
    the text exposition ``GET /metrics`` serves.
    """

    def __init__(self):
        # PLAIN lock by necessity, never lockwatch-instrumented: the
        # registry is lockwatch's own data plane — recording any lock's
        # first acquisition creates its metric children THROUGH this
        # lock, so instrumenting it here re-enters a non-reentrant lock
        # (a hard deadlock under DL4J_TPU_LOCKWATCH=1). Its regions are
        # tiny dict ops.
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _child(self, mtype: str, name: str, help_text: str,
               labels: Dict[str, str], unit: Optional[str] = None):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, mtype, help_text,
                                                     unit=unit)
            elif fam.type != mtype:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.type}, "
                    f"cannot re-register as {mtype}")
            elif unit is not None and fam.unit is None:
                # a read-path lookup created the family before its
                # creator ran (tests peeking at state(), /profile
                # readers): the FIRST explicit unit claims it, re-gearing
                # any reader-created children — which must still be empty
                # (samples recorded under the wrong geometry cannot be
                # migrated, so that is a real error at the recorder)
                for child in fam.children.values():
                    if not child.retarget_unit(unit):
                        raise ValueError(
                            f"histogram {name!r} recorded samples before "
                            f"any creator claimed unit={unit!r} — create "
                            f"it with the unit before recording")
                fam.unit = unit
            elif unit is not None and fam.unit != unit:
                # one name, one bucket geometry: mixing units under one
                # family would render le= edges that lie for half the
                # children (unit=None means "whatever the family uses")
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    f"unit={fam.unit!r}, cannot re-register as {unit!r}")
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = (
                    Histogram(unit=fam.unit or "ms")
                    if mtype == "histogram" else _TYPES[mtype]())
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  unit: Optional[str] = None, **labels) -> Histogram:
        """``unit`` picks the bucket geometry: ``"ms"`` (default) or
        ``"s"`` for seconds-valued series (``*_seconds`` names), whose quantiles would otherwise
        saturate below 100 ms on ms geometry."""
        return self._child("histogram", name, help, labels, unit=unit)

    # ------------------------------------------------------------ export
    def dump(self) -> Dict[str, dict]:
        """Full JSON-serializable state: every family with type/help and
        every child with its exact value — histograms keep their bucket
        counts (not just the summary), so a dump can be re-rendered as
        Prometheus text elsewhere. This is the wire form workers ship to
        the parameter server over ``OP_TELEMETRY`` for the fleet view
        (``GET /fleet`` re-renders dumps with a ``worker`` label via
        :func:`render_prometheus_dump`)."""
        with self._lock:
            fams = [(f.name, f.type, f.help, f.unit,
                     list(f.children.items()))
                    for f in self._families.values()]
        out: Dict[str, dict] = {}
        for name, mtype, help_text, unit, children in fams:
            rows = []
            for key, child in children:
                row = {"labels": dict(key)}
                if mtype == "histogram":
                    counts, total_ms, n = child.state()
                    row["buckets"] = counts
                    row["sum"] = total_ms
                    row["count"] = n
                else:
                    row["value"] = child.value
                rows.append(row)
            fam_out = {"type": mtype, "help": help_text, "children": rows}
            if mtype == "histogram":
                fam_out["unit"] = unit or "ms"   # le= edges depend on it;
                                                 # old wire dumps without
                                                 # it are ms
            out[name] = fam_out
        return out

    def snapshot(self) -> Dict[str, List[dict]]:
        """{name: [{"labels": {...}, "type": ..., "value"|"summary"}, ...]}"""
        with self._lock:
            fams = {n: (f.type, list(f.children.items()))
                    for n, f in self._families.items()}
        out: Dict[str, List[dict]] = {}
        for name, (mtype, children) in sorted(fams.items()):
            rows = []
            for key, child in children:
                row = {"labels": dict(key), "type": mtype}
                if mtype == "histogram":
                    row["summary"] = child.summary()
                else:
                    row["value"] = child.value
                rows.append(row)
            out[name] = rows
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4. Histograms render
        with their log2 bucket upper edges as ``le`` in the family's own
        unit — ms for ``_ms``-suffixed series, seconds for ``unit="s"``
        families (``*_seconds`` names) — plus ``_sum``/``_count``."""
        return render_prometheus_dump(self.dump())

    def clear(self):
        """Drop every family (tests / process reuse)."""
        with self._lock:
            self._families.clear()


def render_prometheus_dump(dump: Dict[str, dict],
                           extra_labels: Optional[Dict[str, str]] = None
                           ) -> str:
    """Render a :meth:`MetricsRegistry.dump` (possibly one that crossed the
    wire as JSON) as Prometheus text exposition 0.0.4. ``extra_labels`` are
    merged into every child — the fleet view re-renders each worker's dump
    with ``{"worker": id}`` so N processes' series coexist in one scrape.
    Local ``render_prometheus`` is this function over the local dump, so
    the two text forms cannot diverge."""
    extra = dict(extra_labels or {})
    lines: List[str] = []
    for name in sorted(dump):
        fam = dump[name]
        mtype, help_text = fam["type"], fam.get("help", "")
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        edges = LatencyHistogram.bucket_edges(fam.get("unit") or "ms")
        children = sorted(fam["children"],
                          key=lambda row: _label_key({**row["labels"],
                                                      **extra}))
        for row in children:
            key = _label_key({**row["labels"], **extra})
            labels = _fmt_labels(key)
            if mtype == "histogram":
                counts, total_ms, n = row["buckets"], row["sum"], row["count"]
                cum = 0
                for edge, c in zip(edges, counts):
                    cum += c
                    le = _fmt_labels(key, f'le="{edge:g}"')
                    lines.append(f"{name}_bucket{le} {cum}")
                inf = _fmt_labels(key, 'le="+Inf"')
                lines.append(f"{name}_bucket{inf} {n}")
                lines.append(f"{name}_sum{labels} {_fmt_value(total_ms)}")
                lines.append(f"{name}_count{labels} {n}")
            else:
                lines.append(f"{name}{labels} {_fmt_value(row['value'])}")
    return "\n".join(lines) + "\n"


#: the process-global registry every subsystem writes to
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
