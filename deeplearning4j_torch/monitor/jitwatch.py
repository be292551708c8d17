"""jitwatch: first-call and device-memory observability.

Counterpart of ``deeplearning4j_tpu/monitor/jitwatch.py``. The JAX package
wraps every ``jax.jit`` in :func:`monitored_jit` and counts XLA compiles.
The port compiles nothing at run time: its compile step is the ``nvcc``
build of the kernel libraries (``ops/cuda_build.py``), and the cost a new
argument signature pays is its *first call* (library load, cuBLAS/cuDNN
heuristics, allocator growth). So here a **compile** is the first call of
a wrapped function at an argument signature it has not seen, and its wall
time is that call's.

- :func:`monitored_jit` wraps a callable under a stable ``area/fn`` name
  (the JAX package's names: ``mln/step``, ``mln/output``, ``cg/step``,
  ``nlp/hs_step`` ...). Per call it bumps ``jit_calls_total{fn=}`` and
  checks the signature: shape and dtype of every tensor or array leaf of
  the arguments, the type of a Python scalar (JAX traces those as weakly
  typed scalars, no retrace) and the tree structure. A new signature
  counts under ``jit_compiles_total{fn=}`` and ``jit_compile_seconds{fn=}``
  and leaves a ``compile/<name>`` span.
- The **retrace-storm detector**: ``DL4J_TPU_RETRACE_THRESHOLD`` first
  calls of one wrapper within ``DL4J_TPU_RETRACE_WINDOW`` seconds record a
  health problem and a ``retrace_storm`` flight event naming the
  argument-signature delta; ``TrainingHealthListener`` drains
  :meth:`JitRegistry.drain_storms` each iteration for its warn/raise/halt
  action (storms of other fit threads are requeued).
- **Cost capture**: under ``DL4J_TPU_JITWATCH_COST=1`` (read at import),
  a first call runs under a dispatch mode that sums
  ``torch.utils.flop_counter``'s formulas over the aten ops it sees (the
  count ``FlopCounterMode`` and ``utils/profiling.step_cost`` make). The
  hand-written kernels (K1-K7) launch through ctypes, so the dispatcher
  does not see them: their FLOPs are not counted, and each cost row says
  so (``flops_note``). The port's default is ``0``, not the JAX package's
  ``1`` (which re-lowers on a worker thread): here the count runs inside
  the first call, a dispatch mode costs a first call about a quarter more,
  and the tracing stack it needs (``torch._dynamo``, imported before the
  first counted call's clock starts) took 2.5 s to import on a CPU-only
  machine and 13 s on an H100 host, a serving replica's whole cold start.
- With the compile cache on (``compilecache/``), a first call that loaded a
  kernel library from disk rather than building it counts under
  ``jit_persistent_cache_hits_total{fn=}``.
- :func:`sample_device_memory` reads the caching allocator's counters into
  ``device_memory_in_use_bytes{device=}``, ``device_memory_peak_bytes``
  and ``device_live_buffers``; a process that never touched CUDA records
  nothing.
- :func:`profile_report` is ``GET /profile``: the jit table, memory, the
  step/ETL split, input pipeline, parameter-server phases, serving, mesh,
  locks, control and trends blocks; :func:`render_profile_text` its text.

Hot-path cost of a wrapped call: one counter increment, a walk of the
arguments for shapes and dtypes, a set lookup under a lock. With the
monitor switched off (``monitor.set_enabled(False)``,
``DL4J_TPU_MONITOR=0``) a wrapped call goes straight through and records
nothing.
"""
from __future__ import annotations

import functools
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..compilecache.cache import (claim_persistent_hit as _cc_claim_hit,
                                  enabled as _cc_enabled, hits_count as _cc_hits_count)

log = logging.getLogger(__name__)

__all__ = ["monitored_jit", "MonitoredJit", "JitRegistry", "get_jit_registry",
           "sample_device_memory", "maybe_sample_device_memory",
           "profile_report", "render_profile_text", "RETRACE_THRESHOLD", "RETRACE_WINDOW"]

#: first calls of ONE wrapper instance within RETRACE_WINDOW seconds that
#: count as a retrace storm (per instance: many networks each warming
#: their own step once is healthy)
RETRACE_THRESHOLD = int(os.environ.get("DL4J_TPU_RETRACE_THRESHOLD", "3"))
RETRACE_WINDOW = float(os.environ.get("DL4J_TPU_RETRACE_WINDOW", "60"))

#: "1" counts the FLOPs of first calls (off by default: see the module
#: docstring for what the count costs)
_COST_CAPTURE = os.environ.get("DL4J_TPU_JITWATCH_COST", "0") not in ("0", "false", "")

#: said of every cost row: what the dispatcher cannot see
FLOPS_NOTE = ("aten ops only: the hand-written kernels K1-K7 launch through ctypes "
              "and are not counted")


# ------------------------------------------------------------- signatures
def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _leaf_sig(x) -> str:
    """One leaf's identity as the JAX package writes it: ``float32[16,4]``
    for a tensor or array, the repr of anything else."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        try:
            return f"{_dtype_name(dtype)}[{','.join(str(int(d)) for d in shape)}]"
        except (TypeError, ValueError):
            pass
    r = repr(x)
    return r if len(r) <= 40 else r[:37] + "..."


def _flatten(x, path, out):
    """jax.tree_util's flatten with paths over tuples, lists, dicts (keys
    sorted) and None (no leaf); everything else is a leaf, appended to
    ``out`` as (keypath, leaf-sig). Returns the treedef string JAX prints."""
    if x is None:
        return "None"
    if isinstance(x, (tuple, list)):
        parts = [_flatten(v, f"{path}[{i}]", out) for i, v in enumerate(x)]
        if isinstance(x, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    if isinstance(x, dict):
        parts = [f"{k!r}: " + _flatten(x[k], f"{path}[{k!r}]", out) for k in sorted(x)]
        return "{" + ", ".join(parts) + "}"
    out.append((path, _leaf_sig(x)))
    return "*"


def _signature(args, kwargs) -> Tuple[Tuple[Tuple[str, str], ...], str]:
    """((keypath, leaf-sig), ...) and the treedef string, the JAX
    package's ``_signature`` over tensors and arrays."""
    leaves: List[Tuple[str, str]] = []
    tree = _flatten((tuple(args), dict(kwargs)), "", leaves)
    return tuple(leaves), f"PyTreeDef({tree})"


def _call_key(x):
    """The first-call key of an argument tree: its structure with each
    tensor or array as (dtype, shape) and any other leaf as its type (JAX
    traces a Python scalar as a weakly typed value, not a constant)."""
    t = type(x)
    if t is torch.Tensor or isinstance(x, torch.Tensor):
        return (x.dtype, x.shape)
    if x is None:
        return None
    if t is tuple or t is list:
        return (t, *[_call_key(v) for v in x])
    if t is dict:
        return (t, *[(k, _call_key(x[k])) for k in sorted(x)])
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (str(dtype), tuple(shape))
    return t


def _sig_delta(old, new) -> str:
    """Which arguments changed shape or dtype between two signatures."""
    if old is None:
        return "first compile"
    o, n = dict(old[0]), dict(new[0])
    diffs = [f"{k}: {o[k]} -> {n[k]}" for k in n if k in o and o[k] != n[k]]
    added = [k for k in n if k not in o]
    removed = [k for k in o if k not in n]
    if added:
        diffs.append(f"+{len(added)} new leaves ({added[0]}, ...)"
                     if len(added) > 1 else f"new leaf {added[0]}")
    if removed:
        diffs.append(f"-{len(removed)} leaves")
    if not diffs:
        return ("tree structure changed" if old[1] != new[1]
                else "signature unchanged (static-argument retrace)")
    head = "; ".join(diffs[:4])
    if len(diffs) > 4:
        head += f" (+{len(diffs) - 4} more)"
    return head


def sig_key(sig) -> str:
    """The variant key of a signature: ``path=leaf-sig`` joined by ``;``."""
    return ";".join(f"{k}={v}" for k, v in sig[0]) if sig else "?"


# ------------------------------------------------------------- registry
class _FnStats:
    """Per-name aggregate (instances of one named function pool here)."""

    __slots__ = ("name", "compiles", "compile_seconds", "variants", "last_cost",
                 "last_delta", "storms", "persistent_hits")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.compile_seconds = 0.0
        self.variants: Dict[str, Dict[str, Any]] = {}
        self.last_cost: Optional[Dict[str, Any]] = None
        self.last_delta: Optional[str] = None
        self.storms = 0
        self.persistent_hits = 0


class JitRegistry:
    """Process-global table of monitored functions (:meth:`table` is the
    ``/profile`` jit block) and the pending retrace storms
    ``TrainingHealthListener`` drains."""

    def __init__(self):
        from .lockwatch import make_lock
        self._lock = make_lock("JitRegistry._lock")
        self._stats: Dict[str, _FnStats] = {}
        self._pending_storms: List[Dict[str, Any]] = []

    def stats(self, name: str) -> _FnStats:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _FnStats(name)
            return st

    def note_compile(self, name: str, seconds: float, sig_key_: str, delta: str,
                     persistent_hit: bool = False):
        st = self.stats(name)
        with self._lock:
            st.compiles += 1
            st.compile_seconds += seconds
            st.last_delta = delta
            if persistent_hit:
                st.persistent_hits += 1
            var = st.variants.setdefault(sig_key_, {"compiles": 0})
            var["compiles"] += 1
            var["compile_seconds"] = round(var.get("compile_seconds", 0.0) + seconds, 4)

    def note_cost(self, name: str, sig_key_: str, cost: Dict[str, Any]):
        st = self.stats(name)
        with self._lock:
            st.variants.setdefault(sig_key_, {"compiles": 0})["cost"] = cost
            st.last_cost = cost

    def report_storm(self, name: str, count: int, delta: str):
        msg = (f"retrace storm: jit fn {name!r} compiled {count} times within "
               f"{RETRACE_WINDOW:.0f}s — argument-signature churn ({delta}); pad or "
               f"bucket the offending shapes")
        # the thread lets a listener act only on its own fit's storms
        info = {"t": time.time(), "fn": name, "count": count, "window_s": RETRACE_WINDOW,
                "signature_delta": delta, "message": msg, "thread": threading.get_ident()}
        with self._lock:
            self._stats.setdefault(name, _FnStats(name)).storms += 1
            self._pending_storms.append(info)
            del self._pending_storms[:-32]
        log.warning("jitwatch %s", msg)
        from .flightrec import get_flight_recorder
        get_flight_recorder().record("retrace_storm", fn=name, count=count,
                                     window_s=RETRACE_WINDOW, signature_delta=delta)
        from .health import get_health
        get_health().record_problem("retrace", msg)

    def drain_storms(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self._pending_storms = self._pending_storms, []
        return out

    def requeue_storms(self, storms: List[Dict[str, Any]]):
        """Put back storms a listener drained for another fit thread."""
        if not storms:
            return
        with self._lock:
            self._pending_storms.extend(storms)
            del self._pending_storms[:-32]

    def table(self) -> Dict[str, Dict[str, Any]]:
        """{name: {calls, compiles, cache_miss_ratio, compile_seconds,
        variants, storms, persistent_cache_hits, true_compiles, compile_s,
        flops, ...}}."""
        from .registry import get_registry
        snap = get_registry().snapshot()

        def fn_row(metric, name):
            for r in snap.get(metric, []):
                if r["labels"].get("fn") == name:
                    return r
            return None

        with self._lock:
            stats = list(self._stats.items())
        out: Dict[str, Dict[str, Any]] = {}
        for name, st in sorted(stats):
            calls_row = fn_row("jit_calls_total", name)
            calls = int(calls_row["value"]) if calls_row else 0
            row: Dict[str, Any] = {
                "calls": calls, "compiles": st.compiles,
                "cache_miss_ratio": round(st.compiles / calls, 4) if calls else None,
                "compile_seconds": round(st.compile_seconds, 4),
                "variants": len(st.variants), "storms": st.storms,
                "persistent_cache_hits": st.persistent_hits,
                "true_compiles": st.compiles - st.persistent_hits,
            }
            cs_row = fn_row("jit_compile_seconds", name)
            cs = cs_row.get("summary") if cs_row else None
            if cs:
                row["compile_s"] = {k: round(v, 4) for k, v in cs.items()}
            if st.last_cost:
                row.update(st.last_cost)
            if st.last_delta:
                row["last_signature_delta"] = st.last_delta
            out[name] = row
        return out

    def clear(self):
        with self._lock:
            self._stats.clear()
            self._pending_storms.clear()


_JIT_REGISTRY = JitRegistry()


def get_jit_registry() -> JitRegistry:
    return _JIT_REGISTRY


# -------------------------------------------------------------- wrapper
class MonitoredJit:
    """A callable plus the bookkeeping above. Calls pass straight through;
    a call at an unseen signature is a compile (claimed under the lock, so
    threads racing through one new signature count it once)."""

    def __init__(self, fn, name: Optional[str] = None):
        from .lockwatch import make_lock
        self._fn = fn
        self.name = name or getattr(fn, "__qualname__", getattr(fn, "__name__", "jit_fn"))
        self._lock = make_lock("MonitoredJit._lock")
        self.calls = 0
        self.compiles = 0
        self.compile_seconds = 0.0
        self._last_sig = None
        self._seen = set()
        #: the variant keys of this instance's compiles, in order
        self.signatures: List[str] = []
        self._compile_times = deque(maxlen=max(RETRACE_THRESHOLD, 8))
        self._handles = None
        self._phit_handle = None
        functools.update_wrapper(self, fn, updated=())

    def _metric_handles(self):
        if self._handles is None:
            from .registry import get_registry
            reg = get_registry()
            self._handles = (
                reg.counter("jit_calls_total", "calls into monitored jit functions",
                            fn=self.name),
                reg.counter("jit_compiles_total",
                            "first calls at a new argument signature (the port's compiles)",
                            fn=self.name),
                reg.histogram("jit_compile_seconds",
                              "wall-clock seconds of a first call at a new signature",
                              unit="s", fn=self.name),
            )
        return self._handles

    def __call__(self, *args, **kwargs):
        if not _monitor_enabled():
            return self._fn(*args, **kwargs)
        calls_c, compiles_c, hist = self._metric_handles()
        calls_c.inc()
        try:
            key = (_call_key(args), _call_key(kwargs) if kwargs else None)
        except Exception as e:        # observability never fails the call
            log.debug("jitwatch: signature of %s failed: %r", self.name, e)
            key = None
        with self._lock:
            self.calls += 1
            compiled = key not in self._seen
            if compiled:
                self._seen.add(key)
        if not compiled:
            return self._fn(*args, **kwargs)
        phits0 = _cc_hits_count() if _cc_enabled() else None
        flops = _flop_mode() if _COST_CAPTURE else None
        t0 = time.perf_counter()
        if flops is None:
            out = self._fn(*args, **kwargs)
        else:
            with flops:
                out = self._fn(*args, **kwargs)
        dur = time.perf_counter() - t0
        try:
            phit = phits0 is not None and _cc_claim_hit(phits0)
            self._record_compile(args, kwargs, t0, dur, compiles_c, hist, phit, flops)
        except Exception as e:
            log.debug("jitwatch: compile bookkeeping for %s failed: %r", self.name, e)
        return out

    def _record_compile(self, args, kwargs, t0, dur, compiles_c, hist, phit, flops):
        sig = _signature(args, kwargs)
        compiles_c.inc()
        hist.observe(dur)
        if phit:
            if self._phit_handle is None:
                from .registry import get_registry
                self._phit_handle = get_registry().counter(
                    "jit_persistent_cache_hits_total",
                    "first calls whose kernel libraries came from the on-disk cache "
                    "(loads, not nvcc builds)", fn=self.name)
            self._phit_handle.inc()
        key = sig_key(sig)
        now = time.time()
        with self._lock:
            delta = _sig_delta(self._last_sig, sig)
            self.compiles += 1
            self.compile_seconds += dur
            self._last_sig = sig
            self.signatures.append(key)
            self._compile_times.append(now)
            recent = [t for t in self._compile_times if now - t <= RETRACE_WINDOW]
            storm = len(recent) >= RETRACE_THRESHOLD
            if storm:
                self._compile_times.clear()
        from .tracer import get_tracer
        get_tracer().record_complete(f"compile/{self.name}", t0, dur, cat="compile",
                                     fn=self.name, signature_delta=delta)
        reg = get_jit_registry()
        reg.note_compile(self.name, dur, key, delta, persistent_hit=phit)
        if flops is not None:
            reg.note_cost(self.name, key, {"flops": float(flops.get_total_flops()),
                                           "flops_note": FLOPS_NOTE})
        if storm:
            reg.report_storm(self.name, len(recent), delta)

    def __get__(self, obj, objtype=None):
        # a decorated method: one watch for the class, the instance its
        # first argument
        return self if obj is None else functools.partial(self, obj)

    def __deepcopy__(self, memo):
        # a copied network makes its watched functions again at first use
        # (the wrapped callables are bound to the original)
        return None

    @property
    def cache_miss_ratio(self) -> Optional[float]:
        with self._lock:
            return self.compiles / self.calls if self.calls else None

    def __repr__(self):
        return f"MonitoredJit({self.name!r}, calls={self.calls}, compiles={self.compiles})"


_ENABLED_FN = []


def _monitor_enabled() -> bool:
    if not _ENABLED_FN:
        from . import enabled
        _ENABLED_FN.append(enabled)
    return _ENABLED_FN[0]()


def monitored_jit(fn=None, name: Optional[str] = None):
    """Wrap ``fn`` with first-call observability, or a decorator factory
    (``@monitored_jit(name="nlp/hs_step")``). ``name`` labels every
    metric, span and flight event."""
    if fn is None:
        return functools.partial(monitored_jit, name=name)
    return MonitoredJit(fn, name=name)


class _FlopCount(TorchDispatchMode):
    """FLOPs of the aten ops run inside the block, by
    ``torch.utils.flop_counter``'s formulas (forward and backward ops
    alike, as ``FlopCounterMode`` counts them)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None and func._can_decompose():
            # a composite op (matmul under inference_mode): count the ops it
            # decomposes into, which dispatch through this mode again
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if formula is not None:
            self.total += int(formula(*args, **kwargs, out_val=out))
        return out

    def get_total_flops(self) -> int:
        return self.total


def _flop_mode():
    """A FLOP counter for a first call. Imports torch's tracing stack, which
    a dispatch mode needs (seconds, once a process), before the caller
    starts the first call's clock."""
    import torch._dynamo  # noqa: F401
    return _FlopCount()


# --------------------------------------------------------- device memory
def sample_device_memory(registry=None) -> Dict[str, Any]:
    """Sample each card's allocator counters into the gauges; returns the
    same data as a dict. Never raises."""
    out: Dict[str, Any] = {"devices": {}, "live_buffers": None}
    if not torch.cuda.is_initialized():
        return out
    try:
        from .registry import get_registry
        reg = registry if registry is not None else get_registry()
        live = 0
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            dev = f"cuda:{i}"
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", 0))
            reg.gauge("device_memory_in_use_bytes", "device bytes currently allocated",
                      device=dev).set(float(in_use))
            reg.gauge("device_memory_peak_bytes",
                      "peak device bytes over the process lifetime",
                      device=dev).set(float(peak))
            out["devices"][dev] = {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
                                   "bytes_limit": int(torch.cuda.get_device_properties(i)
                                                      .total_memory)}
            live += int(stats.get("active.all.current", 0))
        reg.gauge("device_live_buffers",
                  "active allocations of the caching allocator, all cards").set(float(live))
        out["live_buffers"] = live
    except (RuntimeError, AssertionError) as e:
        log.debug("device memory sample failed: %r", e)
    return out


#: per-step sampling throttle (seconds)
_SAMPLE_INTERVAL = float(os.environ.get("DL4J_TPU_MEMSAMPLE_INTERVAL", "1.0"))
_LAST_SAMPLE = [0.0]


def maybe_sample_device_memory():
    """Throttled :func:`sample_device_memory`: at most one sample per
    ``DL4J_TPU_MEMSAMPLE_INTERVAL`` seconds."""
    now = time.monotonic()
    if now - _LAST_SAMPLE[0] < _SAMPLE_INTERVAL:
        return
    _LAST_SAMPLE[0] = now
    sample_device_memory()


# ----------------------------------------------------------- step anatomy
def _snap_value(snap, metric) -> Optional[float]:
    """Sum of a snapshot family's scalar children (None when absent)."""
    rows = snap.get(metric, [])
    return sum(r.get("value", 0) for r in rows) if rows else None


def _snap_summary(snap, metric) -> Optional[Dict[str, float]]:
    """First child's histogram summary from a snapshot (None when absent)."""
    rows = snap.get(metric, [])
    return rows[0].get("summary") if rows else None


def profile_report() -> Dict[str, Any]:
    """The step-anatomy report (``GET /profile`` / ``monitor --profile``):
    per-fn jit table + device memory + the step/ETL timing split, merged
    from the monitor registry — one view answering "where does a step's
    wall-clock actually go: compute, compile, or ETL?"."""
    from .registry import get_registry
    snap = get_registry().snapshot()

    def value(metric):
        return _snap_value(snap, metric)

    def summary(metric):
        return _snap_summary(snap, metric)

    return {
        "jit": get_jit_registry().table(),
        "memory": sample_device_memory(),
        "steps": {
            "iterations": value("training_iterations_total"),
            "examples": value("training_examples_total"),
            "step_ms": summary("training_step_ms"),
            "etl_ms": summary("training_etl_ms"),
        },
        "pipeline": _pipeline_block(snap),
        "training": _training_block(snap),
        "serving": _serving_block(snap),
        "mesh": _mesh_block(),
        "locks": _locks_block(),
        "control": _control_block(),
        "trends": _trends_block(),
    }


def _mesh_block() -> Dict[str, Any]:
    """Active parallel topologies (parallel/mesh.py registry): per style
    the mesh axis names/extents, device count, steps built, and
    sharded-vs-replicated model-state leaf counts — what topology is this
    process's training/inference actually running on. Read through
    sys.modules so a process that never imported the parallel substrate
    pays nothing (and reports an honest empty block)."""
    import sys as _sys
    mod = _sys.modules.get("deeplearning4j_torch.parallel.mesh")
    if mod is None:
        return {}
    try:
        return mod.mesh_block()
    except Exception as e:      # pragma: no cover - defensive scrape path
        log.debug("jitwatch: mesh block failed: %r", e)
        return {}


def _control_block() -> Dict[str, Any]:
    """Control-plane summary (control/plane.py): policy count, active
    cooldowns, total actions, last action. Read through sys.modules like
    the mesh block — a process that never imported the control plane
    pays nothing and reports an honest empty block."""
    import sys as _sys
    mod = _sys.modules.get("deeplearning4j_torch.control.plane")
    if mod is None:
        return {}
    try:
        return mod.control_block()
    except Exception as e:      # pragma: no cover - defensive scrape path
        log.debug("jitwatch: control block failed: %r", e)
        return {}


#: the trends block's comparison horizons (seconds): "now vs 1m vs 5m"
_TREND_WINDOWS = (60.0, 300.0)


def _trends_block() -> Dict[str, Any]:
    """Now-vs-1m-vs-5m movement of the load-bearing series, read from the
    metric history ring (monitor/history.py). Empty until the history
    sampler has at least two samples — the block answers "is it getting
    WORSE", which a single snapshot cannot. Gauges compare the current
    value against the value at each horizon; counters report the delta
    over each horizon; latency reports the WINDOWED p99 (bucket-count
    deltas — only the samples inside the window); memory peak reports the
    windowed max."""
    from .history import get_history
    hist = get_history()
    if len(hist) < 2:
        return {}

    def tol(w):
        # honesty guard: a value only counts as "w seconds ago" when a
        # sample landed within a quarter-window (or a couple of sampler
        # intervals) of that horizon — a 15s-old ring must answer the
        # 5m question with None, never with a 15s-old value mislabeled
        return max(w * 0.25, 2 * hist.interval_s)

    def covers(w):
        # windowed math only when the window is actually covered (the
        # shared MetricsHistory.covers guard — the alert engine applies
        # the same one to its burn-rate windows)
        return hist.covers(w, tolerance_s=tol(w))

    def ago(metric, w):
        at = hist.at_age(w, tolerance_s=tol(w))
        return hist.value_of(at[1], metric) if at else None

    def gauge_row(metric):
        row = {"now": hist.current(metric)}
        for w in _TREND_WINDOWS:
            row[f"{w:g}s_ago"] = ago(metric, w)
        return row

    def delta_row(metric):
        row = {"total": hist.current(metric)}
        for w in _TREND_WINDOWS:
            row[f"{w:g}s_delta"] = (hist.delta(metric, w)
                                    if covers(w) else None)
        return row

    p99 = {}
    for w in _TREND_WINDOWS:
        p99[f"{w:g}s_p99_ms"] = (hist.quantile_over(
            "serving_request_latency_ms", 0.99, w) if covers(w) else None)
    peak = {"now": hist.current("device_memory_peak_bytes")}
    for w in _TREND_WINDOWS:
        peak[f"{w:g}s_max"] = (hist.max_over("device_memory_peak_bytes", w)
                               if covers(w) else None)
    return {
        "window_s": list(_TREND_WINDOWS),
        "serving_qps": gauge_row("serving_qps"),
        "serving_p99_ms": p99,
        "serving_queue_depth": gauge_row("serving_queue_depth"),
        "jit_compiles": delta_row("jit_compiles_total"),
        "device_memory_peak_bytes": peak,
    }


def _locks_block() -> Dict[str, Any]:
    """Lock-contention table (monitor/lockwatch.py): per instrumented lock
    the acquisition count and exact wait/held mean/max, plus the observed
    inversion count. Empty unless lockwatch is enabled
    (``DL4J_TPU_LOCKWATCH=1``) and instrumented locks actually ran."""
    from .lockwatch import contention_table
    return contention_table()


def _serving_block(snap) -> Dict[str, Any]:
    """Per-model serving anatomy (the serving tier): request
    outcomes, latency summary (p50/p95/p99/max — the serving histograms
    are ms-valued, so bucket quantiles are honest here), trailing-window
    QPS, batch-size distribution (mean real examples per flush — how well
    continuous batching is coalescing), and current queue depth. Built
    purely from the registry snapshot, so the block also renders for a
    remote dump. Empty dict until serving traffic flows."""
    per: Dict[str, Dict[str, Any]] = {}

    def row(model):
        return per.setdefault(model, {})

    for r in snap.get("serving_requests_total", []):
        m = r["labels"].get("model", "?")
        row(m).setdefault("requests", {})[
            r["labels"].get("outcome", "?")] = r.get("value")
    for r in snap.get("serving_request_latency_ms", []):
        m = r["labels"].get("model", "?")
        if r.get("summary"):
            row(m)["latency_ms"] = r["summary"]
    for r in snap.get("serving_batch_examples", []):
        m = r["labels"].get("model", "?")
        s = r.get("summary")
        if s:
            # the histogram stores EXAMPLE COUNTS in its value slots, so
            # mean/max/n are exact; its bucket quantiles are not
            # meaningful for counts and are dropped
            row(m)["batch_examples"] = {"mean": round(s["mean_ms"], 2),
                                        "max": s["max_ms"],
                                        "n": int(s["n"])}
    for fam, key in (("serving_queue_depth", "queue_depth"),
                     ("serving_qps", "qps")):
        for r in snap.get(fam, []):
            row(r["labels"].get("model", "?"))[key] = r.get("value")
    for fam, key in (("serving_pad_ms", "pad_ms"),
                     ("serving_transfer_ms", "transfer_ms")):
        # the flush-time split: batch assembly vs host<->device
        # movement, per flush — read next to latency_ms to see how much
        # of the tail is data plane rather than compute
        for r in snap.get(fam, []):
            if r.get("summary"):
                row(r["labels"].get("model", "?"))[key] = {
                    "mean": round(r["summary"]["mean_ms"], 4),
                    "p99": r["summary"]["p99_ms"],
                    "n": int(r["summary"]["n"])}
    hits: Dict[str, float] = {}
    misses: Dict[str, float] = {}
    for fam, acc in (("serving_cache_hits_total", hits),
                     ("serving_cache_misses_total", misses)):
        for r in snap.get(fam, []):
            acc[r["labels"].get("model", "?")] = r.get("value") or 0.0
    for m in set(hits) | set(misses):
        h, miss = hits.get(m, 0.0), misses.get(m, 0.0)
        row(m)["cache"] = {
            "hits": int(h), "misses": int(miss),
            "hit_rate": (round(h / (h + miss), 4) if h + miss else None)}
    return per


def _training_block(snap) -> Dict[str, Any]:
    """Paramserver hot-loop phase anatomy (paramserver/training.py +
    overlap.py): per-phase latency summaries (compute / d2h / encode /
    push), the wall step time, and whether the latency-hiding comms
    pipeline is on. ``hidden_ms_total`` is Σ phase totals − wall total —
    positive means comms genuinely ran UNDER the compute (real overlap),
    while the sync loop reads at or below zero (phases stack end to
    end). Empty until a paramserver master has stepped."""
    phases: Dict[str, Any] = {}
    phase_total = 0.0
    for r in snap.get("train_step_phase_ms", []):
        s = r.get("summary")
        if not s:
            continue
        phases[r["labels"].get("phase", "?")] = {
            "mean": round(s["mean_ms"], 3), "p95": s["p95_ms"],
            "max": s["max_ms"], "n": int(s["n"])}
        phase_total += s["mean_ms"] * s["n"]
    if not phases:
        return {}
    out: Dict[str, Any] = {"phase_ms": phases,
                           "phase_ms_total": round(phase_total, 3)}
    wall = _snap_summary(snap, "train_step_wall_ms")
    if wall:
        wall_total = wall["mean_ms"] * wall["n"]
        out["wall_ms"] = {"mean": round(wall["mean_ms"], 3),
                          "p95": wall["p95_ms"], "max": wall["max_ms"],
                          "n": int(wall["n"])}
        out["wall_ms_total"] = round(wall_total, 3)
        out["hidden_ms_total"] = round(phase_total - wall_total, 3)
    ov = _snap_value(snap, "train_overlap_active")
    out["overlap_active"] = bool(ov)
    return out


def _pipeline_block(snap) -> Dict[str, Any]:
    """Input-pipeline anatomy (datasets/prefetch.py): queue depth, the
    residual blocking wait, bytes fed, and the compute/ETL overlap split —
    ``etl_fraction`` near 0 means prefetch+put-ahead hid the ETL behind
    device compute; near 1 means the accelerator starves on input."""
    # input_wait_seconds rides the unit="s" bucket geometry, so its
    # p50/p95 are bucket quantiles
    w = _snap_summary(snap, "input_wait_seconds")
    out: Dict[str, Any] = {
        "queue_depth": _snap_value(snap, "input_queue_depth"),
        "batches": _snap_value(snap, "input_batches_total"),
        "bytes_total": _snap_value(snap, "input_bytes_total"),
        "wait_seconds": (None if not w else
                         {"mean_s": round(w["mean_s"], 6),
                          "p50_s": round(w["p50_s"], 6),
                          "p95_s": round(w["p95_s"], 6),
                          "max_s": round(w["max_s"], 6),
                          "n": int(w["n"])}),
    }
    etl = _snap_summary(snap, "training_etl_ms")
    step = _snap_summary(snap, "training_step_ms")
    if etl and step:
        etl_total = etl["mean_ms"] * etl["n"]
        step_total = step["mean_ms"] * step["n"]
        out["etl_ms_total"] = round(etl_total, 3)
        out["step_ms_total"] = round(step_total, 3)
        if etl_total + step_total > 0:
            out["etl_fraction"] = round(
                etl_total / (etl_total + step_total), 4)
    return out


def render_profile_text(report: Dict[str, Any]) -> str:
    """Plain-text rendering of :func:`profile_report` for terminals."""
    lines = ["# jit (per named function)"]
    jit = report.get("jit") or {}
    if jit:
        # disk = persistent_cache_hits (compilecache/): of `compiles`,
        # how many loaded their kernel libraries from the on-disk cache
        lines.append(f"{'fn':<28} {'calls':>8} {'compiles':>8} "
                     f"{'disk':>6} {'miss':>7} {'compile_s':>10} "
                     f"{'gflops':>10} {'peak_mb':>8}")
        for name, r in jit.items():
            miss = r.get("cache_miss_ratio")
            flops = r.get("flops")
            peak = r.get("peak_memory_bytes")
            lines.append(
                f"{name:<28} {r['calls']:>8} {r['compiles']:>8} "
                f"{r.get('persistent_cache_hits', 0):>6} "
                f"{miss if miss is not None else '-':>7} "
                f"{r['compile_seconds']:>10} "
                f"{round(flops / 1e9, 3) if flops else '-':>10} "
                f"{round(peak / 1e6, 1) if peak else '-':>8}")
            if r.get("storms"):
                lines.append(f"  !! {r['storms']} retrace storm(s); last "
                             f"delta: {r.get('last_signature_delta')}")
    else:
        lines.append("(no monitored jit activity yet)")
    lines.append("")
    lines.append("# device memory")
    mem = report.get("memory") or {}
    for dev, row in (mem.get("devices") or {}).items():
        lines.append(f"{dev}: in_use={row.get('bytes_in_use')} "
                     f"peak={row.get('peak_bytes_in_use')} "
                     f"limit={row.get('bytes_limit')}")
    if not mem.get("devices"):
        lines.append("(backend reports no memory stats)")
    lines.append(f"live_buffers: {mem.get('live_buffers')}")
    lines.append("")
    lines.append("# steps")
    steps = report.get("steps") or {}
    lines.append(f"iterations={steps.get('iterations')} "
                 f"examples={steps.get('examples')}")
    for k in ("step_ms", "etl_ms"):
        s = steps.get(k)
        if s:
            lines.append(f"{k}: mean={s.get('mean_ms'):.3f} "
                         f"p50={s.get('p50_ms'):.3f} "
                         f"p95={s.get('p95_ms'):.3f} n={int(s.get('n', 0))}")
    pipe = report.get("pipeline") or {}
    if any(v is not None for v in pipe.values()):
        lines.append("")
        lines.append("# pipeline")
        lines.append(f"queue_depth={pipe.get('queue_depth')} "
                     f"batches={pipe.get('batches')} "
                     f"bytes_total={pipe.get('bytes_total')}")
        w = pipe.get("wait_seconds")
        if w:
            lines.append(f"wait_s: mean={w.get('mean_s'):.4f} "
                         f"p50={w.get('p50_s', 0.0):.4f} "
                         f"p95={w.get('p95_s', 0.0):.4f} "
                         f"max={w.get('max_s'):.4f} n={int(w.get('n', 0))}")
        if pipe.get("etl_fraction") is not None:
            lines.append(f"etl_fraction={pipe['etl_fraction']} "
                         f"(etl {pipe.get('etl_ms_total')} ms / step "
                         f"{pipe.get('step_ms_total')} ms)")
    training = report.get("training") or {}
    if training:
        lines.append("")
        lines.append("# training (paramserver hot-loop phases)")
        lines.append(f"overlap_active={training.get('overlap_active')}")
        for p in ("compute", "d2h", "encode", "push"):
            r = (training.get("phase_ms") or {}).get(p)
            if r:
                lines.append(f"{p}: mean={r['mean']:.3f} "
                             f"p95={r['p95']:.3f} max={r['max']:.3f} "
                             f"n={r['n']}")
        w = training.get("wall_ms")
        if w:
            lines.append(f"wall: mean={w['mean']:.3f} p95={w['p95']:.3f} "
                         f"max={w['max']:.3f} n={w['n']}")
        if training.get("hidden_ms_total") is not None:
            lines.append(f"hidden_ms_total={training['hidden_ms_total']} "
                         f"(sum of phases {training.get('phase_ms_total')}"
                         f" ms - wall {training.get('wall_ms_total')} ms)")
    serving = report.get("serving") or {}
    if serving:
        lines.append("")
        lines.append("# serving (per hosted model)")
        lines.append(f"{'model':<20} {'ok':>8} {'rej':>6} {'dl':>5} "
                     f"{'err':>5} {'qps':>7} {'p50_ms':>8} {'p99_ms':>8} "
                     f"{'batch':>6} {'queue':>6} {'cache':>6} "
                     f"{'pad_ms':>7} {'xfer_ms':>8}")
        for name, r in sorted(serving.items()):
            req = r.get("requests", {})
            lat = r.get("latency_ms") or {}
            bat = r.get("batch_examples") or {}
            cache = r.get("cache") or {}
            rate = cache.get("hit_rate")
            lines.append(
                f"{name:<20} {int(req.get('ok', 0)):>8} "
                f"{int(req.get('rejected', 0)):>6} "
                f"{int(req.get('deadline', 0)):>5} "
                f"{int(req.get('error', 0)):>5} "
                f"{round(r.get('qps', 0.0), 1):>7} "
                f"{round(lat.get('p50_ms', 0.0), 2):>8} "
                f"{round(lat.get('p99_ms', 0.0), 2):>8} "
                f"{round(bat.get('mean', 0.0), 1):>6} "
                f"{int(r.get('queue_depth', 0) or 0):>6} "
                f"{rate if rate is not None else '-':>6} "
                f"{(r.get('pad_ms') or {}).get('mean', '-'):>7} "
                f"{(r.get('transfer_ms') or {}).get('mean', '-'):>8}")
    meshes = report.get("mesh") or {}
    if meshes:
        lines.append("")
        lines.append("# mesh (active parallel topologies)")
        lines.append(f"{'style':<28} {'axes':<28} {'devs':>5} "
                     f"{'steps':>6} {'sharded':>8} {'repl':>6} {'zero':>5}")
        for style, r in meshes.items():
            axes = "×".join(f"{a}={n}" for a, n in
                            (r.get("axes") or {}).items()) or "-"
            lines.append(
                f"{style:<28} {axes:<28} {r.get('devices', 0):>5} "
                f"{r.get('steps', 0):>6} {r.get('sharded_leaves', 0):>8} "
                f"{r.get('replicated_leaves', 0):>6} "
                f"{'yes' if r.get('zero') else 'no':>5}")
    locks = report.get("locks") or {}
    if locks:
        lines.append("")
        lines.append("# locks (lockwatch contention)")
        inv = locks.get("_inversions", {}).get("count")
        if inv:
            lines.append(f"  !! {inv} lock-order inversion(s) observed — "
                         f"see the flight recorder")
        lines.append(f"{'lock':<40} {'acq':>8} {'wait_mean_s':>12} "
                     f"{'wait_max_s':>11} {'held_mean_s':>12} "
                     f"{'held_max_s':>11}")
        for name, r in locks.items():
            if name == "_inversions":
                continue
            lines.append(
                f"{name:<40} {r['acquisitions']:>8} "
                f"{r['wait_s_mean']:>12} {r['wait_s_max']:>11} "
                f"{r['held_s_mean']:>12} {r['held_s_max']:>11}")
    control = report.get("control") or {}
    if control:
        lines.append("")
        lines.append("# control (closed-loop control plane)")
        lines.append(f"policies={control.get('policies', 0)} "
                     f"running={'yes' if control.get('running') else 'no'} "
                     f"cooldowns_active={control.get('cooldowns_active', 0)} "
                     f"pending={control.get('pending', 0)} "
                     f"actions_total={control.get('actions_total', 0)}")
        last = control.get("last_action")
        if last:
            lines.append(f"last_action: policy={last.get('policy')} "
                         f"action={last.get('action')} "
                         f"outcome={last.get('outcome')} "
                         f"rule={last.get('rule')} "
                         f"exemplar={last.get('exemplar_trace_id')}")
    trends = report.get("trends") or {}
    if trends:
        lines.append("")
        lines.append("# trends (now vs 1m/5m — monitor/history.py)")
        for key, row in trends.items():
            if key == "window_s":
                continue
            cells = " ".join(
                f"{k}={round(v, 3) if isinstance(v, float) else v}"
                for k, v in row.items())
            lines.append(f"{key}: {cells}")
    return "\n".join(lines) + "\n"
