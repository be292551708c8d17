"""Host-side span tracer: ring buffer → Chrome trace-event JSON.

Counterpart of ``deeplearning4j_tpu/monitor/tracer.py``: a context-manager/
decorator that records wall-clock spans into a bounded ring buffer (the
newest ``capacity`` win, evictions counted in ``dropped`` and
``tracer_spans_dropped_total``) and exports them as Chrome trace-event JSON
(:meth:`Tracer.export`; open it in Perfetto or ``chrome://tracing``).
Where the JAX tracer nests ``jax.profiler.TraceAnnotation``, every span here
nests ``torch.profiler.record_function`` while a ``torch.profiler`` session
is recording, so a profiled step shows the ``step`` span's range around the
step's kernels. With no profiler active the annotation is skipped (one
check of the profiler's enabled flag a span).

Timing honesty: CUDA launches return before the card finishes, so a span
around a bare launch measures the launch. The fit loops fetch the loss's
value (``float(loss)``, a device-to-host sync) INSIDE the step span for
this reason; spans around other card work must synchronise to mean
anything.

Trace-context propagation: every span carries a ``trace_id`` shared with
its whole causal chain and a fresh ``span_id``; :meth:`Tracer.current_span`
exposes the active :class:`SpanContext` so an RPC layer can ship it to the
peer (the parameter-server client prefixes flagged ops with it), and
``span(parent=ctx)`` lets the receiving side record a child span under the
REMOTE parent, so a merged export shows client push → server apply as one
chain across processes.
"""
from __future__ import annotations

import contextlib
import functools
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch

__all__ = ["SpanContext", "Tracer", "get_tracer", "new_context"]


class SpanContext(NamedTuple):
    """Identity of one span in one trace. IDs are 63-bit ints (JSON-safe,
    16 hex chars on the wire); ``parent_span_id`` is 0 for a root span."""

    trace_id: int
    span_id: int
    parent_span_id: int = 0


def _new_id() -> int:
    # 63 bits: fits JSON/JS number precision limits and struct "<Q"
    return random.getrandbits(63) | 1       # never 0 (0 = "no parent")


def new_context() -> SpanContext:
    """A fresh root :class:`SpanContext` — for subsystems that mint a
    trace identity per unit of work without opening a thread-bound span
    (the serving batcher stamps one per request at submit time so the
    queue-wait and flush spans recorded later can join it)."""
    return SpanContext(_new_id(), _new_id(), 0)


def _annotation(name: str):
    """A ``torch.profiler.record_function`` range while a profiler session
    records, else None: an annotation outside a session would cost a
    dispatcher round trip a span and show nowhere. Resolved per span, so a
    session opened mid-fit annotates from its next span on."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return None
    return torch.profiler.record_function(name)


class Tracer:
    """Bounded ring buffer of completed host spans.

    ``capacity`` bounds memory: the newest ``capacity`` spans win (a
    steady-state training loop keeps the recent window, which is what a
    ``GET /trace`` snapshot wants). Spans on different threads interleave
    naturally — the export carries ``tid`` so Perfetto lays them out per
    thread, and nesting within a thread is reconstructed from ts/dur
    containment.
    """

    def __init__(self, capacity: int = 8192):
        from .lockwatch import make_lock
        self._lock = make_lock("Tracer._lock")
        self._events = deque(maxlen=int(capacity))
        self._t0 = time.perf_counter()
        self._local = threading.local()     # per-thread span-context stack
        self.dropped = 0                    # ring-buffer overflow count

    # ----------------------------------------------------- span contexts
    def _stack(self) -> List[SpanContext]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_span(self) -> Optional[SpanContext]:
        """The innermost open span's context on THIS thread, or None. This
        is what an RPC client ships to the server so the server's handling
        span becomes a child of the in-flight client span."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host",
             parent: Optional[SpanContext] = None, **args):
        """Record one span around the enclosed block; yields the span's
        :class:`SpanContext`. ``args`` become the trace event's ``args``
        (must be JSON-serializable scalars). The trace/parent IDs come from
        the innermost open span on this thread, or from ``parent`` — pass a
        context that arrived over the wire to join a REMOTE trace."""
        ann = _annotation(name)
        if ann is not None:
            ann.__enter__()
        stack = self._stack()
        up = parent if parent is not None else (stack[-1] if stack else None)
        ctx = SpanContext(up.trace_id if up else _new_id(), _new_id(),
                          up.span_id if up else 0)
        stack.append(ctx)
        start = time.perf_counter()
        try:
            yield ctx
        finally:
            dur = time.perf_counter() - start
            stack.pop()
            if ann is not None:
                ann.__exit__(None, None, None)
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": (start - self._t0) * 1e6, "dur": dur * 1e6,
                  "pid": os.getpid(), "tid": threading.get_ident()}
            ev["args"] = {"trace_id": f"{ctx.trace_id:x}",
                          "span_id": f"{ctx.span_id:x}", **args}
            if ctx.parent_span_id:
                ev["args"]["parent_span_id"] = f"{ctx.parent_span_id:x}"
            self._append(ev)

    def record_complete(self, name: str, start: float, dur: float,
                        cat: str = "host",
                        parent: Optional[SpanContext] = None, **args):
        """Record an ALREADY-timed span after the fact — for events only
        detectable at their end (e.g. a jit compile, recognized by the
        cache-size delta once the call returns). ``start`` is the
        ``perf_counter`` value at the event's start, ``dur`` seconds. The
        span is parented under ``parent`` when given (the serving batcher
        parents a request's queue-wait span under the REQUEST's context,
        not the scheduler thread's), else under the innermost OPEN span on
        this thread (a compile detected mid-step nests under the step
        span); either way it does not touch the context stack itself."""
        up = parent if parent is not None else self.current_span()
        ctx = SpanContext(up.trace_id if up else _new_id(), _new_id(),
                          up.span_id if up else 0)
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (start - self._t0) * 1e6, "dur": dur * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident(),
              "args": {"trace_id": f"{ctx.trace_id:x}",
                       "span_id": f"{ctx.span_id:x}", **args}}
        if ctx.parent_span_id:
            ev["args"]["parent_span_id"] = f"{ctx.parent_span_id:x}"
        self._append(ev)

    def _append(self, ev: Dict):
        with self._lock:
            overflow = len(self._events) == self._events.maxlen
            if overflow:
                self.dropped += 1
            self._events.append(ev)
        if overflow:
            # registry write OUTSIDE the ring lock (scrapes take both)
            from .registry import get_registry
            get_registry().counter(
                "tracer_spans_dropped_total",
                "spans evicted from the trace ring buffer").inc()

    def trace(self, name: Optional[str] = None, cat: str = "host"):
        """Decorator form: ``@tracer.trace()`` spans every call."""
        def deco(fn):
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapped(*a, **kw):
                with self.span(span_name, cat=cat):
                    return fn(*a, **kw)
            return wrapped
        return deco

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def export(self) -> Dict:
        """Chrome trace-event JSON object (the ``/trace`` payload): load it
        in Perfetto or ``chrome://tracing`` as-is."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self):
        with self._lock:
            return len(self._events)


#: the process-global tracer the fit loops / transport / PS client write to
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER
