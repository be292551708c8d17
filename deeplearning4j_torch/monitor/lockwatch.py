"""lockwatch: runtime lock-order sanitizer and contention observability.

Counterpart of ``deeplearning4j_tpu/monitor/lockwatch.py``. Opt in with
``DL4J_TPU_LOCKWATCH=1`` (or :func:`set_enabled` before the lock owners are
constructed) and every lock created through :func:`make_lock` /
:func:`make_rlock` / :func:`make_condition` becomes an
:class:`InstrumentedLock` that records, per acquisition:

- **the per-thread held stack** (with the acquiring source site), from
  which the process-global **observed order graph** is kept: an edge
  ``A -> B`` means some thread acquired ``B`` while holding ``A``. The
  first edge that closes a cycle is a **lock-order inversion** and fires a
  ``lock_order_inversion`` flight-recorder event plus a health problem,
  carrying both witness sites.
- **hold time**: a lock held longer than ``DL4J_TPU_LOCKWATCH_HOLD_S``
  (default 5 s) fires a ``lock_hold_exceeded`` flight event and a health
  problem naming the acquisition site. ``Condition.wait`` releases the
  lock for the duration of the wait, so parked waiters never count.
- **metrics**: ``lock_acquisitions_total{lock=}``,
  ``lock_wait_seconds{lock=}`` and ``lock_held_seconds{lock=}`` in the
  registry (``unit="s"`` histograms), rolled up by
  :func:`contention_table`.

Disabled (the default), the factories return plain ``threading``
primitives. Lock names are the JAX package's ``ClassName.attr`` /
``module.GLOBAL`` identities, which its static lock-graph analysis reads.
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

log = logging.getLogger(__name__)

__all__ = ["enabled", "set_enabled", "make_lock", "make_rlock",
           "make_condition", "InstrumentedLock", "LockWatch",
           "get_lockwatch", "contention_table", "HOLD_THRESHOLD_S"]

_ENABLED = os.environ.get("DL4J_TPU_LOCKWATCH", "0") not in ("0", "false",
                                                             "")

#: held longer than this (seconds) fires lock_hold_exceeded; generous by
#: default — the point is catching a blocking call under a lock, not a
#: slow scheduler tick on a loaded CI box
HOLD_THRESHOLD_S = float(os.environ.get("DL4J_TPU_LOCKWATCH_HOLD_S", "5.0"))


def enabled() -> bool:
    return _ENABLED


def set_enabled(value: bool):
    """Programmatic opt-in (tests / embedding code). Only affects locks
    created AFTER the call — module-global locks built at import time stay
    plain unless ``DL4J_TPU_LOCKWATCH=1`` was set before the import."""
    global _ENABLED
    _ENABLED = bool(value)


def _acquire_site() -> str:
    """file.py:line of the frame that asked for the lock — skipping this
    module and threading.py (Condition internals re-acquire through us)."""
    f = sys._getframe(1)
    here = os.path.basename(__file__)
    while f is not None:
        base = os.path.basename(f.f_code.co_filename)
        if base not in (here, "threading.py"):
            return f"{base}:{f.f_lineno}"
        f = f.f_back
    return "?"


class _Held:
    """One entry on a thread's held stack."""

    __slots__ = ("name", "obj", "site", "t0", "depth")

    def __init__(self, name: str, obj, site: str, t0: float):
        self.name = name
        self.obj = obj
        self.site = site
        self.t0 = t0
        self.depth = 1


class _LockStats:
    __slots__ = ("n", "wait_total", "wait_max", "held_total", "held_max")

    def __init__(self):
        self.n = 0
        self.wait_total = 0.0
        self.wait_max = 0.0
        self.held_total = 0.0
        self.held_max = 0.0


class LockWatch:
    """Process-global observed-order graph + contention aggregates.

    All bookkeeping runs under ONE plain (uninstrumented) lock and a
    thread-local busy flag suppresses re-entrant instrumentation, so the
    watcher can never deadlock with the locks it watches — an instrumented
    lock acquired while the watcher is firing its own events is simply not
    recorded.
    """

    def __init__(self):
        self._lock = threading.Lock()          # plain by construction
        self._local = threading.local()
        self._edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._adj: Dict[str, Set[str]] = {}
        self._stats: Dict[str, _LockStats] = {}
        self._inversions: List[Dict[str, Any]] = []
        self._hold_events: List[Dict[str, Any]] = []
        self._fired_cycles: Set[frozenset] = set()
        self._handles: Dict[str, tuple] = {}

    # ------------------------------------------------------------ plumbing
    def _held(self) -> List[_Held]:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []
        return held

    def _busy(self) -> bool:
        return getattr(self._local, "busy", False)

    def _metric_handles(self, name: str):
        with self._lock:
            h = self._handles.get(name)
        if h is not None:
            return h
        from .registry import get_registry
        reg = get_registry()
        h = (reg.counter("lock_acquisitions_total",
                         "lock acquisitions by instrumented locks",
                         lock=name),
             reg.histogram("lock_wait_seconds",
                           "blocking wait to acquire an instrumented "
                           "lock (seconds)", unit="s", lock=name),
             reg.histogram("lock_held_seconds",
                           "time an instrumented lock stayed held "
                           "(seconds)", unit="s", lock=name))
        with self._lock:
            self._handles.setdefault(name, h)
        return h

    # ----------------------------------------------------------- recording
    def note_acquire(self, name: str, obj, wait_s: float, site: str,
                     depth: int = 1):
        if self._busy():
            return
        self._local.busy = True
        try:
            held = self._held()
            for h in reversed(held):
                if h.obj is obj:               # reentrant (RLock)
                    h.depth += 1
                    self._record_wait(name, wait_s)
                    return
            entry = _Held(name, obj, site, time.perf_counter())
            entry.depth = max(1, int(depth))
            outer = [h for h in held if h.name != name]
            held.append(entry)
            self._record_wait(name, wait_s)
            if outer:
                self._note_edges(outer, name, site)
        finally:
            self._local.busy = False

    def note_release(self, name: str, obj) -> int:
        """Pop ``obj`` from the held stack (depth-aware); returns the
        remaining reentrancy depth (0 = fully released)."""
        if self._busy():
            return 0
        self._local.busy = True
        try:
            held = self._held()
            for i in range(len(held) - 1, -1, -1):
                h = held[i]
                if h.obj is obj:
                    if h.depth > 1:
                        h.depth -= 1
                        return h.depth
                    del held[i]
                    self._record_held(name, h,
                                      time.perf_counter() - h.t0)
                    return 0
            return 0
        finally:
            self._local.busy = False

    def note_release_all(self, name: str, obj) -> int:
        """Fully release a (possibly reentrant) hold — the
        ``Condition.wait`` seam (``_release_save``). Returns the depth that
        was held, for :meth:`note_acquire` to restore."""
        if self._busy():
            return 1
        self._local.busy = True
        try:
            held = self._held()
            for i in range(len(held) - 1, -1, -1):
                h = held[i]
                if h.obj is obj:
                    del held[i]
                    self._record_held(name, h,
                                      time.perf_counter() - h.t0)
                    return h.depth
            return 1
        finally:
            self._local.busy = False

    def _record_wait(self, name: str, wait_s: float):
        acq_c, wait_h, _ = self._metric_handles(name)
        acq_c.inc()
        wait_h.observe(wait_s)
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _LockStats()
            st.n += 1
            st.wait_total += wait_s
            st.wait_max = max(st.wait_max, wait_s)

    def _record_held(self, name: str, entry: _Held, held_s: float):
        _, _, held_h = self._metric_handles(name)
        held_h.observe(held_s)
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _LockStats()
            st.held_total += held_s
            st.held_max = max(st.held_max, held_s)
        if held_s > HOLD_THRESHOLD_S:
            info = {"t": time.time(), "lock": name, "site": entry.site,
                    "held_s": round(held_s, 3),
                    "threshold_s": HOLD_THRESHOLD_S}
            with self._lock:
                self._hold_events.append(info)
                del self._hold_events[:-64]
            self._fire("lock_hold_exceeded", "lock_hold",
                       f"lock {name!r} (acquired at {entry.site}) held for "
                       f"{held_s:.3f}s > {HOLD_THRESHOLD_S:.1f}s — "
                       f"something slow ran under it (THR001/THR004 at "
                       f"runtime)", info)

    # ---------------------------------------------------------- order graph
    def _note_edges(self, outer: List[_Held], name: str, site: str):
        firings = []
        with self._lock:
            for h in outer:
                key = (h.name, name)
                if key in self._edges:
                    self._edges[key]["count"] += 1
                    continue
                self._edges[key] = {
                    "count": 1,
                    "witness": f"{h.name} at {h.site} -> {name} at {site}",
                }
                self._adj.setdefault(h.name, set()).add(name)
                back = self._find_path(name, h.name)
                if back is None:
                    continue
                cycle = frozenset([h.name, name] + back)
                if cycle in self._fired_cycles:
                    continue
                self._fired_cycles.add(cycle)
                fwd = self._edges[key]["witness"]
                rev = " ; ".join(
                    self._edges[(a, b)]["witness"]
                    for a, b in zip([name] + back, back))
                info = {"t": time.time(), "locks": sorted(cycle),
                        "path_forward": fwd, "path_reverse": rev}
                self._inversions.append(info)
                firings.append((
                    "lock_order_inversion", "lock_order_inversion",
                    f"lock-order inversion between "
                    f"{' and '.join(sorted(cycle))}: one thread took "
                    f"[{fwd}] while the observed graph already holds "
                    f"[{rev}] — under contention these interleavings "
                    f"deadlock; pick one canonical order "
                    f"(docs/STATIC_ANALYSIS.md THR003 runbook)", info))
        for event, kind, msg, info in firings:
            self._fire(event, kind, msg, info)

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS in the observed graph: a path src -> ... -> dst (list of
        hops AFTER src, ending in dst), or None. Caller holds _lock."""
        stack = [(src, [])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._adj.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _fire(self, event: str, kind: str, msg: str, info: Dict[str, Any]):
        """Flight event + health problem (busy flag is already set, so the
        instrumented locks inside flightrec/health are not re-recorded)."""
        log.warning("lockwatch: %s", msg)
        try:
            from .flightrec import get_flight_recorder
            get_flight_recorder().record(event, **{
                k: v for k, v in info.items() if k != "t"})
            from .health import get_health
            get_health().record_problem(kind, msg)
        except Exception as e:
            log.debug("lockwatch: event fan-out failed: %r", e)

    # ------------------------------------------------------------- reading
    def observed_edges(self) -> Set[Tuple[str, str]]:
        """The runtime-observed held->acquired order graph — what
        ``tests/test_lockwatch.py`` cross-checks against the static
        analyzer's edge set."""
        with self._lock:
            return set(self._edges)

    def edge_witnesses(self) -> Dict[Tuple[str, str], str]:
        with self._lock:
            return {k: dict(v)["witness"] for k, v in self._edges.items()}

    def observed_locks(self) -> Set[str]:
        """Every lock name this watch has seen acquired — the runtime
        acquisition census. ``tests/test_lockwatch.py`` pins the dual of
        the edge cross-check against it: every guard the racegraph
        *infers* (THR005) must name a lock the instrumented flows
        actually acquire (inferred ⊆ observed), so guard inference can't
        silently drift off the real locking behavior."""
        with self._lock:
            return set(self._stats)

    def inversions(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(i) for i in self._inversions]

    def hold_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(i) for i in self._hold_events]

    def contention_table(self) -> Dict[str, Dict[str, Any]]:
        """{lock: acquisitions + exact wait/held mean/max} — the ``locks``
        block of ``GET /profile``."""
        with self._lock:
            stats = {n: (s.n, s.wait_total, s.wait_max, s.held_total,
                         s.held_max) for n, s in self._stats.items()}
            inv = len(self._inversions)
            handles_by_name = dict(self._handles)
        out: Dict[str, Dict[str, Any]] = {}
        for name in sorted(stats):
            n, wt, wm, ht, hm = stats[name]
            out[name] = {
                "acquisitions": n,
                "wait_s_mean": round(wt / n, 6) if n else 0.0,
                "wait_s_max": round(wm, 6),
                "held_s_mean": round(ht / n, 6) if n else 0.0,
                "held_s_max": round(hm, 6),
            }
            # honest bucket quantiles from the unit="s" registry
            # histogram (mean/max above stay exact from _LockStats)
            handles = handles_by_name.get(name)
            if handles is not None:
                ws = handles[1].summary()
                if ws:
                    out[name]["wait_s_p95"] = round(ws["p95_s"], 6)
        if out and inv:
            # surfaced at the table level so a renderer can't miss it
            out["_inversions"] = {"count": inv}
        return out

    def clear(self):
        with self._lock:
            self._edges.clear()
            self._adj.clear()
            self._stats.clear()
            self._inversions.clear()
            self._hold_events.clear()
            self._fired_cycles.clear()


_WATCH = LockWatch()


def get_lockwatch() -> LockWatch:
    return _WATCH


def contention_table() -> Dict[str, Dict[str, Any]]:
    return _WATCH.contention_table()


class InstrumentedLock:
    """``threading.Lock``/``RLock`` wrapper feeding :class:`LockWatch`.

    Duck-compatible where this package needs it: ``acquire(blocking,
    timeout)`` / ``release`` / context manager / ``locked``, plus the
    ``_release_save`` / ``_acquire_restore`` / ``_is_owned`` protocol
    ``threading.Condition`` drives — a Condition built over one of these
    (via :func:`make_condition`) releases the tracked hold for the
    duration of every ``wait``.
    """

    def __init__(self, name: str, rlock: bool = False,
                 watch: Optional[LockWatch] = None):
        self.name = str(name)
        self._inner = threading.RLock() if rlock else threading.Lock()
        self._watch = watch if watch is not None else get_lockwatch()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._watch.note_acquire(self.name, self,
                                     time.perf_counter() - t0,
                                     _acquire_site())
        return ok

    def release(self):
        self._watch.note_release(self.name, self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if locked is not None else False

    # ------------------------------------------- Condition.wait protocol
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        depth = self._watch.note_release_all(self.name, self)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save(), depth
        self._inner.release()
        return None, depth

    def _acquire_restore(self, saved):
        state, depth = saved
        t0 = time.perf_counter()
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._watch.note_acquire(self.name, self,
                                 time.perf_counter() - t0,
                                 _acquire_site(), depth=depth)

    def __repr__(self):
        return f"InstrumentedLock({self.name!r})"


# ---------------------------------------------------------------- factory
def make_lock(name: str):
    """A named lock: plain ``threading.Lock`` when lockwatch is off (the
    default — zero overhead), an :class:`InstrumentedLock` when on. The
    name MUST be the stable static identity (``ClassName.attr`` /
    ``module.GLOBAL``) so runtime edges line up with the THR003 analyzer's
    (``analysis/lockgraph.py`` reads these literals)."""
    if not _ENABLED:
        return threading.Lock()
    return InstrumentedLock(name)


def make_rlock(name: str):
    if not _ENABLED:
        return threading.RLock()
    return InstrumentedLock(name, rlock=True)


def make_condition(name: str):
    """A named condition variable. Instrumented mode builds the Condition
    over an :class:`InstrumentedLock` (RLock-backed, preserving the
    default Condition semantics); waits release the tracked hold."""
    if not _ENABLED:
        return threading.Condition()
    return threading.Condition(InstrumentedLock(name, rlock=True))
