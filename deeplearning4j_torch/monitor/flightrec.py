"""Crash flight recorder: bounded structured event log → JSONL dump.

Counterpart of ``deeplearning4j_tpu/monitor/flightrec.py``, with its event
kinds and fields. Metrics say *how much*, traces say *how long*; this log
says *what happened*: worker join/leave/rejoin (the parameter-server
training master), retry-budget exhaustion (the client), shard servers going
down and coming back (the sharded fleet), peer failures (the transport),
health problems and halts (``monitor/health.py``), lock-order inversions
and long holds (``monitor/lockwatch.py``). The buffer is bounded and
thread-safe, so recording is safe from hot paths and serve loops.

It reaches disk as JSONL (one JSON object a line) when
``TrainingHealthListener`` halts a fit (``HealthState.record_halt``), from
the crash hook (installed on first :func:`get_flight_recorder` use, it
dumps and then delegates to the previous ``sys.excepthook``), or through
:meth:`FlightRecorder.dump`. ``DL4J_TPU_FLIGHT_DIR`` picks the dump
directory (default: the system temp dir).
"""
from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

__all__ = ["FlightRecorder", "get_flight_recorder", "install_crash_hook"]


class FlightRecorder:
    """Bounded, thread-safe structured event log.

    Each record is ``{"t": wall-clock seconds, "seq": monotonic sequence
    number, "event": kind, ...fields}``. ``seq`` survives into dumps so
    event ORDER is provable even when two events land within clock
    resolution (the join/leave/rejoin assertions depend on it). The newest
    ``capacity`` events win; evictions are counted (``dropped``), never
    silent.
    """

    def __init__(self, capacity: int = 4096,
                 dump_dir: Optional[str] = None):
        from .lockwatch import make_lock
        self._lock = make_lock("FlightRecorder._lock")
        self._events = deque(maxlen=int(capacity))
        self._seq = 0
        self.dropped = 0
        self.dump_dir = dump_dir
        self.last_dump_path: Optional[str] = None

    def record(self, event: str, **fields) -> Dict[str, object]:
        """Append one structured event; returns the stored record. Fields
        must be JSON-serializable scalars (enforced at dump time, not here
        — recording must never raise into a training loop)."""
        rec = {"t": time.time(), "event": str(event), **fields}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(rec)
        return rec

    def events(self) -> List[Dict[str, object]]:
        with self._lock:
            return [dict(e) for e in self._events]

    def clear(self):
        with self._lock:
            self._events.clear()

    def __len__(self):
        with self._lock:
            return len(self._events)

    # ------------------------------------------------------------- dumping
    def _default_path(self) -> str:
        base = (self.dump_dir
                or os.environ.get("DL4J_TPU_FLIGHT_DIR")
                or tempfile.gettempdir())
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        return os.path.join(base, f"flightrec-{os.getpid()}-{stamp}.jsonl")

    def dump(self, path: Optional[str] = None, reason: str = "explicit"
             ) -> Optional[str]:
        """Write the buffer to ``path`` (default: a timestamped file in the
        dump dir) as JSONL and return the path — or None when the write
        failed (a dying process must never die harder because its black
        box had no disk). Non-serializable field values degrade to repr."""
        path = path or self._default_path()
        events = self.events()
        try:
            with open(path, "w") as fh:
                for rec in events:
                    fh.write(json.dumps(rec, default=repr) + "\n")
        except OSError as e:
            log.warning("flight-recorder dump to %s failed: %s", path, e)
            return None
        self.last_dump_path = path
        log.info("flight recorder: %d event(s) dumped to %s (%s)",
                 len(events), path, reason)
        return path


#: the process-global recorder every subsystem feeds
_RECORDER = FlightRecorder()
_HOOK_INSTALLED = False
_HOOK_LOCK = threading.Lock()


def install_crash_hook():
    """Chain a ``sys.excepthook`` that dumps the flight recorder before
    delegating to the previous hook — the 'process crashes' dump path.
    Idempotent; keeps whatever hook was installed before (pytest, IPython,
    user hooks) fully functional."""
    global _HOOK_INSTALLED
    with _HOOK_LOCK:
        if _HOOK_INSTALLED:
            return
        prev = sys.excepthook

        def _dump_and_delegate(exc_type, exc, tb):
            _RECORDER.record("crash", error=repr(exc),
                             error_type=exc_type.__name__)
            _RECORDER.dump(reason="uncaught exception")
            prev(exc_type, exc, tb)

        sys.excepthook = _dump_and_delegate
        _HOOK_INSTALLED = True


def get_flight_recorder() -> FlightRecorder:
    """The process-global :class:`FlightRecorder`. First use arms the
    crash-dump excepthook so an uncaught exception leaves a JSONL black
    box behind."""
    install_crash_hook()
    return _RECORDER
