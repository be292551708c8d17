"""Training health: the process-wide liveness state and the watchdog
listener.

Counterpart of the training half of ``deeplearning4j_tpu/monitor/health.py``:

- :class:`HealthState` (:func:`get_health`): the last iteration and its age,
  the last score, a NaN latch, the halt, the recent problems and the
  parameter-server connection (``record_ps_ok``/``record_ps_error``, fed
  by ``paramserver/client.py``; a spent retry budget makes the process
  unhealthy until a request succeeds), under ``make_lock("HealthState._lock")``.
  Both containers' fit loops feed ``record_iteration`` through
  ``monitor.record_training_iteration`` on every minibatch while the
  monitor is on (the default) or listeners are set, and clear the halt
  when ``fit`` starts. A problem is also a ``health_problem`` flight event;
  a halt is a ``halt`` event and dumps the flight recorder to disk.
  ``snapshot()`` reads it all and folds in the fleet's liveness table
  (``monitor/fleet.py``) when workers have reported, as the JAX
  ``/healthz`` does.
- :class:`TrainingHealthListener`: a listener-bus watchdog for a NaN/Inf
  score (and, opt-in, parameters), divergence and stalls, with the actions
  ``warn``, ``raise`` (:class:`TrainingHealthError`) and ``halt`` (sets
  ``model.halt_requested``; the fit loops stop at the next minibatch).

With ``watch_retrace`` (the default) the listener drains jitwatch's
retrace storms (``monitor/jitwatch.py``) each iteration and applies its
action to those of its own fit thread that fired after it was made. A
halt also flushes an open incident as an ``aborted`` bundle when the
incident recorder (``monitor/incidents.py``) was ever imported.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from ..optimize.listeners import TrainingListener
from .lockwatch import make_lock

log = logging.getLogger(__name__)

__all__ = ["HealthState", "get_health", "TrainingHealthListener", "TrainingHealthError"]


class TrainingHealthError(RuntimeError):
    """Raised by :class:`TrainingHealthListener` under ``action="raise"``;
    ``kind`` is ``"nan"``, ``"divergence"`` or ``"stall"``."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


class HealthState:
    """Thread-safe process-wide liveness snapshot. Times are wall-clock;
    the iteration's age is computed when the snapshot is taken, so a
    stalled process reports a growing age."""

    def __init__(self):
        self._lock = make_lock("HealthState._lock")
        self.reset()

    def reset(self):
        with self._lock:
            self._last_iteration_time: Optional[float] = None
            self._last_iteration: Optional[int] = None
            self._last_score: Optional[float] = None
            self._nan = False
            self._halted: Optional[str] = None
            self._problems: List[str] = []
            self._ps_ops = 0
            self._ps_errors = 0
            self._ps_last_error: Optional[str] = None
            self._ps_connected: Optional[bool] = None

    def record_iteration(self, iteration: int, score: float):
        with self._lock:
            self._last_iteration_time = time.time()
            self._last_iteration = int(iteration)
            self._last_score = float(score)
            if not math.isfinite(float(score)):
                self._nan = True

    def record_problem(self, kind: str, message: str):
        with self._lock:
            if kind == "nan":
                self._nan = True
            self._problems.append(f"{kind}: {message}")
            del self._problems[:-8]  # keep the newest few
        from .flightrec import get_flight_recorder
        get_flight_recorder().record("health_problem", kind=kind,
                                     message=message)

    def record_halt(self, reason: str):
        with self._lock:
            self._halted = reason
        # training stops on purpose: persist the event history now, while
        # the process can still write it
        from .flightrec import get_flight_recorder
        fr = get_flight_recorder()
        fr.record("halt", reason=reason)
        fr.dump(reason="training halt")
        # a halt mid-incident leaves the incident's evidence on disk too,
        # but only where the incident plane was imported: a bare process
        # pays nothing, and the flush never makes the halt fail
        import sys
        inc = sys.modules.get("deeplearning4j_torch.monitor.incidents")
        if inc is not None:
            try:
                inc.abort_open_incidents(reason=f"halt: {reason}")
            except Exception:
                log.exception("incident flush on halt failed")

    def clear_halt(self):
        """A new ``fit`` supersedes an earlier halt."""
        with self._lock:
            self._halted = None

    def record_ps_ok(self):
        """A parameter-server request answered (``paramserver/client.py``)."""
        with self._lock:
            self._ps_ops += 1
            self._ps_connected = True

    def record_ps_error(self, message: str):
        """A parameter-server request spent its retry budget."""
        with self._lock:
            self._ps_errors += 1
            self._ps_last_error = str(message)
            self._ps_connected = False

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            age = (None if self._last_iteration_time is None
                   else time.time() - self._last_iteration_time)
            healthy = (not self._nan and self._halted is None
                       and self._ps_connected is not False)
            out = {"status": "ok" if healthy else "unhealthy", "healthy": healthy,
                   "last_iteration": self._last_iteration, "last_iteration_age_s": age,
                   "last_score": self._last_score, "nan": self._nan,
                   "halted": self._halted, "problems": list(self._problems),
                   "paramserver": {"connected": self._ps_connected, "ops": self._ps_ops,
                                   "errors": self._ps_errors,
                                   "last_error": self._ps_last_error}}
        # fleet liveness, outside the lock (the fleet table has its own):
        # stale workers are listed but do not flip this process unhealthy
        from .fleet import get_fleet
        fleet = get_fleet().liveness()
        if fleet["workers"]:
            out["fleet"] = fleet
        return out


_HEALTH = HealthState()


def get_health() -> HealthState:
    return _HEALTH


class TrainingHealthListener(TrainingListener):
    """Listener-bus training watchdog. Per iteration:

    - **NaN/Inf score**, always; with ``check_params_every=N > 0`` also a
      scan of the parameters for non-finite values every N iterations
      (opt-in: it reads every parameter on the host);
    - **divergence**: a score above ``divergence_factor`` times the best of
      the last ``divergence_window`` once the window is full (positive
      scores only);
    - **stall**: more than ``stall_timeout`` seconds since the previous
      ``iteration_done``.

    ``action``: ``"warn"`` logs and records the problem in
    :func:`get_health`; ``"raise"`` raises :class:`TrainingHealthError`;
    ``"halt"`` sets ``model.halt_requested`` and the health state's halt.
    Every trigger is appended to ``triggered`` as ``(kind, iteration,
    message)``. With ``watch_retrace`` a retrace storm of a monitored
    function (jitwatch's detector already recorded the problem and the
    ``retrace_storm`` flight event) is acted on as ``"retrace"``; storms of
    other fit threads are requeued for their own listeners, and storms
    older than the listener are ignored."""

    ACTIONS = ("warn", "raise", "halt")

    def __init__(self, action: str = "warn", divergence_window: int = 10,
                 divergence_factor: float = 2.0, stall_timeout: Optional[float] = None,
                 check_params_every: int = 0, watch_retrace: bool = True):
        if action not in self.ACTIONS:
            raise ValueError(f"action must be one of {self.ACTIONS}, got {action!r}")
        self.action = action
        self.divergence_window = max(2, int(divergence_window))
        self.divergence_factor = float(divergence_factor)
        self.stall_timeout = stall_timeout
        self.check_params_every = int(check_params_every)
        self.watch_retrace = bool(watch_retrace)
        self._armed_at = time.time()
        self.triggered: List[Tuple[str, int, str]] = []
        self._scores = deque(maxlen=self.divergence_window)
        self._last_time: Optional[float] = None

    def _fire(self, model, kind: str, iteration: int, message: str, record: bool = True):
        self.triggered.append((kind, iteration, message))
        if record:      # a storm arrives recorded by the detector
            get_health().record_problem(kind, message)
        if self.action == "raise":
            raise TrainingHealthError(kind, message)
        if self.action == "halt":
            get_health().record_halt(message)
            try:
                model.halt_requested = True
            except AttributeError:
                pass  # a read-only model: the health state's halt is still set
            log.warning("TrainingHealthListener HALT: %s", message)
        else:
            log.warning("TrainingHealthListener: %s", message)

    @staticmethod
    def _params_nonfinite(model) -> bool:
        params = getattr(model, "params", None) or {}
        return any(not bool(torch.isfinite(t).all())
                   for ps in params.values() for t in ps.values())

    def _drain_retrace(self, model, iteration):
        from .jitwatch import get_jit_registry
        reg = get_jit_registry()
        storms = reg.drain_storms()
        if not storms:
            return
        me = threading.get_ident()
        foreign = [s for s in storms if s.get("thread") not in (None, me)]
        reg.requeue_storms(foreign)
        for storm in storms:
            if storm in foreign or storm.get("t", 0) < self._armed_at:
                continue
            self._fire(model, "retrace", iteration, storm["message"], record=False)

    def iteration_done(self, model, iteration, score):
        if self.watch_retrace:
            self._drain_retrace(model, iteration)
        now = time.perf_counter()
        if (self.stall_timeout is not None and self._last_time is not None
                and now - self._last_time > self.stall_timeout):
            self._fire(model, "stall", iteration,
                       f"iteration {iteration} arrived {now - self._last_time:.1f}s after "
                       f"the previous one (stall_timeout={self.stall_timeout}s)")
        self._last_time = now

        score = float(score)
        if not math.isfinite(score):
            self._fire(model, "nan", iteration,
                       f"non-finite score {score} at iteration {iteration}")
            return  # divergence is meaningless on a NaN stream
        if (self.check_params_every > 0 and iteration % self.check_params_every == 0
                and self._params_nonfinite(model)):
            self._fire(model, "nan", iteration,
                       f"non-finite parameter values at iteration {iteration}")
            return
        if (len(self._scores) == self._scores.maxlen and min(self._scores) > 0.0
                and score > self.divergence_factor * min(self._scores)):
            self._fire(model, "divergence", iteration,
                       f"score {score:.6g} at iteration {iteration} exceeds "
                       f"{self.divergence_factor}x the best of the last "
                       f"{self.divergence_window} iterations ({min(self._scores):.6g})")
        self._scores.append(score)
