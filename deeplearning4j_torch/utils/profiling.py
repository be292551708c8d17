"""Profiling utilities: traces, step cost and step times.

Counterpart of ``deeplearning4j_tpu/utils/profiling.py``:

- :func:`trace` / :class:`ProfilerListener`: a ``torch.profiler`` trace
  (CPU activities, plus CUDA activities on the card) of a block or of a
  window of training iterations, written as a Chrome trace into
  ``log_dir`` (Perfetto or ``chrome://tracing`` read it).
- :func:`step_cost`: FLOPs and bytes of one loss-and-backward of a
  container's fit step on a DataSet's shapes, the numbers a roofline
  needs: ``torch.utils.flop_counter.FlopCounterMode`` for the FLOPs, and
  each ATen op's input and output bytes summed (``TorchDispatchMode``) for
  the bytes, XLA's "bytes accessed" reckoning.
- :class:`StepTimerListener`: wall-clock times between ``iteration_done``
  calls; the fit loops read the score's value (a device-to-host sync)
  before the listeners run, so each time ends after its step finished.

- :class:`ParamServerMetricsListener` (from ``paramserver/metrics.py``):
  a parameter-server client's metrics on the listener bus.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .. import resolve_device
from ..optimize.listeners import TrainingListener
from ..paramserver.metrics import ParamServerMetricsListener  # noqa: F401  (re-export)

__all__ = ["trace", "ProfilerListener", "StepTimerListener", "step_cost"]


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir: str) -> str:
    """Write ``prof``'s events as a Chrome trace into ``log_dir``; returns
    its path (one new file a call)."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace into ``log_dir``: host activities, and the card's kernels
    and copies unless ``device="cpu"`` (the card's default raises without
    one)."""
    dev = resolve_device(device)
    prof = torch.profiler.profile(activities=_activities(dev))
    prof.__enter__()
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        _export(prof, log_dir)


class ProfilerListener(TrainingListener):
    """Trace a window of training iterations: a ``torch.profiler`` trace
    starts at the first ``iteration_done`` at or after ``start_iteration``
    and stops ``num_iterations`` iterations later, at the end of the epoch,
    or when ``fit`` raises (``on_training_error``), whichever comes first;
    its Chrome trace goes into ``log_dir``. The traced device is the
    model's. Only one window a listener (``done``)."""

    def __init__(self, log_dir: str, start_iteration: int = 3, num_iterations: int = 3):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.num_iterations = num_iterations
        self._prof = None
        self._device = None
        self._until = None
        self.done = False
        self.path = None

    def iteration_done(self, model, iteration, score):
        if self.done:
            return
        if self._prof is None and iteration >= self.start_iteration:
            self._device = torch.device(model.device)
            self._prof = torch.profiler.profile(activities=_activities(self._device))
            self._prof.__enter__()
            self._until = iteration + self.num_iterations
        elif self._prof is not None and iteration >= self._until:
            # the fit loop read this step's score before calling us, so the
            # traced steps have finished on the card
            self.close()

    def close(self):
        """Stop and write the trace if one is running; safe to call at any
        time (a profiler left running would hold the next one off)."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        prof.__exit__(None, None, None)
        self.path = _export(prof, self.log_dir)
        self.done = True

    def on_epoch_end(self, model, epoch):
        self.close()

    def on_training_error(self, model, exception):
        self.close()


class StepTimerListener(TrainingListener):
    """Wall-clock ms between consecutive ``iteration_done`` calls. The fit
    loops take ``float(score)`` (a device-to-host sync) before they call
    the listeners, so each interval ends after its step's work on the card
    is done; code that times its own steps must sync the same way."""

    def __init__(self):
        self.times_ms: List[float] = []
        self._t0: Optional[float] = None

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        if self._t0 is not None:
            self.times_ms.append((now - self._t0) * 1e3)
        self._t0 = now

    def summary(self) -> Dict[str, float]:
        if not self.times_ms:
            return {}
        arr = np.asarray(self.times_ms)
        return {"mean_ms": float(arr.mean()), "p50_ms": float(np.median(arr)),
                "p95_ms": float(np.percentile(arr, 95)), "n": float(arr.size)}


#: per-net memo of step_cost's results by the inputs' shapes and dtypes,
#: kept on the net (its lifetime is the net's)
_STEP_COST_ATTR = "_step_cost_state"


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor each ATen op reads or writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def _cost_inputs(net, ds):
    """(inputs, labels, features masks, labels masks, batch) of ``ds`` on
    the net's device, in the form the container's ``_loss_fn`` takes."""
    from ..datasets.dataset import DataSet
    is_graph = hasattr(net.conf, "vertices")
    if is_graph:
        f, l, fm, lm = net._streams(ds)
        return f, l, fm, lm, int(f[0].shape[0])
    if not isinstance(ds, DataSet):
        raise TypeError("a MultiLayerNetwork's step_cost takes a DataSet")
    f, l, fm, lm = net._tensors(ds)
    return f, l, fm, lm, int(f.shape[0])


def step_cost(net, ds) -> Dict[str, Any]:
    """FLOPs and bytes of one loss-and-backward of ``net``'s fit step on
    ``ds``'s shapes (a DataSet, or a MultiDataSet for a ComputationGraph):
    ``flops`` from ``FlopCounterMode`` (matrix products, convolutions and
    attention, forward and backward), ``bytes_accessed`` the sum of every
    ATen op's input and output bytes, per example as
    ``gflop_per_example``/``mb_per_example``, and ``raw`` (FLOPs by
    operator). The step runs with remat as the fit step would, without
    its updater: the parameters, the layers' state, the updater state and
    the training draws' generator are left as they were. Memoised per net
    and input shapes and dtypes.

    The hand-written kernels (K1-K7) launch through ctypes inside their
    ``autograd.Function``s, so the dispatcher sees neither their FLOPs nor
    their bytes; a net whose step runs them is undercounted by their work
    (``chip_smoke.py`` prints the gap for the TransformerLM)."""
    from ..nn.layers.base import remat_enabled
    f, l, fm, lm, batch = _cost_inputs(net, ds)

    def key(ts):
        ts = ts if isinstance(ts, (tuple, list)) else (ts,)
        return tuple(None if t is None else (tuple(t.shape), str(t.dtype)) for t in ts)

    memo = getattr(net, _STEP_COST_ATTR, None)
    if memo is None:
        memo = {}
        setattr(net, _STEP_COST_ATTR, memo)
    k = (key(f), key(l), key(fm), key(lm))
    if k not in memo:
        flops_mode = FlopCounterMode(display=False)
        counter = _ByteCounter()
        gen = torch.Generator()
        gen.set_state(net._gen.get_state())
        remat = remat_enabled(net.gc, list(net._layers().values()))
        with flops_mode, counter:
            if hasattr(net.conf, "vertices"):
                loss = net._loss_fn(f, l, fm, lm, True, gen, {}, remat=remat)
            else:
                loss, _ = net._loss_fn(f, l, fm, lm, True, None, {}, rng=gen, remat=remat)
            net._grads(loss)
        raw = {str(op): int(n) for op, n in flops_mode.get_flop_counts().get("Global", {}).items()}
        memo[k] = {"flops": float(flops_mode.get_total_flops()),
                   "bytes_accessed": float(counter.bytes), "raw": raw}
    c = memo[k]
    return {"flops": c["flops"], "bytes_accessed": c["bytes_accessed"], "batch": batch,
            "gflop_per_example": c["flops"] / batch / 1e9,
            "mb_per_example": c["bytes_accessed"] / batch / 1e6, "raw": dict(c["raw"])}
