"""Training listeners.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``: the listener
bus contract (:class:`TrainingListener`, alias ``IterationListener``), the
fit loops' error seam (:func:`dispatch_training_error`) and the stock
listeners: ScoreIterationListener, PerformanceListener,
CollectScoresIterationListener, TimeIterationListener,
SleepyTrainingListener, EvaluativeListener,
ParamAndGradientIterationListener and CheckpointListener.

Both containers' ``fit`` call ``iteration_done(model, iteration, score)``
once a minibatch with the score as a Python float (a device-to-host sync
they take only when a listener is set), and ``on_epoch_start``/
``on_epoch_end`` around each epoch. ``on_forward_pass`` and
``on_backward_pass`` are part of the contract and, as in the JAX package,
not called by the fit loops.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..utils.trees import sorted_leaves

log = logging.getLogger(__name__)

__all__ = ["TrainingListener", "IterationListener", "dispatch_training_error",
           "ScoreIterationListener", "PerformanceListener", "CollectScoresIterationListener",
           "TimeIterationListener", "SleepyTrainingListener", "EvaluativeListener",
           "ParamAndGradientIterationListener", "CheckpointListener"]


class TrainingListener:
    """Listener bus contract. ``iteration_done`` fires once per minibatch
    with the scalar score; the epoch, forward and backward hooks mirror the
    reference's TrainingListener."""

    def iteration_done(self, model, iteration, score):
        pass

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_backward_pass(self, model):
        pass

    def on_training_error(self, model, exception):
        """``fit`` is unwinding on ``exception``: release any process-wide
        resource this listener holds. Must not raise; a failing hook is
        logged and skipped and never masks the original error."""
        pass


IterationListener = TrainingListener  # reference naming alias


def dispatch_training_error(model, listeners, exception):
    """``on_training_error`` to every listener from the fit loops' except
    seam, even when an earlier one fails; nothing here can mask the
    original exception."""
    for lst in listeners:
        hook = getattr(lst, "on_training_error", None)
        if hook is None:
            continue
        try:
            hook(model, exception)
        except Exception as e:
            log.warning("on_training_error hook of %r failed: %r", lst, e)


class ScoreIterationListener(TrainingListener):
    """Logs the score every ``print_iterations`` iterations."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration, float(score))


class PerformanceListener(TrainingListener):
    """Throughput every ``frequency`` iterations (samples/s from the model's
    ``last_batch_size``, batches/s); ``last_samples_per_sec`` and
    ``last_batches_per_sec`` keep the latest."""

    def __init__(self, frequency: int = 1, report_score: bool = False):
        self.frequency = max(1, frequency)
        self.report_score = report_score
        self._last_time = None
        self._samples = 0
        self._batches = 0
        self.last_samples_per_sec = 0.0
        self.last_batches_per_sec = 0.0

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        self._samples += getattr(model, "last_batch_size", 0) or 0
        self._batches += 1
        if self._last_time is None:
            self._last_time = now
            self._samples = 0
            self._batches = 0
            return
        if self._batches >= self.frequency:
            dt = now - self._last_time
            if dt > 0:
                self.last_batches_per_sec = self._batches / dt
                if self._samples:
                    self.last_samples_per_sec = self._samples / dt
                    msg = (f"iteration {iteration}: {self.last_samples_per_sec:.1f} "
                           f"samples/sec, {self.last_batches_per_sec:.2f} batches/sec")
                else:
                    # no batch size known: report the rate measured, not a
                    # 0.0 samples/sec that reads as a stall
                    msg = f"iteration {iteration}: {self.last_batches_per_sec:.2f} batches/sec"
                if self.report_score:
                    msg += f", score {float(score):.5f}"
                log.info("%s", msg)
            self._last_time = now
            self._samples = 0
            self._batches = 0


class CollectScoresIterationListener(TrainingListener):
    """Records ``(iteration, score)`` every ``frequency`` iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class TimeIterationListener(TrainingListener):
    """Logs the remaining time for ``iteration_count`` iterations every
    ``frequency`` iterations."""

    def __init__(self, iteration_count: int, frequency: int = 10):
        self.start = time.perf_counter()
        self.total = iteration_count
        self.frequency = max(1, frequency)

    def iteration_done(self, model, iteration, score):
        if iteration and iteration % self.frequency == 0:
            per_it = (time.perf_counter() - self.start) / max(iteration, 1)
            remaining = per_it * max(self.total - iteration, 0)
            log.info("iteration %d/%d, ETA %.1fs", iteration, self.total, remaining)


class SleepyTrainingListener(TrainingListener):
    """Sleeps ``sleep_ms`` after each iteration (a debugging throttle)."""

    def __init__(self, sleep_ms: int = 0):
        self.sleep_ms = sleep_ms

    def iteration_done(self, model, iteration, score):
        if self.sleep_ms:
            time.sleep(self.sleep_ms / 1000.0)


class EvaluativeListener(TrainingListener):
    """Reference ``EvaluativeListener``: ``model.evaluate(iterator)`` every
    ``frequency`` iterations (iteration 0 excepted), kept in
    ``last_evaluation`` and logged. ``evaluation_factory`` is accepted and,
    as in the JAX package, not used."""

    def __init__(self, iterator, frequency: int = 100, evaluation_factory=None):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.evaluation_factory = evaluation_factory
        self.last_evaluation = None

    def iteration_done(self, model, iteration, score):
        if iteration and iteration % self.frequency == 0:
            self.last_evaluation = model.evaluate(self.iterator)
            log.info("Evaluation at iteration %d:\n%s", iteration,
                     self.last_evaluation.stats())


def _flat_params(model) -> np.ndarray:
    """Every parameter of ``model`` in one host vector, layer by layer in
    sorted key order with each layer's parameters sorted (the JAX
    package's ``tree_leaves`` order), in the parameters' dtype."""
    return np.concatenate([_host(t).ravel() for _, t in sorted_leaves(model.params)])


def _host(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t if t.dtype in (torch.float32, torch.float64) else t.float()).numpy()


class ParamAndGradientIterationListener(TrainingListener):
    """Per-iteration parameter and update statistics (mean, min/max, mean
    absolute value), tab-delimited to the console and/or a file every
    ``iterations`` iterations; ``rows`` keeps them. The update column is
    the applied update (the parameters' change since the previous
    iteration): the fit step applies the updater before listeners hear of
    it, as in the JAX package."""

    def __init__(self, iterations: int = 1, print_header: bool = True,
                 print_mean: bool = True, print_min_max: bool = True,
                 print_mean_abs_value: bool = True, output_to_console: bool = True,
                 file_path: Optional[str] = None, delimiter: str = "\t"):
        self.frequency = max(1, iterations)
        self.print_header = print_header
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.print_mean_abs = print_mean_abs_value
        self.output_to_console = output_to_console
        self.file_path = file_path
        self.delimiter = delimiter
        self.rows = []
        self._prev_flat = None
        self._wrote_header = False

    def _stats(self, flat):
        out = []
        if self.print_mean:
            out.append(float(flat.mean()))
        if self.print_min_max:
            out += [float(flat.min()), float(flat.max())]
        if self.print_mean_abs:
            out.append(float(np.abs(flat).mean()))
        return out

    def _header(self):
        cols = ["iteration", "score"]
        for fam in ("param", "update"):
            if self.print_mean:
                cols.append(f"{fam}Mean")
            if self.print_min_max:
                cols += [f"{fam}Min", f"{fam}Max"]
            if self.print_mean_abs:
                cols.append(f"{fam}MeanAbsValue")
        return cols

    def iteration_done(self, model, iteration, score):
        flat = _flat_params(model)
        if iteration % self.frequency != 0:
            self._prev_flat = flat
            return
        update = (flat - self._prev_flat if self._prev_flat is not None
                  else np.zeros_like(flat))
        self._prev_flat = flat
        row = [iteration, float(score)] + self._stats(flat) + self._stats(update)
        self.rows.append(row)
        lines = []
        if self.print_header and not self._wrote_header:
            lines.append(self.delimiter.join(self._header()))
            self._wrote_header = True
        lines.append(self.delimiter.join(str(v) for v in row))
        text = "\n".join(lines)
        if self.output_to_console:
            print(text)
        if self.file_path:
            try:
                with open(self.file_path, "a") as fh:
                    fh.write(text + "\n")
            except OSError as e:
                log.warning("ParamAndGradientIterationListener write failed: %s", e)


class CheckpointListener(TrainingListener):
    """Periodic checkpoints with keep-last rotation, written by
    ``utils/model_serializer.write_model`` (parameters, layer state and,
    with ``save_updater``, the updater state), so the newest one resumes
    training exactly (:meth:`last_checkpoint`).

    ``save_every_n_iterations`` / ``save_every_n_epochs``: either or both
    (epochs default to every epoch only when no iteration cadence is set);
    ``keep_last``: how many files to keep (0 or None keeps all). A
    directory that already holds checkpoints is adopted: the file index
    continues and rotation prunes the old files."""

    def __init__(self, directory: str, save_every_n_iterations: int = 0,
                 save_every_n_epochs: Optional[int] = None,
                 keep_last: int = 3, save_updater: bool = True):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.every_iter = int(save_every_n_iterations or 0)
        if save_every_n_epochs is None:
            save_every_n_epochs = 0 if self.every_iter else 1
        self.every_epoch = int(save_every_n_epochs or 0)
        self.keep_last = keep_last
        self.save_updater = save_updater
        self.saved = self.checkpoints(directory)
        self._counter = max((self._index_of(p) or 0 for p in self.saved), default=0)
        # an orphaned .tmp of a crash mid-write
        for name in os.listdir(directory):
            if name.startswith("checkpoint-") and name.endswith(".zip.tmp"):
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    pass
        # a threshold, not a modulo: iteration_count can advance by more
        # than one an iteration_done (iterations(n), TBPTT segments)
        self._next_iter_save = self.every_iter

    def iteration_done(self, model, iteration, score):
        if self.every_iter and iteration + 1 >= self._next_iter_save:
            self._save(model, f"iter-{iteration + 1}")
            self._next_iter_save = iteration + 1 + self.every_iter

    def on_epoch_end(self, model, epoch):
        if self.every_epoch and (epoch + 1) % self.every_epoch == 0:
            self._save(model, f"epoch-{epoch + 1}")

    def _save(self, model, tag):
        from ..utils.model_serializer import write_model

        self._counter += 1
        path = os.path.join(self.directory, f"checkpoint-{self._counter:05d}-{tag}.zip")
        tmp = path + ".tmp"
        try:
            write_model(model, tmp, save_updater=self.save_updater)
            os.replace(tmp, path)  # atomic: a crash never leaves a torn file
        except Exception as e:
            # a failed save (disk full, permissions) must not stop training
            log.warning("CheckpointListener: save to %s failed: %s", path, e)
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except OSError:
                pass
            return None
        self.saved.append(path)
        if self.keep_last:
            while len(self.saved) > self.keep_last:
                old = self.saved.pop(0)
                try:
                    os.remove(old)
                except OSError:
                    pass
        return path

    @staticmethod
    def _index_of(path):
        try:
            return int(os.path.basename(path).split("-")[1])
        except (IndexError, ValueError):
            return None

    @classmethod
    def checkpoints(cls, directory):
        """Checkpoint paths in save order (by the numeric file index)."""
        if not os.path.isdir(directory):
            return []
        paths = [os.path.join(directory, n) for n in os.listdir(directory)
                 if n.startswith("checkpoint-") and n.endswith(".zip")]
        return sorted(paths, key=lambda p: (cls._index_of(p) or 0, p))

    @classmethod
    def last_checkpoint(cls, directory, device="cuda"):
        """The newest checkpoint restored on ``device`` (the card unless
        ``device="cpu"``) with its updater state, or None when the
        directory holds none."""
        from ..utils.model_serializer import restore_model

        paths = cls.checkpoints(directory)
        return restore_model(paths[-1], device=device) if paths else None
