"""Early stopping: config, score calculators, termination conditions, savers,
trainer.

Counterpart of ``deeplearning4j_tpu/earlystopping/__init__.py`` (reference
``earlystopping/``; fit loop ``trainer/BaseEarlyStoppingTrainer.java:76``):
train epoch by epoch, score on a validation set every N epochs, keep the
best model, stop on any epoch or iteration termination condition. Both
containers train through their ``_fit_batch``; their ``score_`` is a
device tensor, read with ``float()`` once a minibatch (one sync), where
the JAX package reads it. ``InMemoryModelSaver`` keeps
``MultiLayerNetwork.clone()`` or, for a ComputationGraph (which has no
``clone`` in either package), a ``copy.deepcopy``; ``LocalFileModelSaver``
writes model zips and restores the best one onto the device of the
network it saved.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np


# --------------------------------------------------------------- calculators
class ScoreCalculator:
    """Reference ``earlystopping/scorecalc/ScoreCalculator.java``."""

    def calculate_score(self, net) -> float:
        raise NotImplementedError

    def minimize_score(self) -> bool:
        return True


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a validation iterator (reference
    ``scorecalc/DataSetLossCalculator.java``)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            b = np.asarray(ds.features if not isinstance(ds.features, (list, tuple))
                           else ds.features[0]).shape[0]
            total += net.score(ds) * b
            n += b
        return total / n if (self.average and n) else total


class ClassificationScoreCalculator(ScoreCalculator):
    """Accuracy (maximized) on a validation iterator."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, net) -> float:
        return net.evaluate(self.iterator).accuracy()

    def minimize_score(self) -> bool:
        return False


# ----------------------------------------------- epoch termination conditions
class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after ``patience`` epochs without ≥``min_improvement`` improvement
    (reference class of the same name). ``minimize`` is set by the trainer from
    the score calculator's direction before the fit loop."""

    def __init__(self, patience: int, min_improvement: float = 0.0):
        self.patience = int(patience)
        self.min_improvement = float(min_improvement)
        self.minimize = True
        self.best = None
        self.best_epoch = -1

    def initialize(self):
        self.best = None
        self.best_epoch = -1

    def terminate(self, epoch, score):
        improvement = ((self.best - score) if self.minimize
                       else (score - self.best)) if self.best is not None else None
        if self.best is None or improvement > self.min_improvement:
            self.best = score
            self.best_epoch = epoch
            return False
        return (epoch - self.best_epoch) >= self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least as good as ``target`` (reference keeps a
    lesser-better flag; we take minimize from the config at check time)."""

    def __init__(self, target: float, minimize: bool = True):
        self.target = float(target)
        self.minimize = minimize

    def terminate(self, epoch, score):
        return score <= self.target if self.minimize else score >= self.target


# ------------------------------------------- iteration termination conditions
class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self):
        self._start = time.time()

    def terminate(self, last_score):
        return (time.time() - self._start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort when the score exceeds a bound (divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, last_score):
        return last_score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, last_score):
        return not np.isfinite(last_score)


# --------------------------------------------------------------------- savers
class EarlyStoppingModelSaver:
    def save_best_model(self, net, score):
        raise NotImplementedError

    def save_latest_model(self, net, score):
        pass

    def get_best_model(self):
        raise NotImplementedError


class InMemoryModelSaver(EarlyStoppingModelSaver):
    """Reference ``saver/InMemoryModelSaver.java`` — deep-copies the model."""

    def __init__(self):
        self.best = None

    def save_best_model(self, net, score):
        self.best = net.clone() if hasattr(net, "clone") else copy.deepcopy(net)

    def get_best_model(self):
        return self.best


class LocalFileModelSaver(EarlyStoppingModelSaver):
    """Reference ``saver/LocalFileModelSaver.java`` — ModelSerializer zips;
    the best model comes back on the device of the network saved."""

    def __init__(self, directory: str):
        import os
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._is_graph = None
        self._device = None

    def _path(self, name):
        import os
        return os.path.join(self.directory, name)

    def save_best_model(self, net, score):
        from ..utils.model_serializer import ModelSerializer
        from ..nn.multilayer import MultiLayerNetwork
        self._is_graph = not isinstance(net, MultiLayerNetwork)
        self._device = net.device
        ModelSerializer.write_model(net, self._path("bestModel.bin"))

    def save_latest_model(self, net, score):
        from ..utils.model_serializer import ModelSerializer
        ModelSerializer.write_model(net, self._path("latestModel.bin"))

    def get_best_model(self):
        from ..utils.model_serializer import ModelSerializer
        # a zip this saver did not write restores onto the card, the default
        device = self._device if self._device is not None else "cuda"
        return ModelSerializer.restore_model(self._path("bestModel.bin"), device=device)


# --------------------------------------------------------------------- config
@dataclass
class EarlyStoppingConfiguration:
    """Reference ``EarlyStoppingConfiguration`` + Builder."""
    score_calculator: Optional[ScoreCalculator] = None
    epoch_termination_conditions: List[EpochTerminationCondition] = field(
        default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(
        default_factory=list)
    model_saver: EarlyStoppingModelSaver = field(default_factory=InMemoryModelSaver)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def score_calculator(self, sc):
            self._c.score_calculator = sc
            return self

        scoreCalculator = score_calculator

        def epoch_termination_conditions(self, *conds):
            self._c.epoch_termination_conditions.extend(conds)
            return self

        epochTerminationConditions = epoch_termination_conditions

        def iteration_termination_conditions(self, *conds):
            self._c.iteration_termination_conditions.extend(conds)
            return self

        iterationTerminationConditions = iteration_termination_conditions

        def model_saver(self, saver):
            self._c.model_saver = saver
            return self

        modelSaver = model_saver

        def evaluate_every_n_epochs(self, n):
            self._c.evaluate_every_n_epochs = int(n)
            return self

        evaluateEveryNEpochs = evaluate_every_n_epochs

        def save_last_model(self, flag=True):
            self._c.save_last_model = bool(flag)
            return self

        saveLastModel = save_last_model

        def build(self):
            return self._c

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()


# --------------------------------------------------------------------- result
class TerminationReason:
    EpochTerminationCondition = "EpochTerminationCondition"
    IterationTerminationCondition = "IterationTerminationCondition"
    Error = "Error"


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: Dict[int, float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any


# -------------------------------------------------------------------- trainer
class EarlyStoppingTrainer:
    """Reference ``trainer/BaseEarlyStoppingTrainer.java:76`` fit loop; works
    for both ``MultiLayerNetwork`` and ``ComputationGraph``."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator):
        self.config = config
        self.net = net
        self.iterator = train_iterator

    def _train_one_epoch(self, c, reason, details):
        """One epoch of training with per-iteration termination checks.
        Overridden by the distributed trainer (epoch-granular master fit,
        reference ``spark/earlystopping/BaseSparkEarlyStoppingTrainer.java``).
        Returns (terminated, reason, details)."""
        for ds in self.iterator:
            self.net._fit_batch(ds)
            last = float(self.net.score_)
            for cond in c.iteration_termination_conditions:
                if cond.terminate(last):
                    reason = TerminationReason.IterationTerminationCondition
                    details = f"{type(cond).__name__} at score {last}"
                    return True, reason, details
        return False, reason, details

    def fit(self) -> EarlyStoppingResult:
        c = self.config
        for cond in c.epoch_termination_conditions:
            cond.initialize()
        for cond in c.iteration_termination_conditions:
            cond.initialize()
        minimize = (c.score_calculator.minimize_score()
                    if c.score_calculator else True)
        for cond in c.epoch_termination_conditions:
            if hasattr(cond, "minimize"):
                cond.minimize = minimize
        score_vs_epoch: Dict[int, float] = {}
        best_score = np.inf if minimize else -np.inf
        best_epoch = -1
        epoch = 0
        reason, details = None, ""
        while True:
            iter_terminated, reason, details = self._train_one_epoch(
                c, reason, details)
            if iter_terminated:
                break
            self.net.epoch_count += 1
            evaluated = (c.score_calculator is not None
                         and epoch % c.evaluate_every_n_epochs == 0)
            if evaluated:
                score = float(c.score_calculator.calculate_score(self.net))
                score_vs_epoch[epoch] = score
                improved = score < best_score if minimize else score > best_score
                if improved:
                    best_score = score
                    best_epoch = epoch
                    c.model_saver.save_best_model(self.net, score)
                if c.save_last_model:
                    c.model_saver.save_latest_model(self.net, score)
            else:
                score = float(self.net.score_)
            # score-based epoch conditions only fire on epochs with a fresh
            # validation score (reference BaseEarlyStoppingTrainer gates the
            # check inside the evaluate-every-N block); epoch-count conditions
            # (MaxEpochs) are always checked so they fire between evaluations.
            score_valid = evaluated or c.score_calculator is None
            for cond in c.epoch_termination_conditions:
                if (not score_valid
                        and not isinstance(cond, MaxEpochsTerminationCondition)):
                    continue
                if cond.terminate(epoch, score):
                    reason = TerminationReason.EpochTerminationCondition
                    details = f"{type(cond).__name__} at epoch {epoch}"
                    break
            if reason == TerminationReason.EpochTerminationCondition:
                break
            epoch += 1
        best = c.model_saver.get_best_model()
        if best is None:
            best = self.net
            best_epoch = epoch
            best_score = float(self.net.score_)
        return EarlyStoppingResult(
            termination_reason=reason or TerminationReason.Error,
            termination_details=details,
            score_vs_epoch=score_vs_epoch,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            total_epochs=epoch + 1,
            best_model=best)


EarlyStoppingGraphTrainer = EarlyStoppingTrainer
