"""Gradient updaters (optimizers) and learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/nn/updaters.py``: the same ten
updaters and eight schedules, with the same fields (so the JSON the JAX
package writes decodes into these classes and re-encodes unchanged) and
the same arithmetic. An updater is functional, as there: ``apply(state,
grads, iteration) -> (updates, new_state)`` on ``{name: tensor}`` dicts,
and the caller subtracts the update from the parameter. State per
parameter is ``()``, one tensor, or a tuple of tensors, so the keypaths of
a saved ``updaterState.bin`` (``"<layer>/<param>/<slot>"``) map onto it.
``iteration`` is the count of applied updates; the bias-correction step
is ``t = iteration + 1``. A parameter dict may nest (a ``Bidirectional``
layer's ``{"fwd": {...}, "bwd": {...}}``); its state nests the same way.

The Adam family's bias corrections ``1 - beta ** t`` are float32 scalars,
as the JAX package takes them (``jnp.power`` of a weak float and an f32
step count) whatever the parameters' dtype: :func:`bias_correction`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch

__all__ = [
    "IUpdater", "Sgd", "Adam", "AdaMax", "Nadam", "Nesterovs", "RmsProp",
    "AdaGrad", "AdaDelta", "NoOp", "AMSGrad",
    "ISchedule", "FixedSchedule", "ExponentialSchedule", "InverseSchedule",
    "PolySchedule", "SigmoidSchedule", "StepSchedule", "MapSchedule",
    "WarmupCosineSchedule", "updater_from_dict", "schedule_from_dict",
    "UPDATERS", "SCHEDULES",
]


# ---------------------------------------------------------------------------
# Learning-rate schedules: value(iteration) -> float
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ISchedule:
    def value(self, iteration, epoch=0):  # pragma: no cover - abstract
        raise NotImplementedError

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["@sched"] = type(self).__name__
        return d


@dataclasses.dataclass
class FixedSchedule(ISchedule):
    value_: float = 1e-3

    def value(self, iteration, epoch=0):
        return self.value_


@dataclasses.dataclass
class ExponentialSchedule(ISchedule):
    initial_value: float = 1e-3
    gamma: float = 0.99

    def value(self, iteration, epoch=0):
        return self.initial_value * self.gamma ** iteration


@dataclasses.dataclass
class InverseSchedule(ISchedule):
    initial_value: float = 1e-3
    gamma: float = 0.99
    power: float = 1.0

    def value(self, iteration, epoch=0):
        return self.initial_value / (1.0 + self.gamma * iteration) ** self.power


@dataclasses.dataclass
class PolySchedule(ISchedule):
    initial_value: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000

    def value(self, iteration, epoch=0):
        frac = min(iteration / float(self.max_iter), 1.0)
        return self.initial_value * (1.0 - frac) ** self.power


@dataclasses.dataclass
class SigmoidSchedule(ISchedule):
    initial_value: float = 1e-3
    gamma: float = 0.99
    step_size: int = 100

    def value(self, iteration, epoch=0):
        return self.initial_value / (1.0 + math.exp(self.gamma * (iteration - self.step_size)))


@dataclasses.dataclass
class StepSchedule(ISchedule):
    initial_value: float = 1e-3
    decay_rate: float = 0.1
    step_size: int = 1000

    def value(self, iteration, epoch=0):
        return self.initial_value * self.decay_rate ** math.floor(iteration / float(self.step_size))


@dataclasses.dataclass
class MapSchedule(ISchedule):
    """Piecewise-constant schedule keyed by iteration."""
    values: Any = None  # dict {iteration: lr}

    def value(self, iteration, epoch=0):
        # JSON round-trips stringify int keys; normalize before lookup
        values = {int(k): float(v) for k, v in self.values.items()}
        keys = sorted(values)
        lr = values[keys[0]]
        for k in keys[1:]:
            if iteration >= k:
                lr = values[k]
        return lr


@dataclasses.dataclass
class WarmupCosineSchedule(ISchedule):
    """Linear warmup then cosine decay."""
    peak_value: float = 1e-3
    warmup_steps: int = 1000
    total_steps: int = 100000
    end_value: float = 0.0

    def value(self, iteration, epoch=0):
        if iteration < self.warmup_steps:
            return self.peak_value * (iteration / max(self.warmup_steps, 1))
        frac = min(max((iteration - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1), 0.0), 1.0)
        return self.end_value + 0.5 * (self.peak_value - self.end_value) * (
            1 + math.cos(math.pi * frac))


SCHEDULES = {c.__name__: c for c in (FixedSchedule, ExponentialSchedule, InverseSchedule,
                                     PolySchedule, SigmoidSchedule, StepSchedule,
                                     MapSchedule, WarmupCosineSchedule)}


def schedule_from_dict(d):
    d = dict(d)
    return SCHEDULES[d.pop("@sched")](**d)


def _lr_at(updater, iteration):
    if updater.lr_schedule is not None:
        return updater.lr_schedule.value(iteration)
    return updater.learning_rate


# ---------------------------------------------------------------------------
# Updaters
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IUpdater:
    """Base updater. Subclasses implement ``init_one``/``apply_one`` on one
    tensor; ``init_state``/``apply`` map them over a ``{name: tensor}``
    dict."""
    learning_rate: float = 1e-3
    lr_schedule: Optional[ISchedule] = None

    def init_one(self, p):
        return ()

    def apply_one(self, state, g, lr, t):  # pragma: no cover - abstract
        raise NotImplementedError

    def init_state(self, params: Dict[str, torch.Tensor]):
        return {k: self.init_state(p) if isinstance(p, dict) else self.init_one(p)
                for k, p in params.items()}

    def apply(self, state, grads, iteration):
        # t: the bias-correction step count (1-based)
        return self._apply_tree(state, grads, _lr_at(self, iteration), iteration + 1)

    def _apply_tree(self, state, grads, lr, t):
        updates, new_state = {}, {}
        for k, g in grads.items():
            if isinstance(g, dict):
                updates[k], new_state[k] = self._apply_tree(state[k], g, lr, t)
            else:
                updates[k], new_state[k] = self.apply_one(state[k], g, lr, t)
        return updates, new_state

    def to_dict(self):
        d = {k: v for k, v in dataclasses.asdict(self).items() if k != "lr_schedule"}
        d["@updater"] = type(self).__name__
        if self.lr_schedule is not None:
            d["lr_schedule"] = self.lr_schedule.to_dict()
        return d


def _zeros(p):
    return torch.zeros_like(p, memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=4096)
def bias_correction(beta: float, t: int) -> float:
    """``1 - beta ** t`` in float32, as a Python float: the power of two
    f32 scalars on the CPU (the C library's ``powf``, which XLA's CPU
    backend calls for the JAX package's ``jnp.power``; numpy's and torch's
    vectorised loops differ in the last bit at some steps), then an f32
    subtraction. Dividing an f64 moment by it gives the JAX package's f64
    update bit for bit."""
    one = torch.ones((), dtype=torch.float32)
    p = torch.pow(torch.tensor(beta, dtype=torch.float32),
                  torch.tensor(float(t), dtype=torch.float32))
    return float(one - p)


@dataclasses.dataclass
class NoOp(IUpdater):
    def apply_one(self, state, g, lr, t):
        return torch.zeros_like(g), state


@dataclasses.dataclass
class Sgd(IUpdater):
    def apply_one(self, state, g, lr, t):
        return lr * g, state


@dataclasses.dataclass
class Nesterovs(IUpdater):
    learning_rate: float = 0.1
    momentum: float = 0.9

    def init_one(self, p):
        return _zeros(p)

    def apply_one(self, v, g, lr, t):
        # the JAX package's lookahead form
        v_new = self.momentum * v - lr * g
        return -(self.momentum * v_new - lr * g), v_new


@dataclasses.dataclass
class Adam(IUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_one(self, p):
        return (_zeros(p), _zeros(p))

    def apply_one(self, state, g, lr, t):
        m, v = state
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * (g * g)
        mhat = m / bias_correction(self.beta1, t)
        vhat = v / bias_correction(self.beta2, t)
        return lr * mhat / (torch.sqrt(vhat) + self.epsilon), (m, v)


@dataclasses.dataclass
class AMSGrad(IUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_one(self, p):
        return (_zeros(p), _zeros(p), _zeros(p))

    def apply_one(self, state, g, lr, t):
        m, v, vmax = state
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * (g * g)
        vmax = torch.maximum(vmax, v)
        mhat = m / bias_correction(self.beta1, t)
        return lr * mhat / (torch.sqrt(vmax) + self.epsilon), (m, v, vmax)


@dataclasses.dataclass
class AdaMax(IUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_one(self, p):
        return (_zeros(p), _zeros(p))

    def apply_one(self, state, g, lr, t):
        m, u = state
        m = self.beta1 * m + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * u, torch.abs(g))
        mhat = m / bias_correction(self.beta1, t)
        return lr * mhat / (u + self.epsilon), (m, u)


@dataclasses.dataclass
class Nadam(IUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_one(self, p):
        return (_zeros(p), _zeros(p))

    def apply_one(self, state, g, lr, t):
        m, v = state
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * (g * g)
        mhat = m / bias_correction(self.beta1, t)
        vhat = v / bias_correction(self.beta2, t)
        nad = self.beta1 * mhat + (1 - self.beta1) * g / bias_correction(self.beta1, t)
        return lr * nad / (torch.sqrt(vhat) + self.epsilon), (m, v)


@dataclasses.dataclass
class RmsProp(IUpdater):
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_one(self, p):
        return _zeros(p)

    def apply_one(self, cache, g, lr, t):
        cache = self.rms_decay * cache + (1 - self.rms_decay) * (g * g)
        return lr * g / (torch.sqrt(cache) + self.epsilon), cache


@dataclasses.dataclass
class AdaGrad(IUpdater):
    learning_rate: float = 1e-1
    epsilon: float = 1e-6

    def init_one(self, p):
        return _zeros(p)

    def apply_one(self, hist, g, lr, t):
        hist = hist + g * g
        return lr * g / (torch.sqrt(hist) + self.epsilon), hist


@dataclasses.dataclass
class AdaDelta(IUpdater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_one(self, p):
        return (_zeros(p), _zeros(p))

    def apply_one(self, state, g, lr, t):
        msg, msdx = state
        msg = self.rho * msg + (1 - self.rho) * (g * g)
        dx = torch.sqrt(msdx + self.epsilon) / torch.sqrt(msg + self.epsilon) * g
        msdx = self.rho * msdx + (1 - self.rho) * (dx * dx)
        return dx, (msg, msdx)


UPDATERS = {c.__name__: c for c in (Sgd, Adam, AdaMax, Nadam, Nesterovs, RmsProp,
                                    AdaGrad, AdaDelta, NoOp, AMSGrad)}


def updater_from_dict(d):
    d = dict(d)
    kind = d.pop("@updater")
    sched = d.pop("lr_schedule", None)
    u = UPDATERS[kind](**d)
    if sched is not None:
        u.lr_schedule = schedule_from_dict(sched)
    return u
