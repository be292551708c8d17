"""Full-batch optimizers: ``Solver`` dispatch, LBFGS, conjugate gradient,
line gradient descent and the backtracking line search.

Counterpart of ``deeplearning4j_tpu/optimize/solvers.py`` (reference
``Solver``, ``LBFGS``, ``ConjugateGradient``, ``LineGradientDescent``,
``BackTrackLineSearch``). The direction and line-search logic runs on the
host in float64 numpy over the parameters as one vector (layers in sorted
key order, each layer's parameters sorted: the JAX package's flattening);
each loss-and-gradient evaluation writes the vector into the network's
parameters on its device (one host-to-device copy) and is one training
loss with one autograd call, with no generator (dropout and noise off).
``Solver`` reads the configuration's ``optimization_algo``; SGD is the
network's own minibatch ``fit``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..nn.conf import OptimizationAlgorithm
from ..datasets.prefetch import backward_begins
from ..monitor.jitwatch import monitored_jit
from ..nn.gradientcheck import _loss_at
from ..utils.trees import sorted_leaves

__all__ = ["BackTrackLineSearch", "BaseOptimizer", "LineGradientDescent",
           "ConjugateGradient", "LBFGS", "Solver"]


class BackTrackLineSearch:
    """Armijo backtracking (reference ``BackTrackLineSearch``)."""

    def __init__(self, c1: float = 1e-4, shrink: float = 0.5, max_iterations: int = 20):
        self.c1 = c1
        self.shrink = shrink
        self.max_iterations = max_iterations

    def search(self, f, x, fx, gx, direction, step0: float = 1.0) -> Tuple[float, float]:
        """(step, f(x + step * direction)); 0 and ``fx`` when the direction
        does not descend, the smallest step tried when none satisfies the
        Armijo condition."""
        slope = float(gx @ direction)
        if slope >= 0:
            return 0.0, fx
        step = step0
        for _ in range(self.max_iterations):
            fnew = f(x + step * direction)
            if fnew <= fx + self.c1 * step * slope:
                return step, fnew
            step *= self.shrink
        return step, f(x + step * direction)


class BaseOptimizer:
    """The network's parameters as one float64 host vector, and the loss
    (``f``) and loss with gradient (``f_g``) at a vector."""

    def __init__(self, net, ds, max_iterations: int = 100, tol: float = 1e-8):
        self.net = net
        self.ds = ds
        self.max_iterations = max_iterations
        self.tol = tol
        self._loss = monitored_jit(_loss_at, name="solvers/loss")
        self._value_and_grad = monitored_jit(self._loss_and_grads, name="solvers/value_and_grad")
        self._params = [p for _, p in sorted_leaves(net._trainable())]
        self._x0 = np.concatenate(
            [p.detach().cpu().double().numpy().ravel() for p in self._params]) \
            if self._params else np.zeros(0)

    def _load(self, x: np.ndarray) -> None:
        flat = torch.from_numpy(np.ascontiguousarray(x)).to(self.net.device)
        pos = 0
        with torch.no_grad():
            for p in self._params:
                p.copy_(flat[pos:pos + p.numel()].view(p.shape))
                pos += p.numel()

    def f(self, x: np.ndarray) -> float:
        self._load(x)
        with torch.no_grad():
            return float(self._loss(self.net, self.ds))

    def _loss_and_grads(self, net, ds):
        loss = _loss_at(net, ds)
        backward_begins()
        return loss, torch.autograd.grad(loss, self._params, allow_unused=True)

    def f_g(self, x: np.ndarray) -> Tuple[float, np.ndarray]:
        self._load(x)
        loss, grads = self._value_and_grad(self.net, self.ds)
        g = torch.cat([(torch.zeros_like(p) if gi is None else gi).reshape(-1).double()
                       for p, gi in zip(self._params, grads)])
        return float(loss.detach()), g.cpu().numpy()

    def _commit(self, x, fx):
        self._load(x)
        self.net.score_ = fx

    def optimize(self) -> bool:
        raise NotImplementedError


class LineGradientDescent(BaseOptimizer):
    """Steepest descent with the line search."""

    def optimize(self) -> bool:
        x = self._x0.copy()
        ls = BackTrackLineSearch()
        fx, g = self.f_g(x)
        for _ in range(self.max_iterations):
            d = -g
            step, fnew = ls.search(self.f, x, fx, g, d)
            if step == 0.0 or abs(fx - fnew) < self.tol:
                break
            x = x + step * d
            fx, g = self.f_g(x)
        self._commit(x, fx)
        return True


class ConjugateGradient(BaseOptimizer):
    """Polak-Ribiere+ nonlinear conjugate gradient."""

    def optimize(self) -> bool:
        x = self._x0.copy()
        ls = BackTrackLineSearch()
        fx, g = self.f_g(x)
        d = -g
        for _ in range(self.max_iterations):
            step, fnew = ls.search(self.f, x, fx, g, d)
            if step == 0.0:
                d = -g  # restart with steepest descent
                step, fnew = ls.search(self.f, x, fx, g, d)
                if step == 0.0:
                    break
            x = x + step * d
            fprev, gprev = fx, g
            fx, g = self.f_g(x)
            if abs(fprev - fx) < self.tol:
                break
            beta = max(0.0, float(g @ (g - gprev) / max(gprev @ gprev, 1e-300)))
            d = -g + beta * d
        self._commit(x, fx)
        return True


class LBFGS(BaseOptimizer):
    """Limited-memory BFGS, two-loop recursion over the last ``m`` pairs."""

    def __init__(self, net, ds, max_iterations: int = 100, tol: float = 1e-8, m: int = 10):
        super().__init__(net, ds, max_iterations, tol)
        self.m = m

    def optimize(self) -> bool:
        x = self._x0.copy()
        ls = BackTrackLineSearch()
        fx, g = self.f_g(x)
        s_hist: List[np.ndarray] = []
        y_hist: List[np.ndarray] = []
        for _ in range(self.max_iterations):
            q = g.copy()
            alphas = []
            for s, y in zip(reversed(s_hist), reversed(y_hist)):
                rho = 1.0 / max(float(y @ s), 1e-300)
                a = rho * float(s @ q)
                alphas.append((a, rho))
                q -= a * y
            if y_hist:
                y_last, s_last = y_hist[-1], s_hist[-1]
                q *= float(s_last @ y_last) / max(float(y_last @ y_last), 1e-300)
            for (a, rho), s, y in zip(reversed(alphas), s_hist, y_hist):
                b = rho * float(y @ q)
                q += (a - b) * s
            d = -q
            step, _ = ls.search(self.f, x, fx, g, d,
                                step0=1.0 if y_hist else
                                min(1.0, 1.0 / max(np.abs(g).sum(), 1e-12)))
            if step == 0.0:
                break
            x_new = x + step * d
            f_new, g_new = self.f_g(x_new)
            s_hist.append(x_new - x)
            y_hist.append(g_new - g)
            if len(s_hist) > self.m:
                s_hist.pop(0)
                y_hist.pop(0)
            converged = abs(fx - f_new) < self.tol
            x, fx, g = x_new, f_new, g_new
            if converged:
                break
        self._commit(x, fx)
        return True


class Solver:
    """Dispatch on the configuration's ``optimization_algo`` (reference
    ``Solver``)."""

    class Builder:
        def __init__(self):
            self._net = None
            self._max_iterations = 100

        def model(self, net):
            self._net = net
            return self

        def max_iterations(self, n):
            self._max_iterations = int(n)
            return self

        maxIterations = max_iterations

        def build(self):
            return Solver(self._net, self._max_iterations)

    @staticmethod
    def builder():
        return Solver.Builder()

    def __init__(self, net, max_iterations: int = 100):
        self.net = net
        self.max_iterations = max_iterations

    def optimize(self, ds) -> bool:
        """Full-batch optimization of the network on ``ds`` with the
        configured algorithm; SGD runs the network's ``fit``."""
        algo = self.net.gc.optimization_algo
        if algo == OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            self.net.fit(ds)
            return True
        cls = {OptimizationAlgorithm.LBFGS: LBFGS,
               OptimizationAlgorithm.CONJUGATE_GRADIENT: ConjugateGradient,
               OptimizationAlgorithm.LINE_GRADIENT_DESCENT: LineGradientDescent}
        if algo not in cls:
            raise ValueError(f"Unknown optimization algorithm '{algo}'")
        return cls[algo](self.net, ds, max_iterations=self.max_iterations).optimize()
