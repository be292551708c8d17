"""t-SNE: exact with its steps on the card, and Barnes-Hut on the host.

Counterpart of ``deeplearning4j_tpu/clustering/tsne.py`` (reference
``deeplearning4j-core/.../plot/Tsne.java`` and ``BarnesHutTsne.java``).
The input affinities P come from the per-row precision search on the host
in float64 numpy (``_h_beta``, ``_search_beta``, ``_binary_search_p``, the
JAX package's code). The exact variant's O(n^2) step (:func:`_tsne_step`:
squared distances, the Student-t kernel q, the gradient, gains, momentum,
centring and the KL divergence) runs on ``device`` in f32 with P, the
gains and the velocity resident there, as the JAX package's jitted step
does, on its schedule: early exaggeration and momentum 0.5 until
``min(250, n_iter // 2)``, ``kl_`` from the last step. Barnes-Hut
(sparse kNN attraction over a VPTree, SpTree repulsion with the theta
condition) is a host numpy copy: the JAX package does no device work
there either.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..monitor.jitwatch import monitored_jit
from .trees import SpTree, VPTree

__all__ = ["Tsne", "BarnesHutTsne"]


# ------------------------------------------------------------ P construction
def _h_beta(d2_row: np.ndarray, beta: float):
    p = np.exp(-d2_row * beta)
    sum_p = max(p.sum(), 1e-12)
    h = np.log(sum_p) + beta * float(d2_row @ p) / sum_p
    return h, p / sum_p


def _search_beta(d2_row: np.ndarray, target: float, tol: float = 1e-5,
                 max_tries: int = 50) -> np.ndarray:
    """Bisection on the Gaussian precision for ONE row of squared distances
    until the entropy hits ``target`` (= log perplexity). Returns the row's
    conditional probabilities."""
    beta, lo, hi = 1.0, -np.inf, np.inf
    h, p = _h_beta(d2_row, beta)
    for _ in range(max_tries):
        if abs(h - target) < tol:
            break
        if h > target:
            lo = beta
            beta = beta * 2 if hi == np.inf else (beta + hi) / 2
        else:
            hi = beta
            beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        h, p = _h_beta(d2_row, beta)
    return p


def _binary_search_p(d2: np.ndarray, perplexity: float, tol: float = 1e-5,
                     max_tries: int = 50) -> np.ndarray:
    """Per-row precision search to hit the target perplexity (reference
    ``Tsne.computeGaussianPerplexity``)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        idx = np.concatenate([np.arange(i), np.arange(i + 1, n)])
        P[i, idx] = _search_beta(d2[i, idx], target, tol, max_tries)
    P = (P + P.T) / (2 * n)
    return np.maximum(P, 1e-12)


# ------------------------------------------------------------- exact stepper
@monitored_jit(name="clustering/tsne_step")
def _tsne_step(y, P, gains, vel, lr, momentum):
    """(y, gains, vel, kl) after one exact gradient step on y's device."""
    sq = (y ** 2).sum(1)
    d2 = sq[:, None] - 2 * y @ y.T + sq[None, :]
    num = 1.0 / (1.0 + d2)
    num = num - torch.diag(torch.diag(num))
    Q = torch.clamp(num / num.sum(), min=1e-12)
    PQ = (P - Q) * num
    grad = 4.0 * (torch.diag(PQ.sum(1)) - PQ) @ y
    gains = torch.where(torch.sign(grad) != torch.sign(vel), gains + 0.2, gains * 0.8)
    gains = gains.clamp(min=0.01)
    vel = momentum * vel - lr * gains * grad
    y = y + vel
    y = y - y.mean(0)
    kl = (P * torch.log(P / Q)).sum()
    return y, gains, vel, kl


class Tsne:
    """Exact t-SNE (reference ``plot/Tsne.java``); its steps run on
    ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 momentum: float = 0.8, early_exaggeration: float = 12.0,
                 seed: int = 123, device="cuda"):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.momentum = momentum
        self.early_exaggeration = early_exaggeration
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_ = None

    def _affinities(self, x) -> np.ndarray:
        """The symmetrised input affinities P [n, n], float64 on the host."""
        n = len(x)
        d2 = ((x ** 2).sum(1)[:, None] - 2 * x @ x.T + (x ** 2).sum(1)[None, :])
        return _binary_search_p(d2, min(self.perplexity, (n - 1) / 3))

    def _initial_state(self, n):
        """(y, gains, vel) on the device: y from the seed's normal draws."""
        rng = np.random.default_rng(self.seed)
        y = torch.as_tensor(rng.normal(scale=1e-4, size=(n, self.n_components)),
                            dtype=torch.float32).to(self.device)
        return y, torch.ones_like(y), torch.zeros_like(y)

    def fit_transform(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        P = torch.as_tensor(self._affinities(x), dtype=torch.float32).to(self.device)
        y, gains, vel = self._initial_state(len(x))
        exag_until = min(250, self.n_iter // 2)
        P_exag = P * self.early_exaggeration
        kl = None
        for it in range(self.n_iter):
            early = it < exag_until
            y, gains, vel, kl = _tsne_step(y, P_exag if early else P, gains, vel,
                                           self.learning_rate, 0.5 if early else self.momentum)
        self.kl_ = None if kl is None else float(kl)
        return y.cpu().numpy()

    fitTransform = fit_transform


class BarnesHutTsne(Tsne):
    """Barnes-Hut t-SNE (reference ``plot/BarnesHutTsne.java``): sparse
    attractive forces over a kNN graph (VPTree, 3·perplexity neighbors) and
    SpTree-approximated repulsive forces with the theta condition."""

    def __init__(self, theta: float = 0.5, **kw):
        # the host-loop BH dynamics are stabler at a lower rate than the
        # exact stepper's default
        kw.setdefault("learning_rate", 100.0)
        super().__init__(**kw)
        self.theta = theta

    def fit_transform(self, x) -> np.ndarray:
        if self.theta <= 0:
            return super().fit_transform(x)
        x = np.asarray(x, np.float64)
        n = len(x)
        k = min(int(3 * self.perplexity), n - 1)
        tree = VPTree(x, seed=self.seed)
        rows = np.zeros((n, k), np.int64)
        d2 = np.zeros((n, k))
        for i in range(n):
            idxs, dists = tree.search(x[i], k + 1)
            sel = [(j, dd) for j, dd in zip(idxs, dists) if j != i][:k]
            rows[i] = [j for j, _ in sel]
            d2[i] = [dd ** 2 for _, dd in sel]
        # per-row perplexity search on the kNN distances
        P = {}
        target = np.log(min(self.perplexity, (n - 1) / 3))
        for i in range(n):
            p = _search_beta(d2[i], target)
            for jpos, j in enumerate(rows[i]):
                P[(i, int(j))] = P.get((i, int(j)), 0.0) + p[jpos] / (2 * n)
                P[(int(j), i)] = P.get((int(j), i), 0.0) + p[jpos] / (2 * n)

        pairs = np.asarray(list(P.keys()), np.int64)
        pvals = np.asarray(list(P.values()))
        rng = np.random.default_rng(self.seed)
        y = rng.normal(scale=1e-4, size=(n, self.n_components))
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        exag_until = min(250, self.n_iter // 2)
        for it in range(self.n_iter):
            exag = self.early_exaggeration if it < exag_until else 1.0
            mom = 0.5 if it < exag_until else self.momentum
            # attractive (sparse, exact)
            diff = y[pairs[:, 0]] - y[pairs[:, 1]]
            qz = 1.0 / (1.0 + (diff ** 2).sum(1))
            att = np.zeros_like(y)
            np.add.at(att, pairs[:, 0],
                      (exag * pvals * qz)[:, None] * diff)
            # repulsive (Barnes-Hut via SpTree)
            sptree = SpTree(y)
            rep = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                neg, sq = sptree.compute_non_edge_forces(i, self.theta)
                rep[i] = neg
                sum_q += sq
            grad = 4.0 * (att - rep / max(sum_q, 1e-12))
            gains = np.where(np.sign(grad) != np.sign(vel), gains + 0.2,
                             gains * 0.8)
            gains = np.maximum(gains, 0.01)
            vel = mom * vel - self.learning_rate * gains * grad
            y = y + vel
            y = y - y.mean(axis=0)
        return y
