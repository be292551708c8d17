"""K-means clustering with Lloyd steps on the card.

Counterpart of ``deeplearning4j_tpu/clustering/kmeans.py`` (reference
``clustering/kmeans/KMeansClustering.java``): each Lloyd iteration
(:func:`_assign_update`: the [n, k] squared distances by the GEMM formula,
argmin, inertia, then the counts and sums by a one-hot product) runs on
``device`` in f32, as the JAX package's jitted step does; the points stay
resident there for the whole fit.

The k-means++ initialisation keeps each point's squared distance to its
nearest pick as a running minimum, where the JAX package restacks every
pick's distances at each new pick (O(k^2 n d) on the host): a minimum is
exact, so the values are the same. On the CPU each distance row is numpy
f32 exactly as the JAX package computes it, so the picks are JAX's. On the
card the rows come from the card and only the pick probabilities cross to
the host for the same numpy generator; the card's rounding of a row's sum
can move a pick there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..monitor.jitwatch import monitored_jit

__all__ = ["KMeansClustering", "ClusterSet", "Cluster"]


@monitored_jit(name="clustering/kmeans_step")
def _assign_update(points, centroids):
    """(assignments, new centroids, inertia): one Lloyd iteration on the
    points' device. An empty cluster keeps its centroid."""
    d2 = ((points ** 2).sum(1)[:, None] - 2.0 * points @ centroids.T
          + (centroids ** 2).sum(1)[None, :])
    assign = d2.argmin(1)
    inertia = d2.gather(1, assign[:, None]).sum()
    k = centroids.shape[0]
    onehot = F.one_hot(assign, k).to(points.dtype)              # [n, k]
    counts = onehot.sum(0)                                       # [k]
    sums = onehot.T @ points                                     # [k, d]
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / counts.clamp(min=1.0)[:, None], centroids)
    return assign, new_centroids, inertia


class Cluster:
    def __init__(self, center: np.ndarray, points: np.ndarray, indices: np.ndarray):
        self.center = center
        self.points = points
        self.indices = indices


class ClusterSet:
    """The fit's result, in numpy: centroids [k, d], assignments [n],
    the points and the final inertia."""

    def __init__(self, centroids: np.ndarray, assignments: np.ndarray, points: np.ndarray,
                 inertia: float):
        self.centroids = centroids
        self.assignments = assignments
        self.points = points
        self.inertia = inertia

    def get_clusters(self):
        out = []
        for i in range(len(self.centroids)):
            sel = np.flatnonzero(self.assignments == i)
            out.append(Cluster(self.centroids[i], self.points[sel], sel))
        return out

    getClusters = get_clusters

    def nearest_cluster(self, point) -> int:
        d = np.linalg.norm(self.centroids - np.asarray(point), axis=1)
        return int(np.argmin(d))

    nearestCluster = nearest_cluster


class KMeansClustering:
    """Reference ``KMeansClustering.setup(k, maxIterations, distance)``; the
    Lloyd steps run on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4, seed: int = 123,
                 device="cuda"):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)

    @staticmethod
    def setup(k: int, max_iterations: int = 100, distance: str = "euclidean", seed: int = 123,
              device="cuda"):
        if distance not in ("euclidean", "sqeuclidean"):
            raise ValueError("Only euclidean distance is supported")
        return KMeansClustering(k, max_iterations, seed=seed, device=device)

    def apply_to(self, points) -> ClusterSet:
        """Lloyd's algorithm from a k-means++ start, until the inertia moves
        by at most ``tol`` relative or ``max_iterations`` are done."""
        x = np.asarray(points, np.float32)
        rng = np.random.default_rng(self.seed)
        xt = torch.as_tensor(x).to(self.device)
        ct = self._kmeans_pp_init(x, xt, rng)
        prev_inertia = np.inf
        self.iterations_ = 0
        for _ in range(self.max_iterations):
            assign, ct, inertia = _assign_update(xt, ct)
            inertia = float(inertia)
            self.iterations_ += 1
            if abs(prev_inertia - inertia) <= self.tol * max(abs(inertia), 1.0):
                break
            prev_inertia = inertia
        return ClusterSet(ct.cpu().numpy(), assign.cpu().numpy(), x, inertia)

    applyTo = apply_to

    def _kmeans_pp_init(self, x, xt, rng) -> torch.Tensor:
        """k-means++ picks as [k, d] on the device: each next pick drawn with
        probability proportional to the squared distance to the nearest
        pick so far (a running minimum); uniformly when every point
        coincides with a pick."""
        n = len(x)
        picks = [int(rng.integers(0, n))]
        on_cpu = self.device.type == "cpu"
        d2 = None
        for _ in range(1, self.k):
            if on_cpu:
                row = np.sum((x - x[picks[-1]]) ** 2, axis=1)
                d2 = row if d2 is None else np.minimum(d2, row)
                total = d2.sum()
                p = d2 / total if total > 0 else None
            else:
                row = ((xt - xt[picks[-1]]) ** 2).sum(1)
                d2 = row if d2 is None else torch.minimum(d2, row)
                total = float(d2.sum())
                p = (d2 / total).cpu().numpy() if total > 0 else None
            if p is None:   # all remaining points coincide with centroids
                picks.append(int(rng.integers(0, n)))
                continue
            picks.append(int(rng.choice(n, p=p)))
        return xt[torch.as_tensor(picks, device=self.device)].clone()
