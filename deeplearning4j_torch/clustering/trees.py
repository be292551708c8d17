"""Spatial trees: VPTree, KDTree, QuadTree, SpTree.

Counterpart of ``deeplearning4j_tpu/clustering/trees.py`` (reference
``nearestneighbor-core/.../clustering/``: ``vptree/VPTree.java``,
``kdtree/KDTree.java``, ``quadtree/QuadTree.java``, ``sptree/SpTree.java``,
the Barnes-Hut tree of t-SNE). A host numpy copy: construction is host
recursion and the searches' distance evaluations are vectorised numpy, with
the same ``np.random.default_rng(seed)`` draws, so the same trees and
answers as the JAX package's.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------------- VPTree
class VPTree:
    """Vantage-point tree for metric kNN (reference ``VPTree.java``;
    euclidean / cosine similarity like the reference's distance functions)."""

    class _Node:
        __slots__ = ("index", "threshold", "left", "right")

        def __init__(self, index):
            self.index = index
            self.threshold = 0.0
            self.left = None
            self.right = None

    def __init__(self, items: np.ndarray, distance: str = "euclidean",
                 seed: int = 123):
        self.items = np.asarray(items, np.float64)
        self.distance = distance
        self._rng = np.random.default_rng(seed)
        idx = list(range(len(self.items)))
        self.root = self._build(idx)

    def _dist(self, a_idx: int, points: np.ndarray) -> np.ndarray:
        a = self.items[a_idx]
        if self.distance == "cosine":
            na = np.linalg.norm(a) or 1e-12
            nb = np.linalg.norm(points, axis=1)
            return 1.0 - points @ a / (na * np.maximum(nb, 1e-12))
        return np.linalg.norm(points - a, axis=1)

    def _build(self, idx: List[int]):
        if not idx:
            return None
        if len(idx) == 1:
            return VPTree._Node(idx[0])
        vp_pos = int(self._rng.integers(0, len(idx)))
        idx[0], idx[vp_pos] = idx[vp_pos], idx[0]
        vp = idx[0]
        rest = idx[1:]
        d = self._dist(vp, self.items[rest])
        median = float(np.median(d))
        node = VPTree._Node(vp)
        node.threshold = median
        inner = [rest[i] for i in range(len(rest)) if d[i] <= median]
        outer = [rest[i] for i in range(len(rest)) if d[i] > median]
        node.left = self._build(inner)
        node.right = self._build(outer)
        return node

    def _dist_point(self, q: np.ndarray, idx: int) -> float:
        p = self.items[idx]
        if self.distance == "cosine":
            nq = np.linalg.norm(q) or 1e-12
            np_ = np.linalg.norm(p) or 1e-12
            return float(1.0 - q @ p / (nq * np_))
        return float(np.linalg.norm(q - p))

    def search(self, query, k: int) -> Tuple[List[int], List[float]]:
        """k nearest (indices, distances) — reference ``search(INDArray, k,
        results, distances)``."""
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap via negation
        tau = [np.inf]

        def visit(node):
            if node is None:
                return
            d = self._dist_point(q, node.index)
            if d < tau[0] or len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) > k:
                    heapq.heappop(heap)
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            if node.left is None and node.right is None:
                return
            if d < node.threshold:
                visit(node.left)
                if d + tau[0] >= node.threshold:
                    visit(node.right)
            else:
                visit(node.right)
                if d - tau[0] <= node.threshold:
                    visit(node.left)

        visit(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in out], [d for d, _ in out]


# ------------------------------------------------------------------- KDTree
class KDTree:
    """Axis-aligned kd-tree (reference ``kdtree/KDTree.java``)."""

    class _Node:
        __slots__ = ("index", "axis", "left", "right")

        def __init__(self, index, axis):
            self.index = index
            self.axis = axis
            self.left = None
            self.right = None

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)
        self.dims = self.points.shape[1]
        self.root = self._build(list(range(len(self.points))), 0)

    def _build(self, idx: List[int], depth: int):
        if not idx:
            return None
        axis = depth % self.dims
        idx.sort(key=lambda i: self.points[i, axis])
        mid = len(idx) // 2
        node = KDTree._Node(idx[mid], axis)
        node.left = self._build(idx[:mid], depth + 1)
        node.right = self._build(idx[mid + 1:], depth + 1)
        return node

    def nn(self, query) -> Tuple[int, float]:
        idxs, dists = self.knn(query, 1)
        return idxs[0], dists[0]

    def knn(self, query, k: int) -> Tuple[List[int], List[float]]:
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []

        def visit(node):
            if node is None:
                return
            d = float(np.linalg.norm(self.points[node.index] - q))
            if len(heap) < k or d < -heap[0][0]:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) > k:
                    heapq.heappop(heap)
            diff = q[node.axis] - self.points[node.index, node.axis]
            near, far = (node.left, node.right) if diff <= 0 else (node.right,
                                                                   node.left)
            visit(near)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far)

        visit(self.root)
        out = sorted(((-nd, i) for nd, i in heap))
        return [i for _, i in out], [d for d, _ in out]


# ------------------------------------------------------------ QuadTree/SpTree
class SpTree:
    """n-dimensional Barnes-Hut tree (reference ``sptree/SpTree.java``):
    center-of-mass aggregation per cell; used by t-SNE's repulsive-force
    approximation. 2-D instance ≡ the reference's QuadTree."""

    MAX_LEAF = 8

    class _Cell:
        __slots__ = ("center", "width", "children", "indices", "com", "mass")

        def __init__(self, center, width):
            self.center = center          # [d]
            self.width = width            # [d] half-extent
            self.children = None
            self.indices: List[int] = []
            self.com = np.zeros_like(center)
            self.mass = 0

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float64)
        lo = self.data.min(axis=0)
        hi = self.data.max(axis=0)
        center = (lo + hi) / 2
        width = np.maximum((hi - lo) / 2, 1e-9) * (1 + 1e-6)
        self.root = SpTree._Cell(center, width)
        for i in range(len(self.data)):
            self._insert(self.root, i)

    def _insert(self, cell, i):
        cell.mass += 1
        cell.com += (self.data[i] - cell.com) / cell.mass
        if cell.children is None:
            cell.indices.append(i)
            if len(cell.indices) > self.MAX_LEAF and np.all(cell.width > 1e-12):
                self._subdivide(cell)
            return
        self._insert(cell.children[self._child_of(cell, i)], i)

    def _child_of(self, cell, i) -> int:
        code = 0
        for d in range(self.data.shape[1]):
            if self.data[i, d] > cell.center[d]:
                code |= 1 << d
        return code

    def _subdivide(self, cell):
        d = self.data.shape[1]
        cell.children = []
        for code in range(1 << d):
            offset = np.array([(1 if code >> k & 1 else -1)
                               for k in range(d)], np.float64)
            child = SpTree._Cell(cell.center + offset * cell.width / 2,
                                 cell.width / 2)
            cell.children.append(child)
        idxs = cell.indices
        cell.indices = []
        for i in idxs:
            child = cell.children[self._child_of(cell, i)]
            child.mass += 1
            child.com += (self.data[i] - child.com) / child.mass
            child.indices.append(i)
        for child in cell.children:
            # width guard stops infinite subdivision when > MAX_LEAF points
            # coincide (duplicate rows) — same guard as _insert
            if (len(child.indices) > self.MAX_LEAF
                    and np.all(child.width > 1e-12)):
                self._subdivide(child)

    # -------------------------------------------------------------- queries
    def compute_non_edge_forces(self, point_idx: int, theta: float
                                ) -> Tuple[np.ndarray, float]:
        """Barnes-Hut negative-force accumulation for t-SNE (reference
        ``SpTree.computeNonEdgeForces``): returns (neg_force[d], sum_Q
        contribution)."""
        q = self.data[point_idx]
        neg = np.zeros_like(q)
        sum_q = 0.0
        stack = [self.root]
        while stack:
            cell = stack.pop()
            if cell.mass == 0:
                continue
            diff = q - cell.com
            dist2 = float(diff @ diff)
            max_width = float(cell.width.max() * 2)
            if (cell.children is not None and dist2 > 0
                    and max_width / np.sqrt(dist2) < theta):
                # far enough: the whole cell acts as one point at its COM
                qq = 1.0 / (1.0 + dist2)
                sum_q += cell.mass * qq
                neg += cell.mass * qq * qq * diff
            elif cell.children is not None:
                stack.extend(cell.children)
            else:
                # leaf: exact accumulation over its points (minus self) —
                # COM-approximating near leaves corrupts the repulsion as
                # soon as clusters tighten
                for i in cell.indices:
                    if i == point_idx:
                        continue
                    df = q - self.data[i]
                    d2 = float(df @ df)
                    qq = 1.0 / (1.0 + d2)
                    sum_q += qq
                    neg += qq * qq * df
        return neg, sum_q


class QuadTree(SpTree):
    """2-D SpTree (reference ``quadtree/QuadTree.java``)."""

    def __init__(self, data):
        data = np.asarray(data)
        if data.shape[1] != 2:
            raise ValueError("QuadTree requires 2-D points")
        super().__init__(data)
