"""Random-walk iterators (reference ``RandomWalkIterator.java`` and
``WeightedRandomWalkGraphIteratorProvider``).

Counterpart of ``deeplearning4j_tpu/graph/walks.py``: uniform,
edge-weighted and node2vec (p/q second-order) walks with the reference's
NoEdgeHandling (a self-loop at a dead end). Host numpy: the same seed gives
the same walks as the JAX package. Each pass over the walks reads the
graph's adjacency once into per-vertex neighbour lists (and, weighted, the
transition probabilities at a vertex's first visit), where the JAX package
rebuilds them at every step; the draws are the same.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .api import Graph


class RandomWalkIterator:
    """Uniform random walks of fixed length from every vertex."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 123,
                 walks_per_vertex: int = 1):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.walks_per_vertex = walks_per_vertex

    def _next_vertex(self, rng, current: int) -> int:
        nbrs = self._nbrs[current]
        if not nbrs:
            return current  # SELF_LOOP_ON_DISCONNECTED
        return int(nbrs[rng.integers(0, len(nbrs))])

    def _read_graph(self):
        """The adjacency as it stands when a pass starts."""
        self._nbrs = [self.graph.get_connected_vertices(i)
                      for i in range(self.graph.num_vertices())]

    def __iter__(self) -> Iterator[List[int]]:
        self._read_graph()
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                cur = start
                for _ in range(self.walk_length - 1):
                    cur = self._next_vertex(rng, cur)
                    walk.append(cur)
                yield walk


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional transition probabilities."""

    def _read_graph(self):
        super()._read_graph()
        self._p = {}

    def _next_vertex(self, rng, current: int) -> int:
        nbrs = self._nbrs[current]
        if not nbrs:
            return current
        p = self._p.get(current)
        if p is None:
            weights = np.asarray([w for _, w in self.graph.get_connected_with_weights(current)],
                                 np.float64)
            p = self._p[current] = weights / weights.sum()
        return int(nbrs[rng.choice(len(nbrs), p=p)])


class Node2VecWalkIterator(RandomWalkIterator):
    """Second-order biased walks (node2vec, Grover & Leskovec 2016; reference
    ``models/node2vec/Node2Vec.java:34`` drives them through a GraphWalker).

    Transition weight from the previous vertex ``t`` through current ``v`` to
    neighbor ``x``: ``1/p`` to return (x == t), ``1`` when x is also a
    neighbor of t (BFS-ish), ``1/q`` otherwise (DFS-ish). ``p`` high + ``q``
    low → outward exploration; ``p`` low → local backtracking walks.
    """

    def __init__(self, graph: Graph, walk_length: int, p: float = 1.0,
                 q: float = 1.0, seed: int = 123, walks_per_vertex: int = 1):
        super().__init__(graph, walk_length, seed, walks_per_vertex)
        self.p = float(p)
        self.q = float(q)
        # neighbor sets for the dist(t, x) == 1 test
        self._nbr_sets = [set(graph.get_connected_vertices(i))
                          for i in range(graph.num_vertices())]

    def _biased_next(self, rng, prev: Optional[int], current: int) -> int:
        nbrs = self._nbrs[current]
        if not nbrs:
            return current  # SELF_LOOP_ON_DISCONNECTED
        if prev is None:
            return int(nbrs[rng.integers(0, len(nbrs))])
        w = np.empty(len(nbrs), np.float64)
        prev_nbrs = self._nbr_sets[prev]
        for i, x in enumerate(nbrs):
            if x == prev:
                w[i] = 1.0 / self.p
            elif x in prev_nbrs:
                w[i] = 1.0
            else:
                w[i] = 1.0 / self.q
        w /= w.sum()
        return int(nbrs[rng.choice(len(nbrs), p=w)])

    def __iter__(self) -> Iterator[List[int]]:
        self._read_graph()
        rng = np.random.default_rng(self.seed)
        for _ in range(self.walks_per_vertex):
            for start in range(self.graph.num_vertices()):
                walk = [start]
                prev: Optional[int] = None
                cur = start
                for _ in range(self.walk_length - 1):
                    nxt = self._biased_next(rng, prev, cur)
                    prev, cur = cur, nxt
                    walk.append(cur)
                yield walk
