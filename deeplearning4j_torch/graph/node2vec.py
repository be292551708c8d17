"""Node2Vec: vertex embeddings from p/q-biased second-order walks.

Counterpart of ``deeplearning4j_tpu/graph/node2vec.py`` (reference
``models/node2vec/Node2Vec.java``): DeepWalk's engine path with the walks
of :class:`~deeplearning4j_torch.graph.walks.Node2VecWalkIterator`, trained
on ``device``, the card unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional

from .api import Graph
from .deepwalk import GraphVectors
from .walks import Node2VecWalkIterator
from ..nlp.sequencevectors import SequenceVectors


class Node2Vec:
    """Builder surface mirrors DeepWalk plus the node2vec ``p``/``q`` knobs
    (reference ``Node2Vec.Builder`` wires a walker + VectorsConfiguration)."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._walk_length = 40
            self._walks_per_vertex = 4
            self._p = 1.0
            self._q = 1.0

        def vector_size(self, n):
            self._kw["vector_length"] = int(n)
            return self

        vectorSize = vector_size

        def window_size(self, n):
            self._kw["window"] = int(n)
            return self

        windowSize = window_size

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v)
            return self

        learningRate = learning_rate

        def walk_length(self, n):
            self._walk_length = int(n)
            return self

        walkLength = walk_length

        def walks_per_vertex(self, n):
            self._walks_per_vertex = int(n)
            return self

        def p(self, v):
            self._p = float(v)
            return self

        def q(self, v):
            self._q = float(v)
            return self

        def seed(self, n):
            self._kw["seed"] = int(n)
            return self

        def epochs(self, n):
            self._kw["epochs"] = int(n)
            return self

        def device(self, dev):
            """Where the embedding trains: "cuda" (the default) or "cpu"."""
            self._kw["device"] = dev
            return self

        def build(self) -> "Node2Vec":
            return Node2Vec(walk_length=self._walk_length,
                            walks_per_vertex=self._walks_per_vertex,
                            p=self._p, q=self._q, **self._kw)

    @staticmethod
    def builder():
        return Node2Vec.Builder()

    def __init__(self, walk_length: int = 40, walks_per_vertex: int = 4,
                 p: float = 1.0, q: float = 1.0, **kw):
        kw.setdefault("min_word_frequency", 1)
        self._sv = SequenceVectors(**kw)
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.p = float(p)
        self.q = float(q)

    @property
    def vector_size(self):
        return self._sv.vector_length

    def fit(self, graph: Graph,
            walk_iterator: Optional[Node2VecWalkIterator] = None
            ) -> GraphVectors:
        it = walk_iterator or Node2VecWalkIterator(
            graph, self.walk_length, p=self.p, q=self.q, seed=self._sv.seed,
            walks_per_vertex=self.walks_per_vertex)

        def provider():
            for walk in it:
                yield [str(v) for v in walk]

        self._sv.fit(provider)
        return GraphVectors(self._sv, graph)
