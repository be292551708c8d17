"""DeepWalk: vertex embeddings from random walks.

Counterpart of ``deeplearning4j_tpu/graph/deepwalk.py`` (reference
``graph/models/deepwalk/DeepWalk.java`` and ``GraphVectorsImpl``): random
walks become sentences of vertex-id tokens and train through the port's
SequenceVectors (hierarchical softmax over a Huffman tree of the walks'
vertex counts) on ``device``, the card unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .api import Graph
from .walks import RandomWalkIterator
from ..nlp.sequencevectors import SequenceVectors


class GraphVectors:
    """Query surface (reference ``GraphVectorsImpl``)."""

    def __init__(self, sv: SequenceVectors, graph: Graph):
        self._sv = sv
        self.graph = graph

    def get_vertex_vector(self, idx: int) -> Optional[np.ndarray]:
        return self._sv.word_vector(str(idx))

    getVertexVector = get_vertex_vector

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verticies_nearest(self, idx: int, n: int = 10) -> List[int]:
        return [int(w) for w in self._sv.words_nearest(str(idx), n)]

    verticesNearest = verticies_nearest


class DeepWalk:
    """Reference ``DeepWalk.Builder`` surface: walkLength, windowSize,
    vectorSize, learningRate; ``fit(graph)`` runs walks → embedding training."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._walk_length = 40
            self._walks_per_vertex = 4

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

        def build(self) -> "DeepWalk":
            return DeepWalk(walk_length=self._walk_length,
                            walks_per_vertex=self._walks_per_vertex,
                            **self._kw)

    @staticmethod
    def builder():
        return DeepWalk.Builder()

    def __init__(self, walk_length: int = 40, walks_per_vertex: int = 4, **kw):
        kw.setdefault("min_word_frequency", 1)
        self._sv = SequenceVectors(**kw)
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex

    @property
    def vector_size(self):
        return self._sv.vector_length

    def fit(self, graph: Graph, walk_iterator: Optional[RandomWalkIterator] = None
            ) -> GraphVectors:
        it = walk_iterator or RandomWalkIterator(
            graph, self.walk_length, seed=self._sv.seed,
            walks_per_vertex=self.walks_per_vertex)

        def provider():
            for walk in it:
                yield [str(v) for v in walk]

        self._sv.fit(provider)
        return GraphVectors(self._sv, graph)
