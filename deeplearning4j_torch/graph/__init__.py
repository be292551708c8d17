"""Graph embeddings (reference ``deeplearning4j-graph``).

Counterpart of ``deeplearning4j_tpu/graph/``: the graph API, loaders,
random-walk iterators, DeepWalk, GraphVectors and Node2Vec.
"""
from .api import Graph, Vertex, Edge
from .loaders import GraphLoader
from .walks import (RandomWalkIterator, WeightedRandomWalkIterator,
                    Node2VecWalkIterator)
from .deepwalk import DeepWalk, GraphVectors
from .node2vec import Node2Vec

__all__ = ["Graph", "Vertex", "Edge", "GraphLoader", "RandomWalkIterator",
           "WeightedRandomWalkIterator", "Node2VecWalkIterator", "DeepWalk",
           "GraphVectors", "Node2Vec"]
