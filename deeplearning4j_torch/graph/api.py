"""Graph API (reference ``deeplearning4j-graph``'s ``IGraph``/``Graph``).

Counterpart of ``deeplearning4j_tpu/graph/api.py``: vertices with optional
values, directed or undirected weighted edges, adjacency queries. Host
Python.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple


@dataclass
class Vertex:
    idx: int
    value: Any = None


@dataclass
class Edge:
    frm: int
    to: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """Adjacency-list graph (reference ``Graph.java``)."""

    def __init__(self, num_vertices: int, directed: bool = False):
        self.directed = directed
        self.vertices = [Vertex(i) for i in range(num_vertices)]
        self._adj: List[List[Tuple[int, float]]] = [[] for _ in range(num_vertices)]

    def num_vertices(self) -> int:
        return len(self.vertices)

    numVertices = num_vertices

    def add_edge(self, frm: int, to: int, weight: float = 1.0,
                 directed: Optional[bool] = None):
        directed = self.directed if directed is None else directed
        self._adj[frm].append((to, weight))
        if not directed:
            self._adj[to].append((frm, weight))
        return self

    addEdge = add_edge

    def get_connected_vertices(self, idx: int) -> List[int]:
        return [t for t, _ in self._adj[idx]]

    getConnectedVertices = get_connected_vertices

    def get_connected_with_weights(self, idx: int) -> List[Tuple[int, float]]:
        return list(self._adj[idx])

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def get_vertex(self, idx: int) -> Vertex:
        return self.vertices[idx]

    getVertex = get_vertex
