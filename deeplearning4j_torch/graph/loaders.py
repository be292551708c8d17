"""Graph loaders (reference ``deeplearning4j-graph``'s ``graph/data/``).

Counterpart of ``deeplearning4j_tpu/graph/loaders.py``: edge-list and
weighted edge-list text files.
"""
from __future__ import annotations

from .api import Graph


class GraphLoader:
    @staticmethod
    def load_undirected_graph_edge_list_file(path: str, num_vertices: int,
                                             delimiter: str = None) -> Graph:
        """Each line: ``from to`` (reference
        ``GraphLoader.loadUndirectedGraphEdgeListFile``)."""
        g = Graph(num_vertices, directed=False)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                g.add_edge(int(parts[0]), int(parts[1]))
        return g

    loadUndirectedGraphEdgeListFile = load_undirected_graph_edge_list_file

    @staticmethod
    def load_weighted_edge_list_file(path: str, num_vertices: int,
                                     delimiter: str = ",",
                                     directed: bool = False) -> Graph:
        """Each line: ``from,to,weight`` (reference
        ``loadWeightedEdgeListFile``)."""
        g = Graph(num_vertices, directed=directed)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(delimiter)
                g.add_edge(int(parts[0]), int(parts[1]), float(parts[2]),
                           directed=directed)
        return g

    loadWeightedEdgeListFile = load_weighted_edge_list_file
