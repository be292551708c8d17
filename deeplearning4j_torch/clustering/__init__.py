"""Nearest neighbours and clustering (reference nearestneighbors-parent and
core t-SNE).

Counterpart of ``deeplearning4j_tpu/clustering/``: VPTree, KDTree, QuadTree
and SpTree on the host (``trees.py``), k-means with its Lloyd steps on the
card (``kmeans.py``), exact t-SNE with its steps on the card and
Barnes-Hut t-SNE on the host (``tsne.py``), and the nearest-neighbours
HTTP server and client (``server.py``).
"""
from .trees import VPTree, KDTree, QuadTree, SpTree
from .kmeans import KMeansClustering, ClusterSet, Cluster
from .tsne import Tsne, BarnesHutTsne
from .server import NearestNeighborsServer, NearestNeighborsClient

__all__ = ["VPTree", "KDTree", "QuadTree", "SpTree", "KMeansClustering",
           "ClusterSet", "Cluster", "Tsne", "BarnesHutTsne", "NearestNeighborsServer",
           "NearestNeighborsClient"]
