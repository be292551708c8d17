"""The port's graph embeddings on the CPU, against the JAX package.

Walks are host numpy: the same seed must give the same walks, step for step,
as the JAX package's (uniform, edge-weighted, and node2vec at low p and at
low q). The loaders build the same adjacency. DeepWalk and Node2Vec train
through the port's SequenceVectors (hierarchical softmax) and must give the
JAX package's vertex vectors at FIT_ATOL (f32 sums in another order over a
few hundred batches); ``tests/test_graph_clustering.py``'s and
``tests/test_node2vec_tfidf.py``'s clustering and walk-bias checks run on
the port.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as J
import deeplearning4j_torch.graph as P

FIT_ATOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _two_cliques(M, k=6):
    g = M.Graph(2 * k)
    for a in range(k):
        for b in range(a + 1, k):
            g.add_edge(a, b)
            g.add_edge(k + a, k + b)
    g.add_edge(0, k)
    return g


def _line_with_triangle(M):
    g = M.Graph(6)
    for a, b in [(0, 1), (1, 2), (0, 2), (2, 3), (3, 4), (4, 5)]:
        g.add_edge(a, b, 1.0, False)
    return g


def _weighted(M):
    g = M.Graph(5)
    for a, b, w in [(0, 1, 5.0), (0, 2, 0.5), (1, 2, 2.0), (2, 3, 1.0), (3, 4, 0.1), (4, 0, 3.0)]:
        g.add_edge(a, b, w)
    return g


@pytest.mark.parametrize("kind", ["uniform", "weighted", "node2vec_low_p", "node2vec_low_q"])
def test_walks_equal_jax_from_the_same_seed(kind):
    def walks(M):
        if kind == "uniform":
            it = M.RandomWalkIterator(_two_cliques(M, 4), 9, seed=3, walks_per_vertex=3)
        elif kind == "weighted":
            it = M.WeightedRandomWalkIterator(_weighted(M), 7, seed=4, walks_per_vertex=5)
        else:
            p, q = (0.05, 1.0) if kind == "node2vec_low_p" else (1.0, 0.1)
            it = M.Node2VecWalkIterator(_line_with_triangle(M), 12, p=p, q=q, seed=5,
                                        walks_per_vertex=6)
        return list(it)
    got, want = walks(P), walks(J)
    assert got == want and len(got) > 10


def test_walks_read_the_graph_as_each_pass_starts():
    """An iterator reads the adjacency once a pass: an edge added between
    passes is walked in the next, as the JAX package's per-step reads do."""
    walks = {}
    for M in (P, J):
        g = _weighted(M)
        it = M.WeightedRandomWalkIterator(g, 6, seed=7, walks_per_vertex=2)
        first = list(it)
        g.add_edge(3, 1, 9.0)
        walks[M] = (first, list(it))
    assert walks[P] == walks[J] and walks[P][0] != walks[P][1]


def test_graph_api_and_loaders_match_jax(tmp_path):
    g = _two_cliques(P, 4)
    assert g.num_vertices() == 8 and set(g.get_connected_vertices(1)) == {0, 2, 3}
    assert g.degree(0) == 4 and g.get_vertex(2).idx == 2
    d = P.Graph(3, directed=True).add_edge(0, 1)
    assert d.get_connected_vertices(1) == []
    p = tmp_path / "edges.txt"
    p.write_text("# comment\n0 1\n1 2\n\n2 0\n")
    pw = tmp_path / "weighted.csv"
    pw.write_text("0,1,2.5\n1,2,1.0\n")
    for loader in ("load_undirected_graph_edge_list_file",):
        pg, jg = (getattr(M.GraphLoader, loader)(str(p), 3) for M in (P, J))
        assert [pg.get_connected_vertices(i) for i in range(3)] == [
            jg.get_connected_vertices(i) for i in range(3)]
    for directed in (False, True):
        pg, jg = (M.GraphLoader.load_weighted_edge_list_file(str(pw), 3, directed=directed)
                  for M in (P, J))
        assert [pg.get_connected_with_weights(i) for i in range(3)] == [
            jg.get_connected_with_weights(i) for i in range(3)]


def _vertex_vectors(gv, n):
    return np.stack([gv.get_vertex_vector(i) for i in range(n)])


def test_deepwalk_vectors_match_jax():
    def fit(M):
        b = (M.DeepWalk.builder().vector_size(16).window_size(3).walk_length(20)
             .walks_per_vertex(8).epochs(3).seed(2))
        if M is P:
            b = b.device("cpu")
        return b.build().fit(_two_cliques(M, 6))
    port, jax_gv = fit(P), fit(J)
    np.testing.assert_allclose(_vertex_vectors(port, 12), _vertex_vectors(jax_gv, 12),
                               rtol=0, atol=FIT_ATOL)
    assert port.similarity(1, 2) > port.similarity(1, 8)       # same clique beats across
    assert port.get_vertex_vector(3).shape == (16,)
    assert port.verticies_nearest(1, 3) == jax_gv.verticies_nearest(1, 3)


def test_node2vec_vectors_match_jax():
    def fit(M):
        b = (M.Node2Vec.builder().vector_size(16).walk_length(10).walks_per_vertex(8)
             .p(1.0).q(0.5).epochs(3).seed(11))
        if M is P:
            b = b.device("cpu")
        return b.build().fit(_line_with_triangle(M))
    port, jax_gv = fit(P), fit(J)
    np.testing.assert_allclose(_vertex_vectors(port, 6), _vertex_vectors(jax_gv, 6),
                               rtol=0, atol=FIT_ATOL)
    assert port.similarity(0, 1) > port.similarity(0, 5)


def test_node2vec_walk_biases_on_the_port():
    g = _line_with_triangle(P)

    def return_rate(p):
        returns = steps = 0
        for walk in P.Node2VecWalkIterator(g, 20, p=p, q=1.0, seed=5, walks_per_vertex=20):
            steps += len(walk) - 2
            returns += sum(walk[i] == walk[i - 2] for i in range(2, len(walk)))
        return returns / steps
    assert return_rate(0.05) > 2 * return_rate(20.0)

    def far_visit_rate(q):
        far = total = 0
        for walk in P.Node2VecWalkIterator(g, 12, p=1.0, q=q, seed=9, walks_per_vertex=30):
            if walk[0] in (0, 1, 2):
                total += 1
                far += any(v in (4, 5) for v in walk)
        return far / total
    assert far_visit_rate(0.1) > far_visit_rate(10.0)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.DeepWalk.builder().build()
    with pytest.raises(RuntimeError, match="CUDA"):
        P.Node2Vec()
