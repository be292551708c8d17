"""The port's clustering/ against the JAX package's.

Every clustering case of ``tests/test_graph_clustering.py`` (``:79-184``)
runs on the port (``device="cpu"``) and is held against the JAX package on
the same inputs:

- the trees and Barnes-Hut t-SNE are host numpy copies in both packages,
  so their answers and embeddings are bit-identical;
- the k-means++ picks are identical on the CPU route (each distance row
  is numpy f32 in both, the port keeps a running minimum: exact), and
  ``apply_to``'s centroids and inertia agree within 1e-6 relative;
- one Lloyd step (``_assign_update``) and one exact t-SNE step
  (``_tsne_step``) agree with JAX's jitted steps within 1e-5 relative;
- exact ``fit_transform`` at the JAX test's size (60 points, perplexity
  10, 300 iterations) keeps the separation oracle, and every step of its
  schedule agrees with JAX's from the same state; the two free-running
  f32 trajectories part within 20 steps, so ``kl_`` is held within 1e-3
  relative of JAX's over the first 10 iterations, not after 300.

The file keeps fewer tests than ``tests/test_alerts.py`` (22): xdist's
``--dist loadfile`` queues files largest first, and a new file ahead of it
in the queue moved it onto a worker whose earlier paramserver test had
left a stale worker in the JAX package's process-wide fleet table.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import clustering as jcl
from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu.clustering import tsne as jts

from deeplearning4j_torch import clustering as pcl
from deeplearning4j_torch.clustering import kmeans as pkm
from deeplearning4j_torch.clustering import tsne as pts_
from deeplearning4j_torch.clustering import (BarnesHutTsne, KDTree, KMeansClustering,
                                             NearestNeighborsClient, NearestNeighborsServer,
                                             QuadTree, SpTree, Tsne, VPTree)

STEP_RTOL = 1e-5
KMEANS_RTOL = 1e-6
KL_RTOL = 1e-3
SCHEDULE_YTOL = 1e-4


def _blobs(n=60, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n // 2, 3)) + np.array([5, 0, 0])
    b = rng.normal(size=(n // 2, 3)) - np.array([5, 0, 0])
    return np.concatenate([a, b])


def _separated(emb, n):
    h = n // 2
    ca, cb = emb[:h].mean(axis=0), emb[h:].mean(axis=0)
    spread_a = np.linalg.norm(emb[:h] - ca, axis=1).mean()
    return np.linalg.norm(ca - cb) > 2 * spread_a


def test_public_names_are_jax_s():
    assert pcl.__all__ == jcl.__all__


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    for make in (lambda: KMeansClustering.setup(2), lambda: Tsne(),
                 lambda: BarnesHutTsne()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ----------------------------------------------------------------------- trees
def test_vptree_matches_bruteforce_and_jax():
    pts = _blobs(80)
    q = pts[7] + 0.1
    idxs, dists = VPTree(pts).search(q, 5)
    brute = np.argsort(np.linalg.norm(pts - q, axis=1))[:5]
    assert set(idxs) == set(brute.tolist())
    assert dists == sorted(dists)
    assert (idxs, dists) == jcl.VPTree(pts).search(q, 5)
    # cosine distance
    pts = np.asarray([[1, 0], [0.9, 0.1], [0, 1.0], [-1, 0]], np.float64)
    q = np.array([1.0, 0.05])
    idxs, dists = VPTree(pts, distance="cosine").search(q, 2)
    assert set(idxs) == {0, 1}
    assert (idxs, dists) == jcl.VPTree(pts, distance="cosine").search(q, 2)


def test_kdtree_matches_bruteforce_and_jax():
    pts = _blobs(70, seed=1)
    q = np.array([4.0, 0.5, -0.5])
    tree = KDTree(pts)
    idxs, dists = tree.knn(q, 4)
    brute = np.argsort(np.linalg.norm(pts - q, axis=1))[:4]
    assert set(idxs) == set(brute.tolist())
    nn_idx, nn_d = tree.nn(q)
    assert nn_idx == brute[0]
    jt = jcl.KDTree(pts)
    assert (idxs, dists) == jt.knn(q, 4)
    assert (nn_idx, nn_d) == jt.nn(q)


def test_sptree_center_of_mass_and_forces_equal_jax():
    pts = _blobs(50, seed=2)
    tree, jtree = SpTree(pts), jcl.SpTree(pts)
    np.testing.assert_allclose(tree.root.com, pts.mean(axis=0), atol=1e-9)
    assert tree.root.mass == 50
    np.testing.assert_array_equal(tree.root.com, jtree.root.com)
    for i in range(50):
        neg, sq = tree.compute_non_edge_forces(i, 0.5)
        jneg, jsq = jtree.compute_non_edge_forces(i, 0.5)
        np.testing.assert_array_equal(neg, jneg)
        assert sq == jsq
    with pytest.raises(ValueError):
        QuadTree(pts)  # 3-D points rejected
    with pytest.raises(ValueError):
        jcl.QuadTree(pts)
    # more than MAX_LEAF coincident points must not blow the stack
    for cls in (SpTree, jcl.SpTree):
        assert cls(np.zeros((20, 2))).root.mass == 20


def test_quadtree_forces_equal_jax():
    pts = _blobs(40, seed=6)[:, :2]
    q, jq = QuadTree(pts), jcl.QuadTree(pts)
    for i in range(40):
        a, b = q.compute_non_edge_forces(i, 0.3), jq.compute_non_edge_forces(i, 0.3)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


# ---------------------------------------------------------------------- kmeans
def _jax_apply(k, max_iterations, pts, seed=123):
    return jcl.KMeansClustering.setup(k, max_iterations, seed=seed).apply_to(pts)


def test_kmeans_separates_blobs_like_jax():
    pts = _blobs(100, seed=3)
    cs = KMeansClustering.setup(2, max_iterations=50, device="cpu").apply_to(pts)
    a = set(cs.assignments[:50].tolist())
    b = set(cs.assignments[50:].tolist())
    assert len(a) == 1 and len(b) == 1 and a != b
    clusters = cs.get_clusters()
    assert sum(len(c.indices) for c in clusters) == 100
    assert cs.nearest_cluster([5, 0, 0]) == cs.assignments[0]
    j = _jax_apply(2, 50, pts)
    np.testing.assert_array_equal(cs.assignments, np.asarray(j.assignments))
    np.testing.assert_allclose(cs.centroids, j.centroids, rtol=KMEANS_RTOL)
    assert cs.inertia == pytest.approx(j.inertia, rel=KMEANS_RTOL)
    for c in clusters:
        assert isinstance(c.center, np.ndarray) and isinstance(c.points, np.ndarray)


@pytest.mark.parametrize("n,k,d,seed", [(500, 8, 5, 0), (2000, 32, 16, 1)])
def test_kmeans_pp_picks_equal_jax(n, k, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    km = KMeansClustering(k, seed=seed, device="cpu")
    mine = km._kmeans_pp_init(x, torch.as_tensor(x), np.random.default_rng(seed))
    jk = jcl.KMeansClustering(k, seed=seed)
    theirs = jk._kmeans_pp_init(x, np.random.default_rng(seed))
    np.testing.assert_array_equal(mine.numpy(), theirs)


@pytest.mark.parametrize("n,k,d,seed", [(300, 5, 4, 2), (1000, 12, 8, 3)])
def test_kmeans_apply_to_matches_jax(n, k, d, seed):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(k, d))
    x = (centres[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)
    cs = KMeansClustering.setup(k, 30, seed=seed, device="cpu").apply_to(x)
    j = _jax_apply(k, 30, x, seed=seed)
    np.testing.assert_array_equal(cs.assignments, np.asarray(j.assignments))
    np.testing.assert_allclose(cs.centroids, j.centroids, rtol=KMEANS_RTOL, atol=1e-6)
    assert cs.inertia == pytest.approx(j.inertia, rel=KMEANS_RTOL)
    assert cs.centroids.dtype == np.float32 and cs.assignments.shape == (n,)


def test_assign_update_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(400, 6)).astype(np.float32)
    c = rng.normal(size=(7, 6)).astype(np.float32)
    c[6] = 50.0     # a centroid no point is nearest to: it keeps its place
    a, nc, inertia = pkm._assign_update(torch.as_tensor(x), torch.as_tensor(c))
    ja, jnc, jinertia = jkm._assign_update(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(nc.numpy(), np.asarray(jnc), rtol=STEP_RTOL, atol=1e-6)
    assert float(inertia) == pytest.approx(float(jinertia), rel=STEP_RTOL)
    np.testing.assert_array_equal(nc[6].numpy(), c[6])


def test_kmeans_duplicate_points_no_crash():
    # all-identical points must not crash k-means++
    cs = KMeansClustering.setup(2, max_iterations=5, device="cpu").apply_to(np.zeros((10, 2)))
    j = _jax_apply(2, 5, np.zeros((10, 2)))
    assert len(cs.centroids) == 2
    np.testing.assert_array_equal(cs.centroids, j.centroids)
    np.testing.assert_array_equal(cs.assignments, np.asarray(j.assignments))


# ------------------------------------------------------------------------ tsne
def test_affinities_equal_jax():
    x = _blobs(40, seed=8)
    t = Tsne(perplexity=10, device="cpu")
    n = len(x)
    d2 = ((x ** 2).sum(1)[:, None] - 2 * x @ x.T + (x ** 2).sum(1)[None, :])
    np.testing.assert_array_equal(t._affinities(x), jts._binary_search_p(d2, min(10, (n - 1) / 3)))


@pytest.mark.parametrize("early", [True, False])
def test_tsne_step_matches_jax(early):
    rng = np.random.default_rng(9)
    n = 50
    x = _blobs(n, seed=9)
    t = Tsne(perplexity=10, device="cpu")
    P = t._affinities(x).astype(np.float32) * (12.0 if early else 1.0)
    y = rng.normal(scale=1.0, size=(n, 2)).astype(np.float32)
    gains = rng.uniform(0.5, 1.5, size=(n, 2)).astype(np.float32)
    vel = rng.normal(scale=0.1, size=(n, 2)).astype(np.float32)
    mom = 0.5 if early else 0.8
    mine = pts_._tsne_step(*(torch.as_tensor(a) for a in (y, P, gains, vel)), 200.0, mom)
    theirs = jts._tsne_step(*(jnp.asarray(a) for a in (y, P, gains, vel)),
                            jnp.float32(200.0), jnp.float32(mom))
    for m, j in zip(mine[:3], theirs[:3]):
        np.testing.assert_allclose(m.numpy(), np.asarray(j), rtol=STEP_RTOL,
                                   atol=STEP_RTOL * float(np.abs(np.asarray(j)).max()))
    assert float(mine[3]) == pytest.approx(float(theirs[3]), rel=STEP_RTOL)


def test_tsne_exact_separates_blobs_and_steps_like_jax():
    """JAX's test size: the separation oracle holds for both packages, and
    each of the 300 steps of the schedule, taken from JAX's own state,
    agrees with JAX's step, but for the points where a gain flipped (the
    sign of a near-zero gradient rounded the other way: at most one point
    in a thousand steps): kl within 1e-5 relative, y within 1e-4 of its
    largest entry. The gradient is a sum of terms that cancel, so a step's
    y parts by up to 1.6e-5 of its largest entry here (step 109); the
    single steps above hold 1e-5 from a random state. Their free-running kl_ do not agree within
    1e-3: the f32 trajectories part within 20 steps (a step's rounding,
    1e-8, grows about 3x a step under the early exaggeration) and settle
    in different minima (kl_ 0.548 here against JAX's 0.943)."""
    pts = _blobs(60, seed=4)
    t = Tsne(perplexity=10, n_iter=300, seed=4, device="cpu")
    emb = t.fit_transform(pts)
    assert emb.shape == (60, 2) and emb.dtype == np.float32
    assert _separated(emb, 60)
    assert _separated(np.asarray(jcl.Tsne(perplexity=10, n_iter=300, seed=4).fit_transform(pts)), 60)
    P = t._affinities(pts).astype(np.float32)
    jy, jg, jv = (jnp.asarray(a.numpy()) for a in t._initial_state(60))
    kinks = 0
    for it in range(300):
        early = it < 150
        Pi, mom = (P * np.float32(12.0), 0.5) if early else (P, 0.8)
        mine = pts_._tsne_step(*(torch.as_tensor(np.asarray(a)) for a in (jy, Pi, jg, jv)),
                               200.0, mom)
        jy, jg, jv, jkl = jts._tsne_step(jy, jnp.asarray(Pi), jg, jv, jnp.float32(200.0),
                                         jnp.float32(mom))
        # a gain flips where sign(grad) of a near-zero gradient rounds
        # the other way; the rest of the step must agree
        same = (mine[1].numpy() == np.asarray(jg)).all(1)
        kinks += int((~same).sum())
        np.testing.assert_allclose(mine[0].numpy()[same], np.asarray(jy)[same], rtol=0,
                                   atol=SCHEDULE_YTOL * float(np.abs(np.asarray(jy)).max()))
        assert float(mine[3]) == pytest.approx(float(jkl), rel=STEP_RTOL)
    assert kinks <= 300 * 60 // 1000, kinks


def test_tsne_exact_kl_like_jax_before_the_trajectories_part():
    """``fit_transform``'s whole loop (P, the initial state, 5 exaggerated
    and 5 plain steps, ``kl_``) within 1e-3 of JAX's over 10 iterations,
    before the rounding has grown (see the test above)."""
    pts = _blobs(60, seed=4)
    t = Tsne(perplexity=10, n_iter=10, seed=4, device="cpu")
    emb = t.fit_transform(pts)
    jt = jcl.Tsne(perplexity=10, n_iter=10, seed=4)
    jt.fit_transform(pts)
    assert emb.shape == (60, 2)
    assert t.kl_ == pytest.approx(jt.kl_, rel=KL_RTOL)


def test_tsne_barnes_hut_bit_identical_to_jax():
    pts = _blobs(60, seed=5)
    emb = BarnesHutTsne(theta=0.5, perplexity=10, n_iter=400, seed=5,
                        device="cpu").fit_transform(pts)
    assert emb.shape == (60, 2)
    assert _separated(emb, 60)
    # 5-NN label purity: the embedding keeps the cluster structure
    lab = np.array([0] * 30 + [1] * 30)
    purity = 0.0
    for i in range(60):
        d = np.linalg.norm(emb - emb[i], axis=1)
        d[i] = np.inf
        purity += (lab[np.argsort(d)[:5]] == lab[i]).mean()
    assert purity / 60 > 0.9
    jemb = jcl.BarnesHutTsne(theta=0.5, perplexity=10, n_iter=400, seed=5).fit_transform(pts)
    np.testing.assert_array_equal(emb, jemb)


def test_tsne_barnes_hut_theta_zero_takes_the_exact_steps():
    pts = _blobs(30, seed=11)
    a = BarnesHutTsne(theta=0.0, perplexity=5, n_iter=60, seed=1, device="cpu")
    b = Tsne(perplexity=5, n_iter=60, seed=1, learning_rate=100.0, device="cpu")
    np.testing.assert_array_equal(a.fit_transform(pts), b.fit_transform(pts))
    assert a.kl_ == b.kl_


# ---------------------------------------------------------------------- server
def test_nearest_neighbors_server_roundtrip():
    pts = _blobs(40, seed=7)
    server = NearestNeighborsServer(pts)
    port = server.start(0)
    try:
        client = NearestNeighborsClient(f"http://127.0.0.1:{port}")
        res = client.knn(index=3, k=4)
        assert len(res["results"]) == 4
        assert res["results"][0]["index"] == 3  # itself at distance 0
        res2 = client.knn_new(pts[5] + 0.01, k=3)
        assert res2["results"][0]["index"] == 5
        idxs, dists = jcl.VPTree(pts).search(pts[5] + 0.01, 3)
        assert [r["index"] for r in res2["results"]] == idxs
        assert [r["distance"] for r in res2["results"]] == dists
    finally:
        server.stop()
