"""Port parity for clustering and t-SNE: k-means (one device step and
whole runs, for the three distances), the four spatial trees, the exact
t-SNE and Barnes-Hut t-SNE, and the filter renderer, held against the JAX
package on the same numpy inputs.

Both packages seed k-means++ and the t-SNE layout with the same numpy
code, so no state is carried. k-means: assignments equal, centroids and
cost at rtol 1e-5 (float32 sums in another order). The trees, the
Gaussian affinities, Barnes-Hut and the renderer are host copies: equal
(Barnes-Hut at rtol 1e-6). Exact t-SNE: one step and the first 20
iterations of both packages' steps at rtol 1e-4 / atol 1e-6 in float64.
In float32 a step's ``y + velocity`` cancels (a step can move the layout
by many times its size), and the early-exaggerated descent at learning
rate 200 multiplies a rounding difference by 2–5 an iteration at these
sizes (two float32 orders of the reference's own sums part as fast);
the gains' sign test is discontinuous where a gradient is within rounding
of zero. So a float32 step is held against the float64 one (the port as
close as the reference), and a whole float32 200-iteration run by its
final KL, within 2 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import clustering as jax_cl
from deeplearning4j_tpu.clustering import kmeans as jax_km
from deeplearning4j_tpu.plot import filters as jax_filters
from deeplearning4j_tpu.plot import tsne as jax_tsne
from deeplearning4j_tpu_torch import clustering as port_cl
from deeplearning4j_tpu_torch.clustering import kmeans as port_km
from deeplearning4j_tpu_torch.plot import filters as port_filters
from deeplearning4j_tpu_torch.plot import tsne as port_tsne

TOL = dict(rtol=1e-5, atol=1e-6)
DISTANCES = ["euclidean", "cosine", "manhattan"]


def _blobs(n=240, d=6, k=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, (k, d))
    lab = rng.integers(k, size=n)
    return (centers[lab] + rng.normal(0, 1, (n, d))).astype(np.float32)


@pytest.mark.parametrize("distance", DISTANCES)
def test_kmeans_step_and_runs_equal(distance):
    pts = _blobs()
    ref = jax_km.KMeansClustering(5, 50, distance, seed=3)
    port = port_km.KMeansClustering(5, 50, distance, seed=3, device="cpu")
    init = ref._init_centroids(pts)
    np.testing.assert_array_equal(port._init_centroids(pts), init)
    c_ref, a_ref, cost_ref = jax_km._kmeans_step(
        jnp.asarray(pts), jnp.asarray(init), distance)
    c_port, a_port, cost_port = port_km._kmeans_step(
        torch.from_numpy(pts), torch.from_numpy(init), distance)
    np.testing.assert_array_equal(a_port.numpy(), np.asarray(a_ref))
    np.testing.assert_allclose(c_port.numpy(), np.asarray(c_ref), **TOL)
    np.testing.assert_allclose(float(cost_port), float(cost_ref), **TOL)
    cs_ref, cs_port = ref.apply_to(pts), port.apply_to(pts)
    np.testing.assert_array_equal(cs_port.assignments, cs_ref.assignments)
    assert cs_port.assignments.dtype == cs_ref.assignments.dtype
    np.testing.assert_allclose(cs_port.cost, cs_ref.cost, **TOL)
    assert 1 <= port.iterations <= 50
    for a, b in zip(cs_port.clusters, cs_ref.clusters):
        np.testing.assert_allclose(a.center, b.center, **TOL)
        assert a.point_indices == b.point_indices
    q = pts[7] + 0.1
    assert cs_port.nearest_cluster(q) == cs_ref.nearest_cluster(q)


def test_kmeans_empty_cluster_keeps_its_centroid_and_setup():
    pts = np.array([[0, 0], [0, 1], [1, 0], [9, 9]], np.float32)
    cents = np.array([[0, 0], [9, 9], [50, 50]], np.float32)
    c, a, _ = port_km._kmeans_step(torch.from_numpy(pts),
                                   torch.from_numpy(cents), "euclidean")
    np.testing.assert_array_equal(c[2].numpy(), cents[2])
    assert a.tolist() == [0, 0, 0, 1]
    km = port_cl.KMeansClustering.setup(2, 10, "cosine", device="cpu")
    assert (km.k, km.max_iterations, km.distance) == (2, 10, "cosine")
    with pytest.raises(ValueError):
        port_cl.KMeansClustering(2, distance="chebyshev", device="cpu")
    with pytest.raises(ValueError):
        port_cl.KMeansClustering(2, max_iterations=0, device="cpu")
    with pytest.raises(ValueError):
        km.apply_to(pts[:1])


def test_spatial_trees_equal():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(150, 3))
    q = rng.normal(size=(8, 3))
    kd_ref, kd_port = jax_cl.KDTree.build(pts), port_cl.KDTree.build(pts)
    extra = rng.normal(size=(10, 3))
    for i, e in enumerate(extra):
        kd_ref.insert(e, 150 + i)
        kd_port.insert(e, 150 + i)
    for x in q:
        assert kd_port.nn(x) == kd_ref.nn(x)
        assert kd_port.knn(x, 7) == kd_ref.knn(x, 7)
    for distance in ("euclidean", "cosine"):
        vp_ref = jax_cl.VPTree(pts, distance=distance)
        vp_port = port_cl.VPTree(pts, distance=distance)
        for x in q:
            assert vp_port.knn(x, 9) == vp_ref.knn(x, 9)
    flat = pts[:, :2]
    qt_ref, qt_port = jax_cl.QuadTree(flat), port_cl.QuadTree(flat)
    for c in q[:, :2]:
        assert sorted(qt_port.query_range(tuple(c), (0.8, 0.5))) == \
            sorted(qt_ref.query_range(tuple(c), (0.8, 0.5)))
    sp_ref, sp_port = jax_cl.SpTree(pts), port_cl.SpTree(pts)
    for i in (0, 17, 149):
        for theta in (0.0, 0.5):
            f_ref, f_port = np.zeros(3), np.zeros(3)
            s_ref = sp_ref.compute_non_edge_forces(i, theta, f_ref)
            s_port = sp_port.compute_non_edge_forces(i, theta, f_port)
            assert s_port == s_ref
            np.testing.assert_array_equal(f_port, f_ref)
    with pytest.raises(ValueError):
        port_cl.QuadTree(pts)


def _tsne_input(n=120, d=5, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c, 1.0, (n // 3, d))
                           for c in (0.0, 6.0, -6.0)])


def _step_inputs(p, seed=2):
    rng = np.random.default_rng(seed)
    n = p.shape[0]
    y = rng.normal(0, 1.0, (n, 2))
    gains = rng.uniform(0.5, 1.5, (n, 2))
    vel = rng.normal(0, 0.1, (n, 2))
    return y, np.maximum(p * 12.0, 1e-12), p, gains, vel


def _steps(inputs, dtype):
    """(port, reference) ``_tsne_step`` outputs on ``inputs`` in
    ``dtype``, as numpy."""
    args = [np.asarray(a, dtype) for a in inputs]
    got = port_tsne._tsne_step(*map(torch.from_numpy, args), 0.5, 200.0)
    want = jax_tsne._tsne_step(*map(jnp.asarray, args),
                               jnp.asarray(0.5, dtype),
                               jnp.asarray(200.0, dtype))
    return ([a.numpy() for a in got], [np.asarray(b) for b in want])


def test_gaussian_p_bitwise_and_one_step():
    x = _tsne_input()
    p = port_tsne.compute_gaussian_p(x, 30.0)
    np.testing.assert_array_equal(p, jax_tsne.compute_gaussian_p(x, 30.0))
    inputs = _step_inputs(p)
    with jax.enable_x64(True):
        got, want = _steps(inputs, np.float64)
        for a, b in zip(got, want):
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
        exact = want
    # float32: y + velocity cancels (a step can move y by many times its
    # size),
    # so each package's float32 step is held against the float64 one, and
    # the port must be as close as the reference
    got, want = _steps(inputs, np.float32)
    for a, b, e in zip(got, want, exact):
        assert np.max(np.abs(a - e)) <= 4 * np.max(np.abs(b - e)) + 1e-12
    t = torch.from_numpy
    args = [t(np.asarray(a, np.float32)) for a in inputs]
    assert port_tsne._tsne_step(*args, 0.5, 200.0, with_kl=False)[3] is None


def test_tsne_first_iterations_and_a_whole_run():
    x = _tsne_input()
    kw = dict(perplexity=30.0, seed=7)
    port = port_tsne.Tsne(device="cpu", **kw)
    p = port_tsne.compute_gaussian_p(x, 30.0)
    # the first 20 iterations of both packages' steps, in float64
    with jax.enable_x64(True):
        ours = [a.double() for a in port._start(p)]
        theirs = [jnp.asarray(a.numpy()) for a in ours]
        for it in range(20):
            momentum, lying = port._hyper(it)
            y, p64, lied, gains, vel = ours
            got = port_tsne._tsne_step(y, lied if lying else p64, p64, gains,
                                       vel, momentum, 200.0)
            y, p64, lied, gains, vel = theirs
            want = jax_tsne._tsne_step(
                y, lied if lying else p64, p64, gains, vel,
                jnp.float64(momentum), jnp.float64(200.0))
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"iteration {it}")
            ours[0], ours[3], ours[4] = got[:3]
            theirs[0], theirs[3], theirs[4] = want[:3]
    # a whole float32 run, through the entry point
    ref = jax_tsne.Tsne(max_iter=200, **kw)
    port = port_tsne.Tsne(max_iter=200, device="cpu", **kw)
    y = port.fit_transform(x)
    ref.fit_transform(x)
    assert y.shape == (120, 2) and np.isfinite(y).all()
    assert len(port.kl_history) == len(ref.kl_history) == 4
    assert port.kl_history[-1] == pytest.approx(ref.kl_history[-1], rel=0.02)
    # KL falls once the exaggeration ends (iteration 100)
    assert port.kl_history[-1] < port.kl_history[1]


def test_barnes_hut_equal():
    x = _tsne_input(n=45)
    kw = dict(perplexity=5.0, max_iter=25, seed=3, theta=0.5)
    np.testing.assert_allclose(
        port_tsne.BarnesHutTsne(**kw).fit_transform(x),
        jax_tsne.BarnesHutTsne(**kw).fit_transform(x), rtol=1e-6,
        atol=1e-12)


@pytest.mark.parametrize("shape", [(49, 10), (30, 70), (5, 5, 3, 8),
                                   (3, 3, 1, 100)])
def test_filters_and_png_equal(shape):
    rng = np.random.default_rng(4)
    w = rng.normal(size=shape)
    np.testing.assert_array_equal(port_filters.filters_grid(w),
                                  jax_filters.filters_grid(w))
    np.testing.assert_array_equal(
        port_filters.filters_grid(w, max_filters=3, pad=2),
        jax_filters.filters_grid(w, max_filters=3, pad=2))
    assert port_filters.render_to_png(w) == jax_filters.render_to_png(w)


def test_render_layer_reads_a_port_network():
    from deeplearning4j_tpu_torch.models import zoo

    net = zoo.mnist_mlp(hidden=16, device="cpu").init()
    png = port_filters.render_layer(net, 0)
    assert png == jax_filters.render_to_png(net.get_param_table()["0_W"])
    assert png.startswith(b"\x89PNG")
    with pytest.raises(KeyError):
        port_filters.render_layer(net, 0, "nope")
