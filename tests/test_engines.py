"""Every eigensolver engine against a NumPy/SciPy f64 Golub–Welsch
reference, in 1D and 2D, and the engine names the quadratures accept."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sl

from mfs_tpu.multi_dims import (
    generate_graded_lexico_multi_indices,
    gram_and_hankel_indices_graded_lexico,
    moment_quadrature_nd,
    raw_moments_mvn_kan_all,
)
from mfs_tpu.one_dim.quadrature import moment_quadrature
from mfs_tpu.ops.eigh import ENGINES
from mfs_tpu.utils.gaussian import normal_raw_moments_all

MEAN = 0.3

# Node and weight tolerances by order.  The Hankel condition number
# grows geometrically with N; the worst differences measured against
# the reference over all engines were 9e-14 (N=4), 4e-13 (N=8) and
# 4e-11 (N=15).
TOL_1D = {4: 1e-12, 8: 1e-11, 15: 1e-9}
# 2D: integrals of smooth test functions and the weight sum; measured
# worst 1.5e-13 (N=3) and 7e-14 (N=5), both from the f32-seeded
# ``refined`` engine.
TOL_2D = {3: 1e-11, 5: 1e-11}


def _mixture_central_moments(two_n):
    """Central moments of three zero-mean two-component mixtures."""
    w1, w2 = 0.55, 0.45
    rows = []
    for v in (0.3, 1.0, 2.5):
        mu1 = 0.5 * np.sqrt(v)
        mu2 = -w1 * mu1 / w2  # mixture mean zero
        rows.append(
            w1 * np.asarray(normal_raw_moments_all(mu1, 0.6 * v, two_n))
            + w2 * np.asarray(normal_raw_moments_all(mu2, 0.9 * v, two_n))
        )
    return np.stack(rows)


def _golub_welsch_reference(ms, mean):
    """n-point rule from 2n moments: the Jacobi matrix L^-1 H L^-T
    (G = L L^T), its tridiagonal band to SciPy's tridiagonal solver."""
    n = ms.shape[-1] // 2
    G = sl.hankel(ms[:n], ms[n - 1:2 * n - 1])
    H = sl.hankel(ms[1:n + 1], ms[n:2 * n])
    L = np.linalg.cholesky(G)
    K = sl.solve_triangular(L, sl.solve_triangular(L, H, lower=True).T, lower=True)
    off = 0.5 * (np.diag(K, 1) + np.diag(K, -1))
    nodes, vecs = sl.eigh_tridiagonal(np.diag(K), off)
    return vecs[0] ** 2 * ms[0], nodes + mean


@pytest.mark.parametrize("N", [4, 8, 15])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_1d_vs_golub_welsch(engine, N):
    cms = _mixture_central_moments(2 * N)
    w, x = moment_quadrature(jnp.asarray(cms), MEAN, sort_nodes=True,
                             eigh_impl=engine)
    for i, ms in enumerate(cms):
        w_ref, x_ref = _golub_welsch_reference(ms, MEAN)
        np.testing.assert_allclose(np.asarray(x[i]), x_ref, rtol=0, atol=TOL_1D[N])
        np.testing.assert_allclose(np.asarray(w[i]), w_ref, rtol=0, atol=TOL_1D[N])


def _nd_reference(ms, inds):
    """The N-D rule in NumPy: K_i = L^-1 H_i L^-T, eigh of each, nodes on
    the Cartesian grid of eigenvalues, weights from chained inner
    products of the eigenvectors."""
    d = inds.shape[0] - 1
    G = ms[inds[0]]
    L = np.linalg.cholesky(G)
    vals, vecs = [], []
    for i in range(d):
        K = sl.solve_triangular(
            L, sl.solve_triangular(L, ms[inds[1 + i]], lower=True).T, lower=True
        )
        lam, V = np.linalg.eigh(0.5 * (K + K.T))
        vals.append(lam)
        vecs.append(V)
    s = inds.shape[1]
    weights, nodes = [], []
    for c in itertools.product(range(s), repeat=d):
        w = vecs[0][0, c[0]] * vecs[-1][0, c[-1]]
        for i in range(d - 1):
            w *= vecs[i][:, c[i]] @ vecs[i + 1][:, c[i + 1]]
        weights.append(w)
        nodes.append([vals[i][c[i]] for i in range(d)])
    return np.asarray(weights), np.asarray(nodes)


def _test_functions(x):
    return np.stack([
        np.exp(0.3 * x[..., 0] + 0.2 * x[..., 1]),
        np.cos(x[..., 0]) * x[..., 1],
        x[..., 0] ** 2 * x[..., 1] - x[..., 1] ** 3,
    ], axis=-1)


@pytest.mark.parametrize("N", [3, 5])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_2d_vs_reference(engine, N):
    mis = generate_graded_lexico_multi_indices(2, 2 * N - 1)
    inds = np.asarray(gram_and_hankel_indices_graded_lexico(N, 2))
    mean = jnp.array([[0.2, -0.1], [0.5, 0.4]])
    cov = jnp.array([[[0.5, 0.1], [0.1, 0.3]], [[1.0, -0.2], [-0.2, 0.8]]])
    ms = np.asarray(raw_moments_mvn_kan_all(mean, cov, mis))
    w, x = moment_quadrature_nd(jnp.asarray(ms), inds, eigh_impl=engine)
    for b in range(ms.shape[0]):
        w_ref, x_ref = _nd_reference(ms[b], inds)
        got = np.asarray(w[b]) @ _test_functions(np.asarray(x[b]))
        want = w_ref @ _test_functions(x_ref)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_2D[N])
        np.testing.assert_allclose(float(np.sum(w[b])), 1.0, atol=TOL_2D[N])


@pytest.mark.parametrize("dims", [1, 2])
@pytest.mark.parametrize("name", ["pallas", "auto"])
def test_removed_engine_names_raise(name, dims):
    if dims == 1:
        call = lambda: moment_quadrature(
            normal_raw_moments_all(0.0, 1.0, 8), eigh_impl=name
        )
    else:
        mis = generate_graded_lexico_multi_indices(2, 5)
        inds = gram_and_hankel_indices_graded_lexico(3, 2)
        ms = raw_moments_mvn_kan_all(jnp.zeros(2), jnp.eye(2), mis)
        call = lambda: moment_quadrature_nd(ms, inds, eigh_impl=name)
    with pytest.raises(ValueError, match="refined, xla, jacobi"):
        call()
