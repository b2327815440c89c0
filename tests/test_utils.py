"""Utility oracles: Bell polynomials vs sympy, Hermite vs numpy,
Gaussian-sum moments, LDL, Lanczos, LTI discretisation, PCRLB vs KF."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats

from mfs_tpu.utils.combinatorics import (
    complete_bell,
    hermite_probabilist,
    hermite_probabilist_all,
    partial_bell,
    pascal_lower,
)
from mfs_tpu.utils.gaussian import (
    GaussianSum1D,
    central_moment_of_normal,
    discretise_lti_sde,
    normal_raw_moments_all,
    raw_moment_of_normal,
)
from mfs_tpu.utils.linalg import lanczos, lanczos_ritz, ldl, ldl_chol


def test_pascal_matches_scipy():
    import scipy.linalg

    np.testing.assert_allclose(pascal_lower(8), scipy.linalg.pascal(8, kind="lower"))


def test_partial_bell_vs_sympy():
    import sympy

    xs = [1.3, -0.4, 2.2, 0.7, -1.1, 0.25]
    for n in range(0, 6):
        for k in range(0, n + 1):
            expected = float(
                sympy.bell(n, k, xs[: n - k + 1]) if n >= k >= 1 else (1.0 if n == k == 0 else 0.0)
            )
            got = partial_bell(n, k, xs)
            assert abs(float(got) - expected) < 1e-9, (n, k)


def test_complete_bell_vs_sympy():
    import sympy

    x = sympy.symbols("x0:6")
    xs_num = [0.5, 1.5, -0.7, 0.2, 1.1, -0.3]
    for n in range(1, 6):
        expected = float(sympy.bell(n, 1, xs_num[:n]) if n == 1 else sum(
            sympy.bell(n, k, xs_num[: n - k + 1]) for k in range(1, n + 1)
        ))
        assert abs(float(complete_bell(n, xs_num)) - expected) < 1e-9


def test_hermite_vs_numpy():
    xs = np.linspace(-3, 3, 11)
    for n in range(8):
        coeffs = np.zeros(n + 1)
        coeffs[n] = 1.0
        expected = np.polynomial.hermite_e.hermeval(xs, coeffs)
        got = np.asarray(hermite_probabilist(n, jnp.asarray(xs)))
        np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12)
    allh = np.asarray(hermite_probabilist_all(7, jnp.asarray(xs)))
    for n in range(8):
        coeffs = np.zeros(n + 1)
        coeffs[n] = 1.0
        np.testing.assert_allclose(
            allh[:, n], np.polynomial.hermite_e.hermeval(xs, coeffs), rtol=1e-12
        )


def test_normal_moments_vs_scipy():
    mean, var = 0.63, 1.7
    ms = np.asarray(normal_raw_moments_all(mean, var, 9))
    for p in range(9):
        expected = scipy.stats.norm.moment(p, loc=mean, scale=np.sqrt(var))
        np.testing.assert_allclose(ms[p], expected, rtol=1e-10)
    assert abs(float(raw_moment_of_normal(mean, var, 4)) - ms[4]) < 1e-12
    assert abs(float(central_moment_of_normal(var, 4)) - 3 * var**2) < 1e-12
    assert float(central_moment_of_normal(var, 3)) == 0.0


def test_gaussian_sum_1d_moments_and_pdf():
    gs = GaussianSum1D.new(
        means=jnp.array([-0.5, 0.5]),
        variances=jnp.array([0.05, 0.05]),
        weights=jnp.array([0.3, 0.7]),
        N=4,
    )
    # Monte-Carlo oracle.
    key = jax.random.PRNGKey(0)
    samples = gs.sampler(key, 2_000_000)
    assert abs(float(jnp.mean(samples)) - float(gs.mean)) < 5e-3
    for p in range(1, 6):
        mc = float(jnp.mean(samples**p))
        assert abs(mc - float(gs.rms[p])) < 0.02 * max(1.0, abs(mc)), p
    # pdf integrates to 1
    xs = jnp.linspace(-4, 4, 4001)
    assert abs(float(jnp.trapezoid(gs.pdf(xs), xs)) - 1.0) < 1e-6
    # scaled central moments: order 2 must be exactly 1
    np.testing.assert_allclose(float(gs.scms[2]), 1.0, rtol=1e-12)


def test_ldl_matches_cholesky_for_pd():
    rng = np.random.RandomState(0)
    a = rng.randn(6, 6)
    mat = a @ a.T + 6 * np.eye(6)
    L, d = ldl(jnp.asarray(mat))
    np.testing.assert_allclose(
        np.asarray(L) @ np.diag(np.asarray(d)) @ np.asarray(L).T, mat, rtol=1e-12
    )
    R = ldl_chol(jnp.asarray(mat))
    np.testing.assert_allclose(np.asarray(R @ R.T), mat, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(R), np.linalg.cholesky(mat), rtol=1e-10, atol=1e-12
    )


def test_ldl_batched():
    rng = np.random.RandomState(1)
    a = rng.randn(5, 4, 4)
    mats = a @ np.swapaxes(a, -1, -2) + 4 * np.eye(4)
    L, d = ldl(jnp.asarray(mats))
    recon = np.einsum("bij,bj,bkj->bik", np.asarray(L), np.asarray(d), np.asarray(L))
    np.testing.assert_allclose(recon, mats, rtol=1e-12)


def test_ldl_chol_completes_indefinite():
    mat = jnp.asarray(np.diag([1.0, -0.5, 2.0]))
    R = ldl_chol(mat)
    recon = np.asarray(R @ R.T)
    assert np.all(np.linalg.eigvalsh(recon) >= 0)


def test_ldl_chol_reverse_mode_finite_on_clamped_pivot():
    """A clamped (negative) pivot must give finite reverse-mode
    cotangents: sqrt's infinite slope at 0 must not meet the zero
    cotangent of the unused branch."""
    mat = jnp.array([[1.0, 2.0], [2.0, 1.0]])  # pivots 1, -3
    g = jax.grad(lambda m: jnp.sum(ldl_chol(m)))(mat)
    assert np.all(np.isfinite(np.asarray(g)))


def test_lanczos_full_rank_reconstruction():
    rng = np.random.RandomState(2)
    a = rng.randn(7, 7)
    a = a + a.T
    v0 = np.zeros(7)
    v0[0] = 1.0
    V, alphas, betas = lanczos(jnp.asarray(a), jnp.asarray(v0), 7)
    V = np.asarray(V)
    np.testing.assert_allclose(V.T @ V, np.eye(7), atol=1e-8)
    T = np.diag(np.asarray(alphas)) + np.diag(np.asarray(betas), 1) + np.diag(
        np.asarray(betas), -1
    )
    np.testing.assert_allclose(V.T @ a @ V, T, atol=1e-7)
    # Ritz pairs at m = n are the exact eigenpairs.
    ritz_vecs, ritz_vals = lanczos_ritz(jnp.asarray(a), jnp.asarray(v0), 7)
    np.testing.assert_allclose(
        np.sort(np.asarray(ritz_vals)), np.linalg.eigvalsh(a), atol=1e-7
    )


def test_discretise_lti_sde_vs_scalar_ou():
    lam, sigma, dt = 0.8, 1.3, 0.37
    F, Q = discretise_lti_sde(jnp.array([[-lam]]), jnp.array([[sigma]]), dt)
    np.testing.assert_allclose(float(F[0, 0]), np.exp(-lam * dt), rtol=1e-12)
    np.testing.assert_allclose(
        float(Q[0, 0]), sigma**2 / (2 * lam) * (1 - np.exp(-2 * lam * dt)), rtol=1e-10
    )
