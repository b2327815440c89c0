"""1D moment quadrature against closed-form Gaussian/uniform oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats

from mfs_tpu.one_dim.moments import raw_to_central, raw_to_scaled
from mfs_tpu.one_dim.quadrature import (
    gauss_quadrature_golub_welsch,
    hankel_indices,
    moment_quadrature,
    taylor_quadrature,
)
from mfs_tpu.utils.gaussian import normal_raw_moments_all

MEAN, VAR = 0.7, 2.3


def _gaussian_rms(num):
    return normal_raw_moments_all(MEAN, VAR, num)


def test_hankel_indices_structure():
    g, h = hankel_indices(3)
    np.testing.assert_array_equal(np.asarray(g), [[0, 1, 2], [1, 2, 3], [2, 3, 4]])
    np.testing.assert_array_equal(np.asarray(h), [[1, 2, 3], [2, 3, 4], [3, 4, 5]])


@pytest.mark.parametrize("N", [2, 3, 5, 8])
def test_polynomial_exactness(N):
    """An N-point moment quadrature reproduces moments 0..2N-1 exactly."""
    rms = _gaussian_rms(2 * N)
    w, x = moment_quadrature(rms)
    for p in range(2 * N):
        np.testing.assert_allclose(
            float(jnp.sum(w * x**p)), float(rms[p]), rtol=1e-8, atol=1e-9
        )


def test_mode_invariance():
    """raw / central / scaled quadratures give identical rules."""
    rms = _gaussian_rms(10)
    cms = raw_to_central(rms)
    scms = raw_to_scaled(rms)
    scale = jnp.sqrt(cms[2])
    w1, x1 = moment_quadrature(rms, sort_nodes=True)
    w2, x2 = moment_quadrature(cms, mean=rms[1], sort_nodes=True)
    w3, x3 = moment_quadrature(scms, mean=rms[1], scale=scale, sort_nodes=True)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), atol=1e-10)
    np.testing.assert_allclose(np.asarray(x3), np.asarray(x1), atol=1e-10)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w1), atol=1e-10)
    np.testing.assert_allclose(np.asarray(w3), np.asarray(w1), atol=1e-10)


def test_gaussian_expectations_of_nonpolynomials():
    rms = _gaussian_rms(20)
    w, x = moment_quadrature(rms)
    # E[exp(X)] = exp(mean + var / 2)
    got = float(jnp.sum(w * jnp.exp(x)))
    assert abs(got - np.exp(MEAN + VAR / 2)) < 2e-3
    # E[sin(X)] = sin(mean) exp(-var / 2)
    got = float(jnp.sum(w * jnp.sin(x)))
    assert abs(got - np.sin(MEAN) * np.exp(-VAR / 2)) < 2e-3


def test_uniform_moments_quadrature():
    """Quadrature built from uniform moments integrates polynomials on [a, b]."""
    a, b = -1.0, 2.0
    rms = jnp.array([(b ** (p + 1) - a ** (p + 1)) / ((p + 1) * (b - a)) for p in range(12)])
    w, x = moment_quadrature(rms)
    for p in range(12):
        np.testing.assert_allclose(float(jnp.sum(w * x**p)), float(rms[p]), atol=1e-10)


def test_stable_mode_matches_plain_on_wellconditioned():
    rms = _gaussian_rms(8)
    w1, x1 = moment_quadrature(rms, sort_nodes=True)
    w2, x2 = moment_quadrature(rms, sort_nodes=True, stable=True)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), atol=1e-9)


def test_batched_quadrature_matches_loop():
    means = jnp.array([0.0, 0.5, -1.2])
    variances = jnp.array([1.0, 2.0, 0.3])
    rms_b = normal_raw_moments_all(means, variances, 10)
    wb, xb = moment_quadrature(rms_b, sort_nodes=True)
    for i in range(3):
        w, x = moment_quadrature(rms_b[i], sort_nodes=True)
        np.testing.assert_allclose(np.asarray(wb[i]), np.asarray(w), atol=1e-12)
        np.testing.assert_allclose(np.asarray(xb[i]), np.asarray(x), atol=1e-12)


def test_golub_welsch_variant():
    rms = _gaussian_rms(10)
    w, x = gauss_quadrature_golub_welsch(rms)
    for p in range(7):
        np.testing.assert_allclose(float(jnp.sum(w * x**p)), float(rms[p]), atol=1e-9)


def test_xla_eigh_path_matches_jacobi():
    rms = _gaussian_rms(10)
    w1, x1 = moment_quadrature(rms, sort_nodes=True, eigh_impl="jacobi")
    w2, x2 = moment_quadrature(rms, sort_nodes=True, eigh_impl="xla")
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w1), atol=1e-9)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), atol=1e-9)


def test_taylor_quadrature_polynomial():
    cms = raw_to_central(_gaussian_rms(8))
    got = taylor_quadrature(lambda u: u**3, cms, MEAN, 7)
    expected = scipy.stats.norm.moment(3, loc=MEAN, scale=np.sqrt(VAR)) if False else (
        MEAN**3 + 3 * MEAN * VAR
    )
    np.testing.assert_allclose(float(got), expected, rtol=1e-9)


def test_quadrature_weights_sum_to_one():
    rms = _gaussian_rms(16)
    w, _ = moment_quadrature(rms)
    np.testing.assert_allclose(float(jnp.sum(w)), 1.0, rtol=1e-10)
