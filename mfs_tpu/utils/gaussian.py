"""Gaussian moment closed forms and Gaussian-sum initial conditions.

Capabilities mirror reference ``mfs/utils.py:39-167`` and
``mfs/one_dim/moments.py:31-74``, redesigned batch-first:

- ``normal_raw_moments_all`` computes *every* moment order 0..P-1 in a
  single O(P) three-term recurrence, elementwise over arbitrarily
  batched mean/variance arrays.  The reference instead evaluates a
  per-order double-factorial formula inside a doubly-nested ``vmap``
  (O(P^2) work and heavy tracing); the recurrence form is what lets the
  filters evaluate all transition moments for all quadrature nodes
  and all trials in one fused elementwise pass.
"""
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mfs_tpu.typings import Array, FloatScalar


def normal_raw_moments_all(mean: Array, variance: Array, num_moments: int) -> Array:
    """Raw moments E[X^p], p = 0..num_moments-1, of X ~ N(mean, variance).

    Uses the recurrence ``m_p = mean * m_{p-1} + (p-1) * variance * m_{p-2}``.

    Parameters
    ----------
    mean, variance : Array (...)
        Elementwise-broadcastable arrays (scalars fine).
    num_moments : int
        Static number of moments P.

    Returns
    -------
    Array (..., P)
    """
    mean = jnp.asarray(mean)
    variance = jnp.asarray(variance)
    shape = jnp.broadcast_shapes(mean.shape, variance.shape)
    ms = [jnp.ones(shape, dtype=jnp.result_type(mean, variance, float))]
    if num_moments >= 2:
        ms.append(jnp.broadcast_to(mean, shape).astype(ms[0].dtype))
    for p in range(2, num_moments):
        ms.append(mean * ms[-1] + (p - 1) * variance * ms[-2])
    return jnp.stack(ms[:num_moments], axis=-1)


def raw_moment_of_standard_normal(p: int) -> float:
    """E[X^p] for X ~ N(0, 1): (p-1)!! for even p, 0 for odd p."""
    if p % 2 == 1:
        return 0.0
    return math.factorial(p) / (2 ** (p // 2) * math.factorial(p // 2))


def raw_moment_of_normal(mean: FloatScalar, variance: FloatScalar, p: int) -> FloatScalar:
    """E[X^p] for X ~ N(mean, variance), single static order p."""
    return normal_raw_moments_all(mean, variance, p + 1)[..., p]


def central_moment_of_normal(variance: FloatScalar, p: int) -> FloatScalar:
    """p-th central moment of a Normal: variance^{p/2} (p-1)!! (even p)."""
    if p % 2 == 1:
        return 0.0
    return jnp.sqrt(variance) ** p * raw_moment_of_standard_normal(p)


class GaussianSum1D(NamedTuple):
    """A 1D Gaussian-mixture distribution with precomputed moments.

    Carries raw, central and scaled-central moments up to order 2N-1 so
    it can seed any moment-filter mode (reference: ``mfs/utils.py:39-74``).
    """

    means: Array
    variances: Array
    weights: Array
    mean: Array
    variance: Array
    rms: Array
    cms: Array
    scms: Array

    def pdf(self, xs: Array) -> Array:
        xs = jnp.atleast_1d(xs)
        comp = jax.scipy.stats.norm.pdf(
            xs[..., None], self.means, jnp.sqrt(self.variances)
        )
        return jnp.sum(comp * self.weights, axis=-1)

    def sampler(self, key: Array, n: int) -> Array:
        key_choice, key_normal = jax.random.split(key)
        cs = jax.random.choice(key_choice, self.means.shape[0], (n,), p=self.weights)
        eps = jax.random.normal(key_normal, (n,))
        return self.means[cs] + jnp.sqrt(self.variances[cs]) * eps

    @classmethod
    def new(cls, means: Array, variances: Array, weights: Array, N: int = 2):
        num_moments = 2 * N
        # Mixture moments = weighted sum of component Normal moments,
        # all orders at once via the recurrence.
        comp_rms = normal_raw_moments_all(means, variances, num_moments)  # (c, 2N)
        rms = jnp.einsum("c,cp->p", weights, comp_rms)
        centre = rms[1]
        comp_cms = normal_raw_moments_all(means - centre, variances, num_moments)
        cms = jnp.einsum("c,cp->p", weights, comp_cms)
        variance = cms[2]
        scms = cms / jnp.sqrt(variance) ** jnp.arange(num_moments)
        return cls(
            means=means,
            variances=variances,
            weights=weights,
            mean=centre,
            variance=variance,
            rms=rms,
            cms=cms,
            scms=scms,
        )


class GaussianSumND(NamedTuple):
    """N-D Gaussian-mixture with graded-lex moment vectors.

    Reference: ``mfs/utils.py:77-125``.  Moments are computed with the
    table-batched Kan–Magnus routine from ``mfs_tpu.multi_dims.moments``.
    """

    d: int
    means: Array  # (c, d)
    covs: Array  # (c, d, d)
    weights: Array  # (c,)
    mean: Array  # (d,)
    cov: Array  # (d, d)
    rms: Array  # (z,)
    cms: Array  # (z,)

    def pdf(self, x: Array) -> Array:
        comp = jnp.stack(
            [
                jax.scipy.stats.multivariate_normal.pdf(x, m, c)
                for m, c in zip(self.means, self.covs)
            ]
        )
        return jnp.sum(comp * self.weights)

    def logpdf(self, x: Array) -> Array:
        comp = jnp.stack(
            [
                jax.scipy.stats.multivariate_normal.logpdf(x, m, c)
                for m, c in zip(self.means, self.covs)
            ]
        )
        return jax.scipy.special.logsumexp(comp, b=self.weights)

    def sampler(self, key: Array, nsamples: int) -> Array:
        key_choice, key_normal = jax.random.split(key)
        cs = jax.random.choice(
            key_choice, self.means.shape[0], (nsamples,), p=self.weights
        )
        chols = jnp.linalg.cholesky(self.covs[cs])
        eps = jax.random.normal(key_normal, (nsamples, self.d))
        return self.means[cs] + jnp.einsum("nij,nj->ni", chols, eps)

    @classmethod
    def new(cls, means: Array, covs: Array, weights: Array, multi_indices):
        from mfs_tpu.multi_dims.moments import raw_moments_mvn_kan_all

        d = means.shape[1]
        centre = jnp.einsum("c,cd->d", weights, means)
        cov = (
            sum(
                w * (c + jnp.outer(m, m))
                for m, c, w in zip(means, covs, weights)
            )
            - jnp.outer(centre, centre)
        )
        comp_rms = jax.vmap(
            lambda m, c: raw_moments_mvn_kan_all(m, c, multi_indices)
        )(means, covs)
        rms = jnp.einsum("c,cz->z", weights, comp_rms)
        comp_cms = jax.vmap(
            lambda m, c: raw_moments_mvn_kan_all(m - centre, c, multi_indices)
        )(means, covs)
        cms = jnp.einsum("c,cz->z", weights, comp_cms)
        return cls(
            d=d,
            means=means,
            covs=covs,
            weights=weights,
            mean=centre,
            cov=cov,
            rms=rms,
            cms=cms,
        )


def discretise_lti_sde(A: Array, B: Array, dt: FloatScalar):
    """Exact discretisation of dX = A X dt + B dW over a step dt.

    Returns the transition matrix F and the transition covariance Q via
    the matrix-fraction decomposition (Axelsson–Gustafsson; reference:
    ``mfs/utils.py:128-167``).
    """
    import numpy as np

    d = A.shape[0]
    concrete = not (isinstance(A, jax.core.Tracer) or isinstance(B, jax.core.Tracer) or isinstance(dt, jax.core.Tracer))
    if concrete:
        # Trace-time constants: use SciPy's expm on the host.
        import scipy.linalg

        An, Bn = np.asarray(A, np.float64), np.asarray(B, np.float64)
        F = scipy.linalg.expm(An * float(dt))
        blk = np.block([[An, Bn @ Bn.T], [np.zeros_like(An), -An.T]])
        m = scipy.linalg.expm(blk * float(dt)) @ np.vstack(
            [np.zeros_like(An), np.eye(d)]
        )
        Q = m[:d] @ F.T
        return jnp.asarray(F), jnp.asarray(Q)
    F = jax.scipy.linalg.expm(A * dt)
    blk = jnp.block([[A, B @ B.T], [jnp.zeros_like(A), -A.T]])
    m = jax.scipy.linalg.expm(blk * dt) @ jnp.vstack(
        [jnp.zeros_like(A), jnp.eye(d, dtype=A.dtype)]
    )
    Q = m[:d] @ F.T
    return F, Q
