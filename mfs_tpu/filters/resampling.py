"""Resampling kernels for sequential Monte Carlo — batch-first.

Standard systematic / stratified / multinomial index resamplers
(inverse-CDF over the weight cumsum) plus the sorted-interpolation
continuous resampler that makes the particle likelihood differentiable
(Malik–Pitt / Corenflos et al.).  Functional parity with reference
``mfs/classical_filters_smoothers/resampling.py``, redesigned so every
kernel takes ``(..., n)`` weights and returns ``(..., n)`` indices: one
call resamples a whole ensemble of Monte-Carlo trials (the batched
replacement for the reference's one-process-per-trial protocol), with
independent stratification noise per trial drawn from a single key.
"""
import jax
import jax.numpy as jnp

from mfs_tpu.typings import Array


def _inverse_cdf(weights: Array, us: Array) -> Array:
    """Batched inverse-CDF lookup: weights (..., n), us (..., m) -> (..., m)."""
    n = weights.shape[-1]
    cdf = jnp.cumsum(weights, axis=-1)
    flat_c = cdf.reshape(-1, n)
    flat_u = us.reshape(-1, us.shape[-1])
    idx = jax.vmap(jnp.searchsorted)(flat_c, flat_u)
    return jnp.clip(idx.reshape(us.shape), 0, n - 1)


def systematic(weights: Array, key: Array) -> Array:
    """Systematic resampling: one shared uniform offset per trial."""
    n = weights.shape[-1]
    u = jax.random.uniform(key, weights.shape[:-1] + (1,), weights.dtype)
    grid = jnp.arange(n, dtype=weights.dtype)
    return _inverse_cdf(weights, (grid + u) / n)


def stratified(weights: Array, key: Array) -> Array:
    """Stratified resampling: one uniform per stratum per trial."""
    n = weights.shape[-1]
    us = jax.random.uniform(key, weights.shape, weights.dtype)
    grid = jnp.arange(n, dtype=weights.dtype)
    return _inverse_cdf(weights, (grid + us) / n)


def multinomial(weights: Array, key: Array) -> Array:
    """Multinomial resampling with sorted uniforms (Chopin's trick)."""
    n = weights.shape[-1]
    es = -jnp.log(
        jax.random.uniform(key, weights.shape[:-1] + (n + 1,), weights.dtype)
    )
    z = jnp.cumsum(es, axis=-1)
    sorted_us = z[..., :-1] / z[..., -1:]
    return _inverse_cdf(weights, sorted_us)


def continuous_resampling(
    samples: Array, weights: Array, nsamples: int, key: Array
) -> Array:
    """Differentiable 1D resampling by inverse-CDF interpolation.

    Sorts the particles per trial, builds a piecewise-linear CDF from
    midpoint-averaged weights, and interpolates stratified uniforms
    through it, so gradients flow to both samples and weights.
    ``samples``/``weights`` are ``(..., n)``; returns ``(..., nsamples)``.
    """
    order = jnp.argsort(samples, axis=-1)
    xs = jnp.take_along_axis(samples, order, axis=-1)
    ws = jnp.take_along_axis(weights, order, axis=-1)
    half = 0.5 * ws
    cdf_steps = jnp.concatenate(
        [half[..., :1], half[..., 1:] + half[..., :-1]], axis=-1
    )
    cdf = jnp.cumsum(cdf_steps, axis=-1)
    us = (
        jax.random.uniform(key, samples.shape[:-1] + (nsamples,), samples.dtype)
        + jnp.arange(nsamples, dtype=samples.dtype)
    ) / nsamples
    n = samples.shape[-1]
    flat_us = us.reshape(-1, nsamples)
    flat_cdf = cdf.reshape(-1, n)
    flat_xs = xs.reshape(-1, n)
    out = jax.vmap(jnp.interp)(flat_us, flat_cdf, flat_xs)
    return out.reshape(samples.shape[:-1] + (nsamples,))
