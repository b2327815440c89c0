"""Particle filters (sequential Monte Carlo) — batch-first.

Bootstrap and proposal-based particle filters (counterpart of reference
``mfs/classical_filters_smoothers/smc.py``).  The state carried through
the scan is ``(..., n)`` for scalar states or ``(..., n, dx)`` for
vector states, where ``...`` are arbitrary Monte-Carlo trial axes: one
filter call processes a whole trial ensemble, resampling each trial
independently (batch-first resamplers from
``mfs_tpu.filters.resampling``).  This makes the PF baseline directly
comparable with the batched moment filters — no external vmap needed.

Key protocol: the input key is split once into (init, scan); each scan
step splits its key into (propagation, resampling) children, so no key
is both consumed directly and re-split (JAX key-usage contract).
"""
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

from mfs_tpu.filters.resampling import continuous_resampling
from mfs_tpu.typings import Array, FloatScalar


def _gather_particles(samples: Array, idx: Array, vector_state: bool) -> Array:
    if vector_state:
        return jnp.take_along_axis(samples, idx[..., None], axis=-2)
    return jnp.take_along_axis(samples, idx, axis=-1)


def _expand_y(y, samples: Array, vector_state: bool):
    """Insert the particle axis into per-trial measurements.

    A scalar-per-trial y of shape ``(...,)`` must broadcast against
    ``(..., n)`` samples, and a ``(..., dy)`` y against ``(..., n, dx)``.
    Scalars and already-broadcastable shapes pass through unchanged.
    """
    y = jnp.asarray(y)
    if y.ndim == samples.ndim - 1 and y.ndim > 0:
        return y[..., None, :] if vector_state else y[..., None]
    return y


def bootstrap_filter(
    transition_sampler: Callable[[Array, Array], Array],
    measurement_cond_pdf: Callable[[Array, Array], Array],
    ys: Array,
    init_sampler: Callable[[Array, int], Array],
    key: Array,
    nsamples: int,
    resampling: Callable[[Array, Array], Array],
    conti_resampling: bool = False,
    vector_state: bool = False,
    remat_chunk: int = 0,
    out_fn: Callable[[Array], Any] = None,
) -> Tuple[Array, FloatScalar]:
    """Bootstrap particle filter over an ensemble of trials.

    Parameters
    ----------
    transition_sampler : ((..., n[, dx]), key) -> (..., n[, dx])
        Propagates all particles of all trials through the transition.
    measurement_cond_pdf : (y, x) -> (..., n)
        Likelihood of y at each particle; must broadcast y (with the
        particle axis inserted by the filter) against the particles.
    ys : Array (T, ...)
        Measurements: time first, then arbitrary trial axes (and a
        trailing dy axis when ``vector_state``).
    init_sampler : (key, n) -> (..., n[, dx])
    nsamples : int
    resampling : ((..., n), key) -> (..., n) integer indices.
    conti_resampling : bool
        Use the differentiable continuous resampler (scalar states).
    vector_state : bool
        Particles carry a trailing state axis ``dx``.
    remat_chunk : int
        When > 0 (and dividing T), run the scan as T/chunk
        checkpointed segments: reverse-mode differentiation then
        stores only segment-boundary particle states and recomputes
        each segment's interior on the backward pass — O(T/c + c)
        instead of O(T) live residuals.  Required for PF-MLE
        gradients at production sizes (T = 1000, thousands of
        particles x trials would otherwise need tens of GB).  Forward
        results are unchanged.

    out_fn : callable, optional
        Per-step reduction of the resampled particles (e.g. mean/var
        over the particle axis); the stacked reductions replace the
        raw trajectories in the first return value, keeping memory at
        O(carry) for large particle counts.

    Returns
    -------
    samples : Array (T, ..., n[, dx]) (or stacked ``out_fn`` outputs),
    nell : Array (...)
        Per-trial negative log-likelihoods.

    Reference: ``mfs/classical_filters_smoothers/smc.py:26-84``
    (single-trial; the trial axes and the key split protocol are the
    batch-first redesign).
    """
    key_init, key_scan = jax.random.split(key)

    def step(carry, elem):
        samples, nell = carry
        y, k = elem
        k_prop, k_res = jax.random.split(k)
        samples = transition_sampler(samples, k_prop)
        weights = measurement_cond_pdf(_expand_y(y, samples, vector_state), samples)
        nell = nell - jnp.log(jnp.mean(weights, axis=-1))
        weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
        if conti_resampling:
            samples = continuous_resampling(samples, weights, nsamples, k_res)
        else:
            samples = _gather_particles(
                samples, resampling(weights, k_res), vector_state
            )
        return (samples, nell), reduce(samples)

    reduce = out_fn if out_fn is not None else (lambda s: s)
    init = init_sampler(key_init, nsamples)
    batch_shape = init.shape[: init.ndim - (2 if vector_state else 1)]
    nell0 = jnp.zeros(batch_shape, init.dtype)
    T = ys.shape[0]
    keys = jax.random.split(key_scan, T)
    if remat_chunk and remat_chunk < T:
        if T % remat_chunk:
            raise ValueError(
                f"remat_chunk {remat_chunk} must divide T {T}"
            )
        c = remat_chunk
        ys_seg = ys.reshape((T // c, c) + ys.shape[1:])
        keys_seg = keys.reshape((T // c, c) + keys.shape[1:])

        @jax.checkpoint
        def segment(carry, elem):
            return jax.lax.scan(step, carry, elem)

        (_, nell), samples = jax.lax.scan(
            segment, (init, nell0), (ys_seg, keys_seg)
        )
        samples = jax.tree_util.tree_map(
            lambda a: a.reshape((T,) + a.shape[2:]), samples
        )
    else:
        (_, nell), samples = jax.lax.scan(step, (init, nell0), (ys, keys))
    return samples, nell


def particle_filter(
    proposal_sampler: Callable[[Array, Array, Array], Array],
    proposal_density: Callable[[Array, Array, Array], Array],
    transition_density: Callable[[Array, Array], Array],
    measurement_cond_pdf: Callable[[Array, Array], Array],
    ys: Array,
    init_sampler: Callable[[Array, int], Array],
    key: Array,
    nsamples: int,
    resampling: Callable[[Array, Array], Array],
    vector_state: bool = False,
    out_fn: Callable[[Array], Any] = None,
) -> Array:
    """Proposal-based SMC (importance weights corrected by the
    transition/proposal density ratio), batch-first like
    ``bootstrap_filter``.

    Returns the resampled particle trajectories (T, ..., n[, dx]) — or,
    when ``out_fn`` is given, ``out_fn(samples)`` per step stacked over
    time.  A reducing ``out_fn`` (e.g. per-step mean/variance) keeps
    the memory footprint at O(carry) instead of O(T x particles),
    which is what lets the convergence study sweep 1e4+ particles over
    1000 batched trials on one chip.

    Reference: ``mfs/classical_filters_smoothers/smc.py:87-141``.
    """
    key_init, key_scan = jax.random.split(key)
    reduce = out_fn if out_fn is not None else (lambda s: s)

    def step(ancestors, elem):
        y, k = elem
        k_prop, k_res = jax.random.split(k)
        y_b = _expand_y(y, ancestors, vector_state)
        samples = proposal_sampler(ancestors, y_b, k_prop)
        weights = (
            measurement_cond_pdf(y_b, samples)
            * transition_density(samples, ancestors)
            / proposal_density(samples, ancestors, y_b)
        )
        weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
        samples = _gather_particles(samples, resampling(weights, k_res), vector_state)
        return samples, reduce(samples)

    init = init_sampler(key_init, nsamples)
    keys = jax.random.split(key_scan, ys.shape[0])
    _, samples = jax.lax.scan(step, init, (ys, keys))
    return samples
