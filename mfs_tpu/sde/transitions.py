"""Conditional transition-moment factories for scalar-state SDEs.

These produce the model callables consumed by the 1D moment filters,
computing ``E[phi_n(X_{t+dt}) | X_t = x]`` for *all* moment orders n at
once (counterpart of reference ``mfs/one_dim/moments.py:141-255``).

Design: every returned function is *elementwise* in the node
array — the TME expansion is applied to the vector-valued function of
all 2N monomials in one nested-JVP pass, and the Normal-closure modes
use the O(P) Gaussian moment recurrence.  No vmap over moment orders,
no per-order re-expansion, so compile time and runtime are flat in N
compared to the reference's doubly-vmapped per-order construction.

All functions broadcast over arbitrary batch axes:

- ``rms(nodes)``                  -> (..., 2N)  given nodes (...,)
- ``cms(nodes, mean)``            -> (..., 2N)  (mean broadcasts)
- ``scms(nodes, mean, scale)``    -> (..., 2N)
- ``mean(nodes)``                 -> (...,)
- ``mean_var(nodes)``             -> ((...,), (...,))
"""
from typing import Callable, NamedTuple, Tuple

import jax.numpy as jnp

from mfs_tpu.sde import tme
from mfs_tpu.typings import Array, FloatScalar
from mfs_tpu.utils.gaussian import normal_raw_moments_all


class TransitionMoments1D(NamedTuple):
    """Bundle of conditional-moment callables for one SDE + step size."""

    rms: Callable[[Array], Array]
    cms: Callable[[Array, Array], Array]
    scms: Callable[[Array, Array, Array], Array]
    mean: Callable[[Array], Array]
    mean_var: Callable[[Array], Tuple[Array, Array]]


def _monomials(u: Array, num: int) -> Array:
    """[1, u, ..., u^{num-1}] on a new last axis (product chain)."""
    out = [jnp.ones_like(u)]
    for _ in range(num - 1):
        out.append(out[-1] * u)
    return jnp.stack(out, axis=-1)


def _scale_powers(scale, num: int) -> Array:
    scale = jnp.asarray(scale)
    out = [jnp.ones_like(scale)]
    for _ in range(num - 1):
        out.append(out[-1] * scale)
    return jnp.stack(out, axis=-1)


def sde_cond_moments_tme(
    drift: Callable, dispersion: Callable, dt: FloatScalar, tme_order: int, N: int
) -> TransitionMoments1D:
    """Exact-in-expansion TME conditional moments (no Normal closure).

    Reference behaviour: ``mfs/one_dim/moments.py:141-179`` — there the
    TME is re-run per (node, order) pair under two vmaps; here one
    vector-valued expansion covers all 2N orders.
    """
    num_moments = 2 * N

    def rms(nodes: Array) -> Array:
        phi = lambda u: _monomials(u, num_moments)
        return tme.expectation_1d(phi, nodes, dt, drift, dispersion, tme_order)

    def cms(nodes: Array, mean: Array) -> Array:
        mean = jnp.asarray(mean)
        phi = lambda u: _monomials(u - mean, num_moments)
        return tme.expectation_1d(phi, nodes, dt, drift, dispersion, tme_order)

    def scms(nodes: Array, mean: Array, scale: Array) -> Array:
        mean = jnp.asarray(mean)
        scale = jnp.asarray(scale)
        phi = lambda u: _monomials((u - mean) / scale, num_moments)
        return tme.expectation_1d(phi, nodes, dt, drift, dispersion, tme_order)

    def mean_fn(nodes: Array) -> Array:
        return tme.expectation_1d(lambda u: u, nodes, dt, drift, dispersion, tme_order)

    def mean_var(nodes: Array) -> Tuple[Array, Array]:
        return tme.mean_and_var_1d(nodes, dt, drift, dispersion, tme_order)

    return TransitionMoments1D(rms, cms, scms, mean_fn, mean_var)


def sde_cond_moments_tme_normal(
    drift: Callable, dispersion: Callable, dt: FloatScalar, tme_order: int, N: int
) -> TransitionMoments1D:
    """TME mean/variance + Normal-closure higher moments.

    Guarantees a valid (PD-Hankel) moment vector — the stability mode
    used for the Beneš benchmark (reference:
    ``mfs/one_dim/moments.py:182-219``, ``dardel/benes_bernoulli/mf.py:25-27``).
    """
    num_moments = 2 * N

    def _m_v(nodes):
        return tme.mean_and_var_1d(nodes, dt, drift, dispersion, tme_order)

    return _normal_closure_factory(_m_v, num_moments)


def sde_cond_moments_euler(
    drift: Callable, dispersion: Callable, dt: FloatScalar, N: int
) -> TransitionMoments1D:
    """Euler–Maruyama mean/variance + Normal-closure higher moments
    (reference: ``mfs/one_dim/moments.py:222-255``)."""
    num_moments = 2 * N

    def _m_v(nodes):
        b = dispersion(nodes)
        return nodes + drift(nodes) * dt, b * b * dt

    return _normal_closure_factory(_m_v, num_moments)


def _normal_closure_factory(
    cond_mean_var: Callable[[Array], Tuple[Array, Array]], num_moments: int
) -> TransitionMoments1D:
    """Build all five callables from an elementwise mean/variance map by
    closing the transition with a Normal distribution."""

    def rms(nodes: Array) -> Array:
        m, v = cond_mean_var(nodes)
        return normal_raw_moments_all(m, v, num_moments)

    def cms(nodes: Array, mean: Array) -> Array:
        m, v = cond_mean_var(nodes)
        return normal_raw_moments_all(m - jnp.asarray(mean), v, num_moments)

    def scms(nodes: Array, mean: Array, scale: Array) -> Array:
        m, v = cond_mean_var(nodes)
        out = normal_raw_moments_all(m - jnp.asarray(mean), v, num_moments)
        return out / _scale_powers(scale, num_moments)

    def mean_fn(nodes: Array) -> Array:
        return cond_mean_var(nodes)[0]

    return TransitionMoments1D(rms, cms, scms, mean_fn, cond_mean_var)
