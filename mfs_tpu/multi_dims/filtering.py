"""Multidimensional moment filters (raw / central / scaled-central).

Counterpart of reference ``mfs/multi_dims/filtering.py:33-344`` with the
1D filters' batch-first design: arbitrary leading trial axes, model
callables batched by construction (build with
``mfs_tpu.multi_dims.sde_cond_moments_nd_*``), measurement densities
broadcasting elementwise.  The reference's 'multi-index'/'index'
signature flag is gone — the factories internally use either direct TME
monomial expansion or static Kan tables, both jittable.

Per step: quadrature → contract conditional moments with weights →
second quadrature → Bayes update of the graded-lex moment vector, the
per-dimension means/scales (from the unit multi-indices), and the
running negative log likelihood.
"""
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.multi_dims.moments import monomials_nd
from mfs_tpu.multi_dims.quadrature import moment_quadrature_nd
from mfs_tpu.typings import Array


def _expand_y(y):
    return jnp.asarray(y)[..., None, :]


def _prep(moments_partial_order, m0):
    multi_indices, inds = moments_partial_order
    multi_indices = np.asarray(multi_indices, dtype=np.int64)
    if multi_indices.shape[0] != m0.shape[-1]:
        raise ValueError(
            f"multi_indices size {multi_indices.shape[0]} must match the "
            f"moment vector size {m0.shape[-1]}."
        )
    return multi_indices, np.asarray(inds)


def moment_filter_nd_rms(
    state_cond_raw_moments: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    ys: Array,
    moments_partial_order: Tuple[np.ndarray, np.ndarray],
    rms0: Array,
    stable: bool = False,
    eigh_impl: str = "refined",
) -> Tuple[Array, Array]:
    r"""N-D moment filter, raw-moment representation.

    Parameters
    ----------
    state_cond_raw_moments : (..., m, d) -> (..., m, z)
        Conditional raw moments of all z multi-indices at the nodes.
    measurement_cond_pdf : (y, x) -> densities
        ``p(y | x)`` with x (..., m, d), broadcasting elementwise; y is
        expanded with a node axis before the call.
    ys : Array (T, ...) — trailing axes broadcast with the trial batch.
    moments_partial_order : (multi_indices (z, d), inds (d + 1, s, s))
        From ``generate_graded_lexico_multi_indices(d, 2N - 1)`` and
        ``gram_and_hankel_indices_graded_lexico(N, d)``.
    rms0 : Array (..., z) — initial raw moments.

    Returns
    -------
    rmss : Array (T, ..., z), nell : Array (...)
    """
    multi_indices, inds = _prep(moments_partial_order, rms0)

    def step(carry, y):
        rms, nell = carry

        weights, nodes = moment_quadrature_nd(
            rms, inds, stable=stable, eigh_impl=eigh_impl
        )
        rms = jnp.einsum("...mz,...m->...z", state_cond_raw_moments(nodes), weights)

        weights, nodes = moment_quadrature_nd(
            rms, inds, stable=stable, eigh_impl=eigh_impl
        )
        pdf_vals = measurement_cond_pdf(_expand_y(y), nodes)
        wp = pdf_vals * weights
        pdf_y = jnp.sum(wp, axis=-1)
        rms = jnp.einsum(
            "...mz,...m->...z", monomials_nd(nodes, multi_indices), wp
        ) / pdf_y[..., None]
        nell = nell - jnp.log(pdf_y)
        return (rms, nell), rms

    nell0 = jnp.zeros(rms0.shape[:-1], dtype=rms0.dtype)
    (_, nell), rmss = jax.lax.scan(step, (rms0, nell0), ys)
    return rmss, nell


def moment_filter_nd_cms(
    state_cond_central_moments: Callable[[Array, Array], Array],
    state_cond_mean: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    ys: Array,
    moments_partial_order: Tuple[np.ndarray, np.ndarray],
    cms0: Array,
    mean0: Array,
    stable: bool = False,
    eigh_impl: str = "refined",
    predict_fn: Optional[Callable] = None,
) -> Tuple[Array, Array, Array]:
    r"""N-D moment filter, central-moment representation.

    Carries (cms (..., z), mean (..., d)).

    ``predict_fn(weights, nodes, mean) -> (pred_mean, pred_cms)``, when
    given, replaces the two per-node transition contractions with one
    fused call (the polynomial-TME fast path,
    ``multi_dims/poly_tme.py:PolyTME.predict_cms``, which moves the
    weight contraction inside the TME tower).

    Returns
    -------
    cmss : (T, ..., z), means : (T, ..., d), nell : (...)
    """
    multi_indices, inds = _prep(moments_partial_order, cms0)
    d = multi_indices.shape[-1]
    unit = np.eye(d, dtype=np.int64)

    def step(carry, y):
        cms, mean, nell = carry

        weights, nodes = moment_quadrature_nd(
            cms, inds, mean, stable=stable, eigh_impl=eigh_impl
        )
        if predict_fn is not None:
            mean, cms = predict_fn(weights, nodes, mean)
        else:
            mean = jnp.einsum("...md,...m->...d", state_cond_mean(nodes), weights)
            cms = jnp.einsum(
                "...mz,...m->...z", state_cond_central_moments(nodes, mean), weights
            )

        weights, nodes = moment_quadrature_nd(
            cms, inds, mean, stable=stable, eigh_impl=eigh_impl
        )
        pdf_vals = measurement_cond_pdf(_expand_y(y), nodes)
        wp = pdf_vals * weights
        pdf_y = jnp.sum(wp, axis=-1)
        mean = jnp.einsum("...md,...m->...d", monomials_nd(nodes, unit), wp) / pdf_y[
            ..., None
        ]
        centred = nodes - mean[..., None, :]
        cms = jnp.einsum(
            "...mz,...m->...z", monomials_nd(centred, multi_indices), wp
        ) / pdf_y[..., None]
        nell = nell - jnp.log(pdf_y)
        return (cms, mean, nell), (cms, mean)

    batch = cms0.shape[:-1]
    mean0 = jnp.broadcast_to(jnp.asarray(mean0, dtype=cms0.dtype), batch + (d,))
    nell0 = jnp.zeros(batch, dtype=cms0.dtype)
    (_, _, nell), (cmss, means) = jax.lax.scan(step, (cms0, mean0, nell0), ys)
    return cmss, means, nell


def moment_filter_nd_scms(
    state_cond_scms: Callable[[Array, Array, Array], Array],
    state_cond_mean_vars: Callable[[Array], Tuple[Array, Array]],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    ys: Array,
    moments_partial_order: Tuple[np.ndarray, np.ndarray],
    scms0: Array,
    mean0: Array,
    scale0: Array,
    stable: bool = False,
    eigh_impl: str = "refined",
    predict_fn: Optional[Callable] = None,
) -> Tuple[Array, Array, Array, Array]:
    r"""N-D moment filter, scaled-central representation.

    Carries (scms (..., z), mean (..., d), scale (..., d)); the
    per-dimension scales come from the doubled unit multi-indices of
    the unnormalised posterior (reference:
    ``mfs/multi_dims/filtering.py:180-204``).

    ``predict_fn(weights, nodes, mean, scale) -> (pred_mean,
    pred_scale, pred_scms)``, when given, replaces the per-node
    transition contractions with one fused call (the polynomial-TME
    fast path, ``multi_dims/poly_tme.py:PolyTME.predict_scms``).

    Returns
    -------
    scmss : (T, ..., z), means, scales : (T, ..., d), nell : (...)
    """
    multi_indices, inds = _prep(moments_partial_order, scms0)
    d = multi_indices.shape[-1]
    unit = np.eye(d, dtype=np.int64)

    def step(carry, y):
        scms, mean, scale, nell = carry

        weights, nodes = moment_quadrature_nd(
            scms, inds, mean, scale, stable=stable, eigh_impl=eigh_impl
        )
        if predict_fn is not None:
            mean, scale, scms = predict_fn(weights, nodes, mean, scale)
        else:
            cond_means, cond_vars = state_cond_mean_vars(nodes)
            mean = jnp.einsum("...md,...m->...d", cond_means, weights)
            # Full predicted per-dimension std via the law of total
            # variance (the reference keeps only E[cond_var]:
            # ``mfs/multi_dims/filtering.py:189`` — see the 1D filter
            # for why that explodes the scaled representation at high
            # orders).
            second = jnp.einsum(
                "...md,...m->...d", cond_vars + cond_means**2, weights
            )
            scale = jnp.sqrt(second - mean**2)
            scms = jnp.einsum(
                "...mz,...m->...z", state_cond_scms(nodes, mean, scale), weights
            )

        weights, nodes = moment_quadrature_nd(
            scms, inds, mean, scale, stable=stable, eigh_impl=eigh_impl
        )
        pdf_vals = measurement_cond_pdf(_expand_y(y), nodes)
        wp = pdf_vals * weights
        pdf_y = jnp.sum(wp, axis=-1)
        mean = jnp.einsum("...md,...m->...d", monomials_nd(nodes, unit), wp) / pdf_y[
            ..., None
        ]
        centred = nodes - mean[..., None, :]
        scale = jnp.sqrt(
            jnp.einsum("...md,...m->...d", monomials_nd(centred, 2 * unit), wp)
            / pdf_y[..., None]
        )
        scms = jnp.einsum(
            "...mz,...m->...z",
            monomials_nd(centred / scale[..., None, :], multi_indices),
            wp,
        ) / pdf_y[..., None]
        nell = nell - jnp.log(pdf_y)
        return (scms, mean, scale, nell), (scms, mean, scale)

    batch = scms0.shape[:-1]
    mean0 = jnp.broadcast_to(jnp.asarray(mean0, dtype=scms0.dtype), batch + (d,))
    scale0 = jnp.broadcast_to(jnp.asarray(scale0, dtype=scms0.dtype), batch + (d,))
    nell0 = jnp.zeros(batch, dtype=scms0.dtype)
    (_, _, _, nell), (scmss, means, scales) = jax.lax.scan(
        step, (scms0, mean0, scale0, nell0), ys
    )
    return scmss, means, scales, nell
