"""1D moment filters (raw / central / scaled-central modes).

The flagship entry points, counterpart of reference
``mfs/one_dim/filtering.py:32-240``.  Semantics per time step:

    PREDICT: quadrature from current moments; contract the conditional
             transition moments with the quadrature weights.
    UPDATE:  second quadrature from predicted moments; pointwise
             measurement likelihood at the nodes; normalised posterior
             moments; accumulate ``nell -= log p(y_k | y_{1:k-1})``.

Deltas from the reference:

- **Batch-first**: all carries and observations may have leading batch
  axes — ``rms0 (..., 2N)``, ``ys (T, ...)``.  One ``lax.scan`` runs
  thousands of Monte-Carlo trials in lockstep; the tiny per-trial
  linear algebra becomes large batched ops that occupy the device.
- Model callables are *elementwise/batched by construction* (see
  ``mfs_tpu.sde.transitions``): no vmap pyramids in the hot loop.
- ``measurement_cond_pdf(y, x)`` must broadcast elementwise over ``x``
  (all jnp-composed densities do).
- The per-step eigendecompositions default to ``eigh_impl="refined"``:
  an f32 XLA eigh seed finished by an f64 perturbative polish
  (``mfs_tpu.ops.eigh.eigh_refined``).  ``"xla"`` is XLA's eigh in
  f64, ``"jacobi"`` the in-repo cyclic-Jacobi solver.

Everything is differentiable; the returned ``nell`` is the negative log
likelihood used for gradient-based parameter estimation.
"""
import warnings
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

from mfs_tpu.one_dim.quadrature import moment_quadrature
from mfs_tpu.typings import Array, FloatScalar


def _monomials(u: Array, num: int) -> Array:
    out = [jnp.ones_like(u)]
    for _ in range(num - 1):
        out.append(out[-1] * u)
    return jnp.stack(out, axis=-1)


def _check_even(num_moments: int) -> None:
    if num_moments % 2 != 0:
        warnings.warn(f"The number of moments {num_moments} should be even.")


def _expand_y(y):
    return jnp.asarray(y)[..., None]


def moment_filter_rms(
    state_cond_raw_moments: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    rms0: Array,
    ys: Array,
    stable: bool = False,
    eigh_impl: str = "refined",
) -> Tuple[Array, Array]:
    r"""Moment filter with raw-moment representation.

    Parameters
    ----------
    state_cond_raw_moments : (..., n) -> (..., n, 2N)
        ``E[X_k^j | X_{k-1} = node]`` for all orders j < 2N at a batch
        of nodes (build with ``mfs_tpu.sde.sde_cond_moments_*``).
    measurement_cond_pdf : (y, x) -> densities, broadcasting over x
        ``p(y | x)`` evaluated elementwise.
    rms0 : Array (..., 2N)
        Initial raw moments (leading axes = independent trials).
    ys : Array (T, ...)
        Measurements; trailing axes must broadcast with the batch.
    stable : bool
        Use the LDL modified-Cholesky completion inside the quadrature.
    eigh_impl : {"refined", "xla", "jacobi"}
        Eigensolver engine of the per-step quadratures
        (``mfs_tpu.ops.eigh.ENGINES``).

    Returns
    -------
    rmss : Array (T, ..., 2N), nell : Array (...)
    """
    num_moments = rms0.shape[-1]
    _check_even(num_moments)

    def step(carry, y):
        rms, nell = carry

        weights, nodes = moment_quadrature(
            rms, stable=stable, eigh_impl=eigh_impl
        )
        rms = jnp.einsum("...nj,...n->...j", state_cond_raw_moments(nodes), weights)

        weights, nodes = moment_quadrature(
            rms, stable=stable, eigh_impl=eigh_impl
        )
        pdf_vals = measurement_cond_pdf(_expand_y(y), nodes)
        pdf_y = jnp.einsum("...n,...n->...", pdf_vals, weights)
        post = _monomials(nodes, num_moments) * (pdf_vals * weights)[..., None]
        rms = jnp.sum(post, axis=-2) / pdf_y[..., None]
        nell = nell - jnp.log(pdf_y)
        return (rms, nell), rms

    nell0 = jnp.zeros(rms0.shape[:-1], dtype=rms0.dtype)
    (_, nell), rmss = jax.lax.scan(step, (rms0, nell0), ys)
    return rmss, nell


def moment_filter_cms(
    state_cond_central_moments: Callable[[Array, Array], Array],
    state_cond_mean: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    cms0: Array,
    mean0: FloatScalar,
    ys: Array,
    stable: bool = False,
    eigh_impl: str = "refined",
) -> Tuple[Array, Array, Array]:
    r"""Moment filter with central-moment representation.

    Carries (cms, mean); the posterior mean comes from the order-1
    unnormalised posterior moment (reference:
    ``mfs/one_dim/filtering.py:92-161``).

    Returns
    -------
    cmss : Array (T, ..., 2N), means : Array (T, ...), nell : Array (...)
    """
    num_moments = cms0.shape[-1]
    _check_even(num_moments)

    def step(carry, y):
        cms, mean, nell = carry

        weights, nodes = moment_quadrature(
            cms, mean, stable=stable, eigh_impl=eigh_impl
        )
        mean = jnp.einsum("...n,...n->...", state_cond_mean(nodes), weights)
        cond_cms = state_cond_central_moments(nodes, mean[..., None])
        cms = jnp.einsum("...nj,...n->...j", cond_cms, weights)

        weights, nodes = moment_quadrature(
            cms, mean, stable=stable, eigh_impl=eigh_impl
        )
        pdf_vals = measurement_cond_pdf(_expand_y(y), nodes)
        wp = pdf_vals * weights
        pdf_y = jnp.sum(wp, axis=-1)
        mean = jnp.sum(nodes * wp, axis=-1) / pdf_y
        post = _monomials(nodes - mean[..., None], num_moments) * wp[..., None]
        cms = jnp.sum(post, axis=-2) / pdf_y[..., None]
        nell = nell - jnp.log(pdf_y)
        return (cms, mean, nell), (cms, mean)

    mean0 = jnp.broadcast_to(jnp.asarray(mean0, dtype=cms0.dtype), cms0.shape[:-1])
    nell0 = jnp.zeros(cms0.shape[:-1], dtype=cms0.dtype)
    (_, _, nell), (cmss, means) = jax.lax.scan(step, (cms0, mean0, nell0), ys)
    return cmss, means, nell


def moment_filter_scms(
    state_cond_scaled_central_moments: Callable[[Array, Array, Array], Array],
    state_cond_mean_var: Callable[[Array], Tuple[Array, Array]],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    scms0: Array,
    mean0: FloatScalar,
    scale0: FloatScalar,
    ys: Array,
    stable: bool = False,
    eigh_impl: str = "refined",
) -> Tuple[Array, Array, Array, Array]:
    r"""Moment filter with scaled-central-moment representation.

    Carries (scms, mean, scale); the numerically best-conditioned mode
    — the Hankel matrices stay O(1) regardless of the state magnitude
    (reference: ``mfs/one_dim/filtering.py:164-240``).

    .. note:: **Scale-output convention.** The prediction step defines
       ``scale`` as the *full* predicted standard deviation (law of
       total variance), whereas the reference uses only the
       within-transition part ``sqrt(E[cond_var])`` (reference
       ``mfs/one_dim/filtering.py:224``).  Any positive scale is
       algebraically valid — the filtering distribution, ``means`` and
       ``nell`` are identical in exact arithmetic — but the returned
       ``scales`` and ``scmss`` trajectories are *not bit-comparable*
       with reference outputs.  The full-std choice is a strict
       numerical improvement: the reference's under-estimated scale
       makes the scaled moments grow like ``(true std / scale)^{2N-1}``
       and overflow the Hankel conditioning at small dt and high N.

    Returns
    -------
    scmss : (T, ..., 2N), means : (T, ...), scales : (T, ...), nell : (...)
    """
    num_moments = scms0.shape[-1]
    _check_even(num_moments)

    def step(carry, y):
        scms, mean, scale, nell = carry

        weights, nodes = moment_quadrature(
            scms, mean, scale, stable=stable, eigh_impl=eigh_impl
        )
        cond_means, cond_vars = state_cond_mean_var(nodes)
        mean = jnp.einsum("...n,...n->...", cond_means, weights)
        # Scale = the *full* predicted standard deviation (law of total
        # variance).  The reference uses only the within-transition part
        # sqrt(E[cond_var]) (reference ``mfs/one_dim/filtering.py:224``),
        # which under-estimates the spread by the between-node variance;
        # the scaled moments then grow like (true std / scale)^{2N-1}
        # and overflow the Hankel conditioning for small dt at high N.
        # Any positive scale is algebraically valid in this
        # representation, so using the exact std is a strict numerical
        # improvement with identical exact-arithmetic semantics.
        second = jnp.einsum(
            "...n,...n->...", cond_vars + cond_means**2, weights
        )
        scale = jnp.sqrt(second - mean**2)
        cond_scms = state_cond_scaled_central_moments(
            nodes, mean[..., None], scale[..., None]
        )
        scms = jnp.einsum("...nj,...n->...j", cond_scms, weights)

        weights, nodes = moment_quadrature(
            scms, mean, scale, stable=stable, eigh_impl=eigh_impl
        )
        pdf_vals = measurement_cond_pdf(_expand_y(y), nodes)
        wp = pdf_vals * weights
        pdf_y = jnp.sum(wp, axis=-1)
        mean = jnp.sum(nodes * wp, axis=-1) / pdf_y
        centred = nodes - mean[..., None]
        scale = jnp.sqrt(jnp.sum(centred**2 * wp, axis=-1) / pdf_y)
        post = _monomials(centred / scale[..., None], num_moments) * wp[..., None]
        scms = jnp.sum(post, axis=-2) / pdf_y[..., None]
        nell = nell - jnp.log(pdf_y)
        return (scms, mean, scale, nell), (scms, mean, scale)

    batch_shape = scms0.shape[:-1]
    mean0 = jnp.broadcast_to(jnp.asarray(mean0, dtype=scms0.dtype), batch_shape)
    scale0 = jnp.broadcast_to(jnp.asarray(scale0, dtype=scms0.dtype), batch_shape)
    nell0 = jnp.zeros(batch_shape, dtype=scms0.dtype)
    (_, _, _, nell), (scmss, means, scales) = jax.lax.scan(
        step, (scms0, mean0, scale0, nell0), ys
    )
    return scmss, means, scales, nell


def moment_filter_taylor(
    state_cond_central_moments: Callable[[Array, Array], Array],
    state_cond_mean: Callable[[Array], Array],
    measurement_cond_pdf: Callable[[Any, Array], Array],
    cms0: Array,
    mean0: FloatScalar,
    ys: Array,
    taylor_order: int = None,
) -> Tuple[Array, Array, Array]:
    r"""Quadrature-free moment filter using Taylor-expansion integration.

    Replaces the per-step Gauss quadrature with the Taylor rule
    ``E[f(X)] ≈ Σ_r f^{(r)}(mean) cms[r] / r!`` — no linear algebra at
    all, just derivative evaluations (the reference sketches this
    filter but leaves it commented out:
    ``mfs/one_dim/filtering.py:242-315``).  Cheaper but biased when the
    integrands are far from polynomial; useful as a fast pilot pass.

    Parameters mirror ``moment_filter_cms``; the model callables must
    be *differentiable* in the node argument (they are evaluated at the
    running mean and differentiated ``taylor_order`` times).

    Batch-first like every other filter: ``cms0 (..., 2N)``,
    ``ys (T, ...)``.  The derivative towers are nested unit-tangent
    JVPs (``make_derivatives_elementwise``), which batch over trials
    without materialising cross-trial Jacobians.

    Returns
    -------
    cmss : (T, ..., 2N), means : (T, ...), nell : (...)
    """
    num_moments = cms0.shape[-1]
    _check_even(num_moments)
    order = taylor_order if taylor_order is not None else num_moments - 1

    from mfs_tpu.one_dim.quadrature import taylor_quadrature

    def step(carry, y):
        cms, mean, nell = carry

        # Prediction: E[g(X)] by Taylor with the current central moments.
        new_mean = taylor_quadrature(
            lambda u: state_cond_mean(u), cms, mean, order
        )
        cms_p = taylor_quadrature(
            lambda u: state_cond_central_moments(u, new_mean), cms, mean, order
        )
        mean = new_mean

        # Update: unnormalised posterior moments by Taylor.
        like = lambda u: measurement_cond_pdf(y, u)
        pdf_y = taylor_quadrature(like, cms_p, mean, order)
        mean_u = (
            taylor_quadrature(lambda u: u * like(u), cms_p, mean, order) / pdf_y
        )

        def centred_monomials(u):
            out = [jnp.ones_like(u)]
            for _ in range(num_moments - 1):
                out.append(out[-1] * (u - mean_u))
            return jnp.stack(out, axis=-1) * like(u)[..., None]

        cms = taylor_quadrature(
            centred_monomials, cms_p, mean, order
        ) / pdf_y[..., None]
        nell = nell - jnp.log(pdf_y)
        return (cms, mean_u, nell), (cms, mean_u)

    batch_shape = cms0.shape[:-1]
    mean0 = jnp.broadcast_to(jnp.asarray(mean0, dtype=cms0.dtype), batch_shape)
    nell0 = jnp.zeros(batch_shape, dtype=cms0.dtype)
    (_, _, nell), (cmss, means) = jax.lax.scan(step, (cms0, mean0, nell0), ys)
    return cmss, means, nell
