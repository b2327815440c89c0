"""Brute-force 1D grid filter — the "exact" reference solution.

Counterpart of reference ``mfs/classical_filters_smoothers/brute_force.py``.
Evolves the filtering density on a fixed uniform grid; the
Chapman–Kolmogorov prediction

    p_pred(x) = ∫ p(x | x') p(x') dx'

is a *precomputed transition-kernel matrix times the density vector*:
the conditional mean/scale at every grid point are compilation
constants, so each integration substep is one (n, n) matmul —
instead of re-evaluating the Normal pdf under
a vmapped trapezoid at every substep.
"""
from typing import Callable

import jax
import jax.numpy as jnp

from mfs_tpu.sde import tme
from mfs_tpu.typings import Array, FloatScalar


def _trapezoid_weights(n: int, dx, dtype) -> Array:
    w = jnp.full((n,), dx, dtype=dtype)
    return w.at[0].mul(0.5).at[-1].mul(0.5)


def brute_force_filter(
    drift: Callable,
    dispersion: Callable,
    measurement_cond_pdf: Callable,
    init_ps: Array,
    xs: Array,
    ys: Array,
    dt: FloatScalar,
    integration_steps: int = 1,
    pred_method: str = "chapman-tme-2",
) -> Array:
    """Filtering PDFs on a uniform grid (1D state).

    Parameters
    ----------
    drift, dispersion : callables
        SDE coefficients, elementwise on the grid.
    measurement_cond_pdf : (y, xs) -> (n,)
        Measurement likelihood, elementwise on the grid.
    init_ps : Array (n,)
        Initial density values at ``xs``.
    xs : Array (n,)
        Uniform grid.
    ys : Array (T, ...)
        Measurements.
    dt : float
        Inter-measurement interval.
    integration_steps : int
        Chapman/Kolmogorov substeps per interval.
    pred_method : str
        'kolmogorov' (finite-difference Fokker–Planck + Euler),
        'chapman-euler', or 'chapman-tme-<order>'.

    Returns
    -------
    Array (T, ..., n)
        Filtering densities at all measurement times.  ``init_ps`` may
        carry leading trial axes ``(..., n)`` matched by ``ys (T, ...)``
        — the whole Monte-Carlo ensemble filters in one call, with the
        prediction as a single batched matmul.
    """
    n = xs.shape[0]
    dx = xs[1] - xs[0]
    ddt = dt / integration_steps
    tw = _trapezoid_weights(n, dx, xs.dtype)
    batched = init_ps.ndim > 1

    if pred_method.startswith("chapman"):
        if pred_method == "chapman-euler":
            m = xs + drift(xs) * ddt
            scale = dispersion(xs) * jnp.sqrt(ddt) * jnp.ones_like(xs)
        else:
            order = int(pred_method.split("-")[-1])
            m, v = tme.mean_and_var_1d(xs, ddt, drift, dispersion, order=order)
            scale = jnp.sqrt(v)
        # Transition kernel matrix K[i, j] = p(x_i | x_j) and trapezoid
        # weights folded in.  The kernel is time-homogeneous, so the
        # whole integration interval collapses to ONE matrix power
        # computed at trace time — each filter step is then a single
        # (batched) matmul instead of ``integration_steps`` matvecs.
        kernel = jax.scipy.stats.norm.pdf(xs[:, None], m[None, :], scale[None, :])
        kernel = kernel * tw[None, :]
        kernel_full = (
            jnp.linalg.matrix_power(kernel, integration_steps)
            if integration_steps > 1
            else kernel
        )

        def predict(ps):
            return jnp.einsum("ij,...j->...i", kernel_full, ps)

    elif pred_method == "kolmogorov":
        gamma = lambda x: dispersion(x) ** 2
        d_drift = jax.vmap(jax.grad(drift))(xs)
        d_gamma = jax.vmap(jax.grad(gamma))(xs)
        dd_gamma = jax.vmap(jax.grad(jax.grad(gamma)))(xs)
        drift_xs = drift(xs) * jnp.ones_like(xs)
        gamma_xs = gamma(xs) * jnp.ones_like(xs)

        def fokker_planck(ps):
            dps = jnp.gradient(ps, dx, axis=-1)
            ddps = jnp.gradient(dps, dx, axis=-1)
            adv = -(d_drift * ps + drift_xs * dps)
            diff = 0.5 * (dd_gamma * ps + 2 * d_gamma * dps + gamma_xs * ddps)
            return adv + diff

        def predict(ps):
            def sub(p, _):
                return p + fokker_planck(p) * ddt, None

            return jax.lax.scan(sub, ps, None, length=integration_steps)[0]

    else:
        raise NotImplementedError(f"Prediction method {pred_method} not implemented.")

    def step(ps, y):
        ps = predict(ps)
        y = jnp.asarray(y)
        y_b = y[..., None] if (batched and y.ndim == ps.ndim - 1) else y
        lik = measurement_cond_pdf(y_b, xs)
        unnorm = lik * ps
        ps = unnorm / jnp.sum(unnorm * tw, axis=-1, keepdims=True)
        return ps, ps

    return jax.lax.scan(step, init_ps, ys)[1]
