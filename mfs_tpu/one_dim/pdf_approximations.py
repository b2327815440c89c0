"""Recover probability densities from moments / cumulants.

Counterpart of reference ``mfs/one_dim/pdf_approximations.py`` plus one
completion: an implemented Edgeworth series (the reference's
``edgeworth()`` is an empty stub, ``pdf_approximations.py:93-95``).
All densities evaluate batched — Hermite/Legendre polynomial ladders
are computed for every order in one recurrence pass.
"""
import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.typings import Array, FloatScalar
from mfs_tpu.utils.combinatorics import (
    complete_bell,
    hermite_probabilist_all,
    partial_bell,
)


def gram_charlier(cumulants: Array) -> Callable[[Array], Array]:
    """Gram–Charlier A series around a Normal base density.

    Parameters
    ----------
    cumulants : Array (2n - 1,)
        Cumulants k_1, ..., k_{2n-1} (from ``sms_to_cumulants``).

    Returns
    -------
    pdf : (m,) -> (m,)
        Density ``phi(h) / sigma * sum_j He_j(h) B_j(0, 0, k_3, ...) /
        (j! sigma^j)`` with h the standardised coordinate.
    """
    order = cumulants.shape[0]
    mean = cumulants[0]
    variance = cumulants[1]
    bell_input = jnp.concatenate([jnp.zeros(2, cumulants.dtype), cumulants[2:]])

    coeffs = jnp.stack(
        [
            jnp.asarray(complete_bell(j, bell_input[:j]))
            / (math.factorial(j) * variance ** (j / 2.0))
            for j in range(order + 1)
        ]
    )

    def pdf(x: Array) -> Array:
        x = jnp.asarray(x)
        h = (x - mean) / jnp.sqrt(variance)
        base = jnp.exp(-0.5 * h * h) / jnp.sqrt(2 * jnp.pi * variance)
        hermites = hermite_probabilist_all(order, h)  # (..., order + 1)
        return base * jnp.einsum("...j,j->...", hermites, coeffs)

    return pdf


def edgeworth(cumulants: Array, order: int = 2) -> Callable[[Array], Array]:
    """Edgeworth expansion around the Normal (Petrov's grouping).

    The reference leaves this as an empty stub
    (``mfs/one_dim/pdf_approximations.py:93-95``); implemented here:

        f(x) = phi(h)/sigma [ 1 + sum_{s=1}^{order} P_s(h) ],
        P_s(h) = sum_{k=1}^{s} He_{s+2k}(h) B_{s,k}(x_1, ..., x_{s-k+1}) / s!,
        x_j = j! * k_{j+2} / (sigma^{j+2} (j+2)!).

    Order 1 is the classic skewness correction (gamma_1/6) He_3; order 2
    adds (gamma_2/24) He_4 + (gamma_1^2/72) He_6.

    Parameters
    ----------
    cumulants : Array (>= order + 2,)
        k_1, k_2, ....
    order : int
        Number of asymptotic correction orders s to keep.
    """
    mean = cumulants[0]
    variance = cumulants[1]
    sigma = jnp.sqrt(variance)

    def x_j(j: int):
        return (
            cumulants[j + 1]
            * math.factorial(j)
            / (sigma ** (j + 2) * math.factorial(j + 2))
        )

    max_he = 3 * order
    # coeff[m] multiplies He_m(h).
    coeff = [jnp.asarray(0.0)] * (max_he + 1)
    coeff[0] = jnp.asarray(1.0)
    for s in range(1, order + 1):
        for k in range(1, s + 1):
            xs = [x_j(j) for j in range(1, s - k + 2)]
            c = jnp.asarray(partial_bell(s, k, xs)) / math.factorial(s)
            coeff[s + 2 * k] = coeff[s + 2 * k] + c
    coeffs = jnp.stack(coeff)

    def pdf(x: Array) -> Array:
        x = jnp.asarray(x)
        h = (x - mean) / sigma
        base = jnp.exp(-0.5 * h * h) / (jnp.sqrt(2 * jnp.pi) * sigma)
        hermites = hermite_probabilist_all(max_he, h)
        return base * jnp.einsum("...j,j->...", hermites, coeffs)

    return pdf


def legendre_poly_expansion(
    rms: Array, a: FloatScalar = -1.0, b: FloatScalar = 1.0
) -> Callable[[Array], Array]:
    """Legendre expansion of a density supported on [a, b].

    The expansion coefficients are linear in the raw moments: with the
    shifted variable u = (2x - (a + b)) / (b - a), coefficient c_k =
    (2k + 1)/2 * sum_i l_{k,i} m_i where l_{k,i} are the Legendre
    polynomial coefficients — assembled here as one static matrix so the
    pdf is a single matvec + polynomial ladder (reference evaluates a
    per-order Python sum: ``pdf_approximations.py:98-134``).
    """
    num_moments = rms.shape[-1]

    # Static Legendre coefficient matrix L[k, i] = coeff of u^i in P_k(u).
    L = np.zeros((num_moments, num_moments))
    for k in range(num_moments):
        for i in range(k // 2 + 1):
            L[k, k - 2 * i] = (
                (-1) ** i
                * 2.0 ** (-k)
                * math.factorial(2 * k - 2 * i)
                / (
                    math.factorial(i)
                    * math.factorial(k - i)
                    * math.factorial(k - 2 * i)
                )
            )
    Lj = jnp.asarray(L)
    # basis_coeff_k = (2k + 1)/2 * P_k evaluated "at the moments": note
    # the reference applies the raw moments directly as the placeholder
    # powers, i.e. E[P_k(X)] computed with the *unshifted* moments.
    cks = (2 * jnp.arange(num_moments) + 1) / 2.0 * (Lj @ rms)

    def pdf(x: Array) -> Array:
        x = jnp.asarray(x)
        u = (2 * x - (a + b)) / (b - a)
        # powers ladder (..., num_moments)
        pows = [jnp.ones_like(u)]
        for _ in range(num_moments - 1):
            pows.append(pows[-1] * u)
        powstack = jnp.stack(pows, axis=-1)
        legvals = jnp.einsum("...i,ki->...k", powstack, Lj)
        return 2.0 / (b - a) * jnp.einsum("...k,k->...", legvals, cks)

    return pdf


def truncated_cumulant_generating_function(
    z: FloatScalar, ms: Array, mean: FloatScalar = 0.0, scale: FloatScalar = 1.0
) -> Array:
    """K(z) = z mean + log sum_n (z scale)^n m_n / n! (truncated MGF).

    ``ms`` may be raw (defaults), central (mean given), or scaled
    central (scale given).
    """
    num_moments = ms.shape[-1]
    facts = jnp.asarray([math.factorial(n) for n in range(num_moments)], ms.dtype)
    zs = jnp.asarray(z)
    pows = [jnp.ones_like(zs)]
    for _ in range(num_moments - 1):
        pows.append(pows[-1] * (zs * scale))
    powstack = jnp.stack(pows, axis=-1)
    smgf = jnp.einsum("...n,n->...", powstack, ms / facts)
    return zs * mean + jnp.log(smgf)


def saddle_point(
    sms: Array, mean: FloatScalar, scale: FloatScalar, newton_iters: int = 50
) -> Callable[[Array], Array]:
    """Saddle-point density from a polynomial-truncated CGF.

    Solves the saddle equation ``K'(s) = x`` by damped Newton iteration
    from the Gaussian initialiser ``s0 = (x - mean)/scale^2``.  The
    reference selects the nearest real root of the equivalent
    polynomial via companion-matrix eigenvalues
    (``mfs/one_dim/pdf_approximations.py:163-189``) — that relies on
    the nonsymmetric ``eig``, which XLA provides only on the CPU; Newton
    on the (locally convex) CGF is elementwise over all evaluation
    points, differentiable, and runs on any device.
    """
    num_moments = sms.shape[-1]
    facts = jnp.asarray([math.factorial(n) for n in range(num_moments)], sms.dtype)
    poly = jnp.flip(sms / facts)  # highest degree first, S(u) = sum m_n u^n / n!

    def cgf(z):
        return z * mean + jnp.log(jnp.polyval(poly, z * scale))

    d_cgf = jax.grad(cgf)
    dd_cgf = jax.grad(d_cgf)
    d_cgf_v = jax.vmap(d_cgf)
    dd_cgf_v = jax.vmap(dd_cgf)

    def pdf(x: Array) -> Array:
        x = jnp.asarray(x)
        s = (x - mean) / scale**2

        def newton(s, _):
            f = d_cgf_v(s) - x
            fp = dd_cgf_v(s)
            step = f / jnp.where(jnp.abs(fp) < 1e-12, 1e-12, fp)
            # Damp to keep the iterate inside the S(u) > 0 branch.
            step = jnp.clip(step, -2.0 / scale, 2.0 / scale)
            return s - step, None

        s, _ = jax.lax.scan(newton, s, None, length=newton_iters)
        k2 = dd_cgf_v(s)
        val = jnp.exp(jax.vmap(cgf)(s) - s * x) / jnp.sqrt(2 * jnp.pi * k2)
        # Far in the tails the truncated MGF polynomial can leave the
        # S(u) > 0 branch — the approximation is undefined there, so
        # return 0 instead of NaN (the reference's root-based variant
        # silently returns garbage in the same regime).
        return jnp.where(jnp.isfinite(val) & (k2 > 0), val, 0.0)

    return pdf


def inverse_fourier(x: Array, cfs: Array, zs: Array) -> Array:
    """Density by inverse Fourier transform of a characteristic function.

    ``p(x) = (1 / 2 pi) ∫ e^{-i x z} phi(z) dz`` by trapezoid; ``x`` may
    be an array (one pass for all evaluation points).
    """
    x = jnp.asarray(x)
    integrand = jnp.exp(-1.0j * x[..., None] * zs) * cfs
    return jnp.real(jnp.trapezoid(integrand, zs, axis=-1)) / (2 * math.pi)
