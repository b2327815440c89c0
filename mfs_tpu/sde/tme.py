"""Taylor moment expansion (TME) of SDE conditional expectations.

In-repo replacement for the reference's external ``tme`` dependency
(used at reference ``mfs/one_dim/moments.py:23`` and
``mfs/multi_dims/moments.py:24``).  For the diffusion

    dX(t) = a(X(t)) dt + b(X(t)) dW(t)

the infinitesimal generator is  ``A f = (∇f)·a + ½ tr(b bᵀ ∇²f)``  and
the TME of order ``p`` approximates the conditional expectation

    E[f(X_{t+dt}) | X_t = x] ≈ Σ_{r=0}^{p} dt^r / r!  (A^r f)(x).

Design notes:

- ``f`` may be *vector- or matrix-valued*: one generator application
  computes all components in a single ``jax.jvp`` pass.  The moment
  filters exploit this by passing the full vector of 2N monomials, so
  the whole conditional-moment matrix is produced by ``order`` nested
  autodiff passes instead of ``2N x order`` (the reference re-expands
  per moment order inside a double vmap).
- A scalar-state fast path (``*_1d``) avoids all (1,)-vector wrapping.
- Everything is elementwise in the state, so it vmaps freely over
  quadrature nodes and Monte-Carlo trials.

Reference for the method: Zhao (2021), "Taylor moment expansion for
continuous-discrete Gaussian filtering".
"""
import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from mfs_tpu.typings import Array, FloatScalar


def generator_1d(phi: Callable, drift: Callable, dispersion: Callable) -> Callable:
    """Generator for scalar-state SDEs: ``A phi = a phi' + 0.5 b^2 phi''``.

    ``phi`` maps a scalar to an array of any shape; both derivatives are
    computed with forward-mode JVPs so all output components share one
    pass.
    """

    def a_phi(x):
        x = jnp.asarray(x)
        one = jnp.ones_like(x)
        d_phi = lambda u: jax.jvp(phi, (u,), (jnp.ones_like(u),))[1]
        _, dphi = jax.jvp(phi, (x,), (one,))
        _, ddphi = jax.jvp(d_phi, (x,), (one,))
        # phi may append trailing axes (e.g. the vector of all 2N
        # monomials); align the elementwise drift/dispersion factors.
        extra = dphi.ndim - x.ndim
        expand = (...,) + (None,) * extra if extra else (...,)
        a = jnp.asarray(drift(x) * jnp.ones_like(x))[expand]
        b = jnp.asarray(dispersion(x) * jnp.ones_like(x))[expand]
        return a * dphi + 0.5 * b * b * ddphi

    return a_phi


def generator(phi: Callable, drift: Callable, dispersion: Callable) -> Callable:
    """Generator for vector-state SDEs, ``phi: (d,) -> any shape``.

    The Hessian contraction uses d^2 nested JVPs along basis vectors —
    cheap for the small state dimensions of filtering problems and
    exact for any output shape.
    """

    def a_phi(x):
        d = x.shape[0]
        a = drift(x)
        b = jnp.atleast_2d(dispersion(x))
        gamma = b @ b.T  # (d, d)

        _, first = jax.jvp(phi, (x,), (a,))

        basis = [jnp.zeros_like(x).at[i].set(1.0) for i in range(d)]
        second = None
        for i in range(d):
            di_phi = lambda u, _e=basis[i]: jax.jvp(phi, (u,), (_e,))[1]
            for j in range(i, d):
                _, dij = jax.jvp(di_phi, (x,), (basis[j],))
                w = gamma[i, j] if i == j else 2.0 * gamma[i, j]
                contrib = 0.5 * w * dij
                second = contrib if second is None else second + contrib
        return first + second

    return a_phi


def _expansion(phi: Callable, gen: Callable, x, dt, order: int):
    terms = phi(x)
    a_r = phi
    coeff = 1.0
    for r in range(1, order + 1):
        a_r = gen(a_r)
        coeff = coeff * dt / r
        terms = terms + coeff * a_r(x)
    return terms


def expectation_1d(
    phi: Callable,
    x: FloatScalar,
    dt: FloatScalar,
    drift: Callable,
    dispersion: Callable,
    order: int = 3,
):
    """TME of ``E[phi(X_{t+dt}) | X_t = x]`` for scalar-state SDEs."""
    gen = lambda f: generator_1d(f, drift, dispersion)
    return _expansion(phi, gen, x, dt, order)


def expectation(
    phi: Callable,
    x: Array,
    dt: FloatScalar,
    drift: Callable,
    dispersion: Callable,
    order: int = 3,
):
    """TME of ``E[phi(X_{t+dt}) | X_t = x]`` for vector-state SDEs."""
    gen = lambda f: generator(f, drift, dispersion)
    return _expansion(phi, gen, x, dt, order)


def _generator_powers(phi: Callable, gen_of: Callable, x, order: int):
    """[(A^0 phi)(x), ..., (A^order phi)(x)] by iterated generator."""
    terms = [phi(x)]
    a_r = phi
    for _ in range(order):
        a_r = gen_of(a_r)
        terms.append(a_r(x))
    return terms


def _consistent_mean_cov(id_terms, sq_terms, dt, order, outer_fn):
    """Consistently truncated TME mean/cov (Zhao 2021, Eq. for Sigma_p).

    cov = Σ_{r=1}^{p} dt^r/r! [ A^r(x xᵀ)
            − Σ_{k=0}^{r} C(r,k) (A^k x) ⊗ (A^{r−k} x) ].

    This cancellation-by-construction makes order 1 coincide exactly
    with Euler–Maruyama and keeps every truncation order a valid O(dt)
    covariance — subtracting the *squared truncated mean* instead would
    inject spurious O(dt^2) terms.
    """
    mean = id_terms[0]
    coeff = 1.0
    for r in range(1, order + 1):
        coeff = coeff * dt / r
        mean = mean + coeff * id_terms[r]

    cov = None
    coeff = 1.0
    for r in range(1, order + 1):
        coeff = coeff * dt / r
        inner = sq_terms[r]
        for k in range(r + 1):
            inner = inner - math.comb(r, k) * outer_fn(id_terms[k], id_terms[r - k])
        cov = coeff * inner if cov is None else cov + coeff * inner
    return mean, cov


def mean_and_var_1d(
    x: FloatScalar,
    dt: FloatScalar,
    drift: Callable,
    dispersion: Callable,
    order: int = 3,
) -> Tuple[Array, Array]:
    """TME conditional mean and variance for scalar-state SDEs.

    Uses the consistently truncated covariance expansion (order 1
    recovers Euler–Maruyama exactly).
    """
    gen_of = lambda f: generator_1d(f, drift, dispersion)
    id_terms = _generator_powers(lambda u: u, gen_of, x, order)
    sq_terms = _generator_powers(lambda u: u * u, gen_of, x, order)
    return _consistent_mean_cov(
        id_terms, sq_terms, dt, order, lambda a, b: a * b
    )


def mean_and_cov(
    x: Array,
    dt: FloatScalar,
    drift: Callable,
    dispersion: Callable,
    order: int = 3,
) -> Tuple[Array, Array]:
    """TME conditional mean and covariance for vector-state SDEs.

    Uses the consistently truncated covariance expansion (order 1
    recovers Euler–Maruyama exactly).
    """
    gen_of = lambda f: generator(f, drift, dispersion)
    id_terms = _generator_powers(lambda u: u, gen_of, x, order)
    sq_terms = _generator_powers(lambda u: jnp.outer(u, u), gen_of, x, order)
    return _consistent_mean_cov(
        id_terms, sq_terms, dt, order, lambda a, b: jnp.outer(a, b)
    )
