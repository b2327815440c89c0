"""1D moment-matched Gauss quadrature (the hot core of the filters).

Given the first 2n moments of a distribution, builds the n-point Gauss
quadrature that matches them exactly (Golub–Welsch via the
multiplication-operator matrix; see Sarmavuori & Särkkä 2019).  This is
the batched counterpart of reference ``mfs/one_dim/quadtures.py``:

- everything accepts an arbitrary leading batch axis: one call computes
  quadratures for thousands of Monte-Carlo trials,
- the eigendecomposition goes through one of the engines of
  ``mfs_tpu.ops.eigh`` (default ``"refined"``), each differentiable.

Pipeline per batch element (n x n throughout):

    gather Hankel pair G, H  →  R = chol(G)  →  K = R^{-1} H R^{-T}
    →  eigh(K)  →  weights = (first eigenvector components)^2,
                   nodes   = scale * eigenvalues + mean.
"""
import functools
import math
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.ops.eigh import eigh, eigh_batched
from mfs_tpu.typings import Array, FloatScalar
from mfs_tpu.utils.linalg import ldl_chol


@functools.lru_cache(maxsize=None)
def _hankel_indices_np(n: int) -> Tuple[np.ndarray, np.ndarray]:
    base = np.arange(n)[:, None] + np.arange(n)[None, :]
    return base, base + 1


def hankel_indices(n: int) -> Tuple[Array, Array]:
    """Index matrices building the Hankel pair (G over orders 0..2n-2,
    H over orders 1..2n-1) from a flat moment vector.

    Compile-time constants (reference: ``mfs/one_dim/quadtures.py:29-60``).
    """
    g, h = _hankel_indices_np(n)
    return jnp.asarray(g), jnp.asarray(h)


def moment_quadrature(
    ms: Array,
    mean: FloatScalar = 0.0,
    scale: FloatScalar = 1.0,
    sort_nodes: bool = False,
    stable: bool = False,
    eigh_impl: str = "refined",
) -> Tuple[Array, Array]:
    """Moment-matched Gauss quadrature from a (batched) moment vector.

    Parameters
    ----------
    ms : Array (..., 2n)
        Moments ``[m_0, m_1, ..., m_{2n-1}]``.  Raw moments when
        mean/scale are left at their defaults; central moments when
        ``mean`` is given; scaled central moments when ``scale`` is
        also given.
    mean : scalar or Array (...)
        Affine re-centering of the nodes.
    scale : scalar or Array (...)
        Affine re-scaling of the nodes.
    sort_nodes : bool
        Sort nodes ascending (not needed by the filters).
    stable : bool
        Replace the Cholesky factorisation by the LDL-based modified
        Cholesky (PD completion) for ill-conditioned moment matrices.
    eigh_impl : {"refined", "xla", "jacobi"}
        Eigensolver engine (``mfs_tpu.ops.eigh.ENGINES``); any other
        value raises ``ValueError``.

    Returns
    -------
    weights : Array (..., n), nodes : Array (..., n)
    """
    n = ms.shape[-1] // 2
    g_inds, h_inds = _hankel_indices_np(n)
    G = ms[..., g_inds]
    H = ms[..., h_inds]

    R = ldl_chol(G) if stable else jax.lax.linalg.cholesky(G)
    K = jax.lax.linalg.triangular_solve(
        R,
        jax.lax.linalg.triangular_solve(R, H, left_side=True, lower=True),
        left_side=False,
        lower=True,
        transpose_a=True,
    )
    # K is symmetric (tridiagonal in exact arithmetic); symmetrise to
    # keep the symmetric eigensolver exact.
    K = 0.5 * (K + jnp.swapaxes(K, -1, -2))

    vals, vecs = eigh(K, eigh_impl, sort=sort_nodes)
    weights = vecs[..., 0, :] ** 2
    mean = jnp.asarray(mean)
    scale = jnp.asarray(scale)
    nodes = scale[..., None] * vals + mean[..., None]
    return weights, nodes


def gauss_quadrature_golub_welsch(
    ms: Array,
    mean: FloatScalar = 0.0,
    scale: FloatScalar = 1.0,
    sort_nodes: bool = False,
) -> Tuple[Array, Array]:
    """Textbook Golub–Welsch: Jacobi tridiagonal from Cholesky ratios.

    Exploits that the multiplication operator is tridiagonal: its
    recurrence coefficients come directly from the Cholesky factor of
    the Gram matrix, skipping the triangular solves (reference keeps
    this variant as documentation: ``mfs/one_dim/quadtures.py:63-80``).
    Batched like ``moment_quadrature``.
    """
    n = ms.shape[-1] // 2
    g_inds, _ = _hankel_indices_np(n)
    G = ms[..., g_inds]
    Rt = jnp.swapaxes(jax.lax.linalg.cholesky(G), -1, -2)  # upper triangular

    diag = jnp.diagonal(Rt, axis1=-2, axis2=-1)  # (..., n)
    sup = jnp.diagonal(Rt, offset=1, axis1=-2, axis2=-1)  # (..., n-1)
    betas = diag[..., 1:-1] / diag[..., :-2]
    alpha0 = Rt[..., 0, 1] / Rt[..., 0, 0]
    alphas_rest = sup[..., 1:] / diag[..., 1:-1] - sup[..., :-1] / diag[..., :-2]
    alphas = jnp.concatenate([alpha0[..., None], alphas_rest], axis=-1)

    K = jnp.zeros(ms.shape[:-1] + (n - 1, n - 1), dtype=ms.dtype)
    idx = np.arange(n - 1)
    K = K.at[..., idx, idx].set(alphas)
    K = K.at[..., idx[:-1], idx[:-1] + 1].set(betas)
    K = K.at[..., idx[:-1] + 1, idx[:-1]].set(betas)

    vals, vecs = eigh_batched(K, sort=sort_nodes)
    weights = vecs[..., 0, :] ** 2
    mean = jnp.asarray(mean)
    scale = jnp.asarray(scale)
    return weights, scale[..., None] * vals + mean[..., None]


def make_derivatives(f: Callable, order: int, argnum: int = 0):
    """List ``[f, f', ..., f^{(order)}]`` w.r.t. the given argument.

    Uses forward-mode ``jacfwd`` so vector-valued integrands work too
    (the Taylor filter expands the whole conditional-moment vector).
    Scalar-argument only — for the batched tower used by the filters
    see ``make_derivatives_elementwise``.
    """
    derivatives = [f]
    for _ in range(order):
        derivatives.append(
            (lambda g: lambda x, *args: jax.jacfwd(g, argnums=argnum)(x, *args))(
                derivatives[-1]
            )
        )
    return derivatives


def make_derivatives_elementwise(f: Callable, order: int):
    """Derivative tower ``[f, f', ..., f^{(order)}]`` for *elementwise* f.

    Each derivative is a nested unit-tangent JVP: for a function that
    acts elementwise in its first argument (possibly with extra
    trailing output axes, like the conditional-moment vectors), the
    directional derivative along ``ones_like(x)`` IS the elementwise
    derivative.  Unlike ``jacfwd`` this never materialises a (B, B)
    Jacobian, so the tower batches over arbitrary leading axes, which
    the reference's scalar tower does not.
    Exact (plain forward-mode AD), unlike ``jax.experimental.jet``
    whose expansion rules for ``tanh``/``integer_pow`` carry ~1e-8
    relative error.
    """
    derivatives = [f]
    for _ in range(order):
        derivatives.append(
            (
                lambda g: lambda x, *args: jax.jvp(
                    lambda u: g(u, *args), (x,), (jnp.ones_like(x),)
                )[1]
            )(derivatives[-1])
        )
    return derivatives


def taylor_quadrature(
    f: Callable[..., FloatScalar],
    cms: Array,
    mean: FloatScalar,
    order: int,
    *operands: Any,
) -> Array:
    """E[f(X)] by Taylor expansion around the mean with central moments.

    ``E[f(X)] ≈ f(m) + Σ_r f^{(r)}(m) cms[..., r] / r!`` (reference:
    ``mfs/one_dim/quadtures.py:151-183``).  Batched: ``cms (..., 2N)``
    and ``mean (...)`` may carry leading trial axes, and ``f`` must be
    elementwise in its first argument (all in-repo model callables
    are — see ``mfs_tpu.sde.transitions``).  Vector-valued integrands
    (extra trailing axes on ``f``'s output) broadcast correctly.
    """
    cms = jnp.asarray(cms)
    mean = jnp.asarray(mean)
    derivatives = make_derivatives_elementwise(f, order)
    result = derivatives[0](mean, *operands)
    for r in range(1, order + 1):
        coeff = cms[..., r] / math.factorial(r)
        d_r = derivatives[r](mean, *operands)
        coeff = coeff.reshape(coeff.shape + (1,) * (d_r.ndim - coeff.ndim))
        result = result + d_r * coeff
    return result
