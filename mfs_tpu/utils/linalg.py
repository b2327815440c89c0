"""Dense linear-algebra helpers for the moment core.

Batched-by-construction counterparts of reference ``mfs/utils.py:340-538``:
every routine accepts arbitrary leading batch axes, because the batched
design amortises tiny (n <= ~32) factorisations over thousands of
Monte-Carlo trials.
"""
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.typings import Array


def ldl(mat: Array) -> Tuple[Array, Array]:
    """Batched LDL^T decomposition of a symmetric matrix.

    ``mat = L diag(d) L^T`` with unit-lower-triangular L.  The column
    loop is static (n is a compile-time constant) and every iteration
    is a full-width masked vector op, so the routine batches over any
    leading axes — unlike the reference's sequential ``.at[]`` updates
    on a single matrix (reference: ``mfs/utils.py:495-523``).

    Parameters
    ----------
    mat : Array (..., n, n)

    Returns
    -------
    L : Array (..., n, n), d : Array (..., n)
    """
    n = mat.shape[-1]
    dtype = mat.dtype
    L = jnp.zeros_like(mat) + jnp.eye(n, dtype=dtype)
    d = jnp.zeros(mat.shape[:-1], dtype=dtype)

    for j in range(n):
        mask = np.arange(n) < j  # static
        v = jnp.where(mask, L[..., j, :] * d, 0.0)  # (..., n)
        dj = mat[..., j, j] - jnp.sum(L[..., j, :] * v, axis=-1)
        d = d.at[..., j].set(dj)
        # rows j+1..n of column j
        col = (mat[..., :, j] - jnp.einsum("...ik,...k->...i", L, v)) / dj[..., None]
        row_mask = np.arange(n) > j
        newcol = jnp.where(row_mask, col, L[..., :, j])
        L = L.at[..., :, j].set(newcol)
    return L, d


def ldl_chol(mat: Array, eps: float = None) -> Array:
    """Modified-Cholesky PD completion via LDL (batched).

    Negative pivots are clamped to a small positive epsilon, yielding a
    usable lower-triangular factor of a nearby PD matrix — the
    ``stable=True`` path of the moment filters (reference:
    ``mfs/utils.py:526-538``).
    """
    if eps is None:
        eps_val = 1e-8 * jnp.linalg.norm(mat, "fro", axis=(-2, -1))
        eps_val = eps_val[..., None]
    else:
        eps_val = eps
    L, d = ldl(mat)
    # The inner where keeps sqrt away from the clamped pivots: sqrt's
    # infinite slope at 0 would turn their zero cotangent into nan.
    clamped = d < 0
    scale = jnp.where(clamped, eps_val, jnp.sqrt(jnp.where(clamped, 1.0, d)))
    return L * scale[..., None, :]


def lanczos(a: Array, v0: Array, m: int) -> Tuple[Array, Array, Array]:
    """Lanczos tridiagonalisation ``a ~ V T V^T`` (reference: ``mfs/utils.py:340-389``).

    Parameters
    ----------
    a : Array (n, n) symmetric.
    v0 : Array (n,) with unit norm.
    m : int, number of iterations (1 <= m <= n).

    Returns
    -------
    V : Array (n, m), alphas : Array (m,), betas : Array (m - 1,)
    """

    def step(carry, _):
        v_prev, w = carry
        beta = jnp.sqrt(jnp.sum(w**2))
        v = w / beta
        av = a @ v
        alpha = jnp.dot(av, v)
        w_next = av - alpha * v - beta * v_prev
        return (v, w_next), (v, alpha, beta)

    av0 = a @ v0
    alpha0 = jnp.dot(av0, v0)
    w0 = av0 - alpha0 * v0
    _, (vs, alphas, betas) = jax.lax.scan(step, (v0, w0), None, length=m - 1)
    V = jnp.concatenate([v0[None, :], vs], axis=0).T
    return V, jnp.concatenate([alpha0[None], alphas]), betas


def lanczos_ritz(a: Array, v0: Array, m: int, sort_eigenvalues: bool = True) -> Tuple[Array, Array]:
    """Ritz pairs from m Lanczos iterations (reference: ``mfs/utils.py:392-428``)."""
    norm = jnp.linalg.norm(v0)
    V, alphas, betas = lanczos(a, v0 / norm, m)
    T = jnp.diag(alphas) + jnp.diag(betas, k=-1) + jnp.diag(betas, k=1)
    vecs, vals = jax.lax.linalg.eigh(T, sort_eigenvalues=sort_eigenvalues)
    ritz_vectors = jnp.einsum("ik,kj,j->ij", V, vecs, vecs[0, :] * norm)
    return ritz_vectors, vals
