"""Multidimensional moment-matched quadrature.

Counterpart of reference ``mfs/multi_dims/quadratures.py:120-178``:
from the graded-lex moment vector, gather the Gram matrix G and the d
multiplication matrices H_i, orthonormalise them against chol(G), and
eigendecompose the d resulting commuting operators.  Nodes are the
Cartesian products of the per-dimension eigenvalues; the weight of a
node combination c = (c_1, ..., c_d) is

    w(c) = v_1(c_1)[0] * prod_i <v_i(c_i), v_{i+1}(c_{i+1})> * v_d(c_d)[0].

Deltas from the reference: arbitrary leading batch axes; the chained
inner products are d-1 batched (s, s) Gram matmuls + static
Cartesian-index gathers, instead of materialising all n^d eigenvector
combinations.
"""
import itertools
from functools import lru_cache
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.ops.eigh import eigh
from mfs_tpu.typings import Array
from mfs_tpu.utils.linalg import ldl_chol


@lru_cache(maxsize=None)
def _cartesian_indices(d: int, n: int) -> np.ndarray:
    """All n^d index combinations, shape (n^d, d) — trace-time constant."""
    return np.asarray(list(itertools.product(range(n), repeat=d)), dtype=np.int64)


def nd_cartesian_prod_indices(d: int, n: int) -> np.ndarray:
    """Public alias (reference: ``mfs/multi_dims/quadratures.py:29-48``)."""
    return _cartesian_indices(d, n).copy()


def nd_cartesian_prod(x: Array, inds: np.ndarray = None) -> Array:
    """All n^d combinations of d n-vectors (rows of ``x``).

    ``x`` has shape (d, n, ...); returns (n^d, ..., d) — one entry of
    each row per combination (reference:
    ``mfs/multi_dims/quadratures.py:51-87``).
    """
    d, n = x.shape[:2]
    if inds is None:
        inds = _cartesian_indices(d, n)
    cols = [x[i, inds[:, i]] for i in range(d)]
    return jnp.stack(cols, axis=-1)


def moment_quadrature_nd(
    ms: Array,
    inds: Union[Array, np.ndarray],
    mean: Array = None,
    scale: Array = None,
    sort_nodes: bool = False,
    stable: bool = False,
    eigh_impl: str = "refined",
) -> Tuple[Array, Array]:
    """Multidimensional Gauss quadrature from a graded-lex moment vector.

    Parameters
    ----------
    ms : Array (..., z)
        Moments in graded-lex order; raw/central/scaled depending on
        whether ``mean``/``scale`` are given.
    inds : (d + 1, s, s) static index array from
        ``gram_and_hankel_indices_graded_lexico``.
    mean : Array (..., d), optional — recentre the nodes.
    scale : Array (..., d), optional — rescale the nodes.
    sort_nodes, stable, eigh_impl : as in the 1D quadrature.  The d
        multiplication operators have *structurally repeated*
        eigenvalues (each coordinate value appears for several basis
        polynomials).  Within an exactly degenerate cluster any
        orthonormal basis gives the same chained-inner-product
        quadrature, so every engine's arbitrary in-cluster rotation is
        harmless.

    Returns
    -------
    weights : Array (..., s^d), nodes : Array (..., s^d, d)
    """
    inds = np.asarray(inds)
    d, s = inds.shape[0] - 1, inds.shape[1]

    G = ms[..., inds[0]]  # (..., s, s)
    Hs = ms[..., inds[1:]]  # (..., d, s, s)

    R = ldl_chol(G) if stable else jax.lax.linalg.cholesky(G)
    # Explicitly broadcast over the d multiplication matrices —
    # triangular_solve does not broadcast singleton batch dims.
    Rb = jnp.broadcast_to(R[..., None, :, :], Hs.shape)
    Ks = jax.lax.linalg.triangular_solve(
        Rb,
        jax.lax.linalg.triangular_solve(Rb, Hs, left_side=True, lower=True),
        left_side=False,
        lower=True,
        transpose_a=True,
    )
    Ks = 0.5 * (Ks + jnp.swapaxes(Ks, -1, -2))
    vals, vecs = eigh(Ks, eigh_impl, sort=sort_nodes)
    # vals: (..., d, s); vecs: (..., d, s, s), columns are eigenvectors.

    combs = _cartesian_indices(d, s)  # (s^d, d)

    # Nodes: per-dimension eigenvalue picked by each combination.
    nodes = jnp.stack(
        [vals[..., i, :][..., combs[:, i]] for i in range(d)], axis=-1
    )  # (..., s^d, d)

    # Weights: first components of the first/last eigvecs and chained
    # Gram matrices of consecutive eigenvector sets.
    w = vecs[..., 0, 0, :][..., combs[:, 0]] * vecs[..., d - 1, 0, :][..., combs[:, d - 1]]
    for i in range(d - 1):
        gram = jnp.einsum("...ki,...kj->...ij", vecs[..., i, :, :], vecs[..., i + 1, :, :])
        w = w * gram[..., combs[:, i], combs[:, i + 1]]

    if mean is None:
        return w, nodes
    mean = jnp.asarray(mean)
    if scale is None:
        return w, nodes + mean[..., None, :]
    scale = jnp.asarray(scale)
    return w, nodes * scale[..., None, :] + mean[..., None, :]
