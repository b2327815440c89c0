"""Batched small symmetric eigendecomposition for the moment quadrature.

Every filter step eigendecomposes thousands of tiny (n <= ~32)
symmetric multiplication-operator matrices.  Three engines are
offered, chosen by name with ``eigh`` (``ENGINES``):

- ``"refined"`` (the default): an f32 ``lax.linalg.eigh`` seed, one
  Newton–Schulz re-orthonormalisation and a perturbative f64 polish
  (``eigh_refined``);
- ``"xla"``: ``lax.linalg.eigh`` in the input precision (``eigh_xla``);
- ``"jacobi"``: an in-repo *parallel-ordered cyclic Jacobi* solver
  (``eigh_batched``) in which every sweep is a static round-robin
  schedule of n/2 disjoint rotations applied simultaneously, each
  round is one orthogonal matrix applied by two batched matmuls, and
  the sweep count is a compile-time constant (cyclic Jacobi converges
  quadratically; the default is calibrated in tests to f64 machine
  precision for n <= 32).

The in-repo solvers carry a custom JVP implementing the standard eigh
differentiation rule, so the negative log-likelihood stays
differentiable through the quadrature (the reference relies on JAX's
built-in rules: reference ``mfs/one_dim/quadtures.py:131``,
``dardel/parameter_estimation/mf.py:37-72``).
"""
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.typings import Array


@functools.lru_cache(maxsize=None)
def _round_robin_schedule(n: int) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
    """Static tournament schedule: n-1 rounds of n/2 disjoint (p, q) pairs.

    For odd n one virtual index sits out each round (classic circle
    method).  Returns tuples of (ps, qs) index arrays with p < q.
    """
    m = n if n % 2 == 0 else n + 1
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        ps, qs = [], []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a < n and b < n:
                ps.append(min(a, b))
                qs.append(max(a, b))
        rounds.append((np.array(ps), np.array(qs)))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _default_sweeps(n: int) -> int:
    # Cyclic Jacobi converges quadratically; these are conservative
    # (validated to f64 machine precision in tests/test_ops_eigh.py).
    if n <= 4:
        return 6
    if n <= 12:
        return 8
    if n <= 24:
        return 10
    return 12


@functools.lru_cache(maxsize=None)
def _stacked_round_consts(n: int):
    """Stacked one-hot selector/assembler tensors for all rounds.

    Rounds of the tournament schedule are padded to a common pair count
    so a single ``fori_loop`` body (traced once — the unrolled variant
    compiled one kernel per round and took minutes to build) can index
    them dynamically.  Padded slots have all-zero bases, which makes
    their rotation exactly the identity.

    Returns (Ppp, Pqq, Ppq, D, S) each of shape (rounds, m, n, n).
    """
    schedule = _round_robin_schedule(n)
    m_max = max(len(ps) for ps, _ in schedule)
    r = len(schedule)
    ppp = np.zeros((r, m_max, n, n))
    pqq = np.zeros((r, m_max, n, n))
    ppq = np.zeros((r, m_max, n, n))
    diag = np.zeros((r, m_max, n, n))
    skew = np.zeros((r, m_max, n, n))
    for i, (ps, qs) in enumerate(schedule):
        k = np.arange(len(ps))
        ppp[i, k, ps, ps] = 1.0
        pqq[i, k, qs, qs] = 1.0
        ppq[i, k, ps, qs] = 1.0
        diag[i, k, ps, ps] = 1.0
        diag[i, k, qs, qs] = 1.0
        skew[i, k, ps, qs] = 1.0
        skew[i, k, qs, ps] = -1.0
    return ppp, pqq, ppq, diag, skew


def _jacobi_eigh(a: Array, sweeps: int) -> Tuple[Array, Array]:
    n = a.shape[-1]
    dtype = a.dtype
    eye = jnp.eye(n, dtype=dtype)
    v = jnp.broadcast_to(eye, a.shape)
    ppp, pqq, ppq, diag_b, skew_b = (
        jnp.asarray(t, dtype) for t in _stacked_round_consts(n)
    )
    rounds = ppp.shape[0]

    def body(i, carry):
        a, v = carry
        r = i % rounds
        sel_pp, sel_qq, sel_pq = ppp[r], pqq[r], ppq[r]
        app = jnp.einsum("...ij,mij->...m", a, sel_pp)
        aqq = jnp.einsum("...ij,mij->...m", a, sel_qq)
        apq = jnp.einsum("...ij,mij->...m", a, sel_pq)
        # Golub–Van Loan 8.4.1 rotation choice (smaller-angle root).
        # The skip threshold is *relative* to the local diagonal scale:
        # rotations below f64 epsilon contribute nothing, and bounding
        # |tau| <= 5e17 keeps tau^2 < 3e35, inside the f32 range too, so
        # the rotation never overflows into NaNs.  Padded slots have
        # app = aqq = apq = 0, hence c = 1, s = 0.
        diag_scale = jnp.abs(app) + jnp.abs(aqq)
        small = jnp.abs(apq) <= 1e-18 * diag_scale
        safe_apq = jnp.where(small, 1.0, apq)
        tau = (aqq - app) / (2.0 * safe_apq)
        t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(tau == 0.0, 1.0, t)
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        # Q = I + Σ_m [(c_m - 1)(E_pp + E_qq) + s_m (E_pq - E_qp)].
        q = (
            eye
            + jnp.einsum("...m,mij->...ij", c - 1.0, diag_b[r])
            + jnp.einsum("...m,mij->...ij", s, skew_b[r])
        )
        aq = jnp.einsum("...jk,...kl->...jl", a, q)
        a = jnp.einsum("...ji,...jl->...il", q, aq)
        # Re-symmetrise to kill rounding drift.
        a = 0.5 * (a + jnp.swapaxes(a, -1, -2))
        v = jnp.einsum("...ij,...jk->...ik", v, q)
        return a, v

    a, v = jax.lax.fori_loop(0, sweeps * rounds, body, (a, v))
    vals = jnp.diagonal(a, axis1=-2, axis2=-1)
    return vals, v


@functools.partial(jax.custom_jvp, nondiff_argnums=(1,))
def _eigh_core(a: Array, sweeps: int) -> Tuple[Array, Array]:
    return _jacobi_eigh(a, sweeps)


def _safe_gap_reciprocal(vals: Array, n: int) -> Array:
    """Degeneracy-guarded 1/(w_j - w_i) for the eigh JVP.

    The N-D multiplication operators have *structurally repeated*
    eigenvalues (see ``multi_dims/quadrature.py``), where the raw
    reciprocal gap is inf/NaN.  Within a degenerate cluster the choice
    of basis is arbitrary and the downstream quadrature weights are
    invariant under in-cluster rotations, so the correct tangent
    contribution is zero: gaps below ``eps * spread`` are dropped, and
    the survivors are clamped away from zero for safety.
    """
    gaps = vals[..., None, :] - vals[..., :, None]  # gaps[i, j] = w_j - w_i
    off = ~jnp.eye(n, dtype=bool)
    spread = (
        jnp.max(vals, axis=-1) - jnp.min(vals, axis=-1)
    )[..., None, None] + jnp.finfo(vals.dtype).tiny
    degenerate = jnp.abs(gaps) <= 1e-9 * spread
    keep = off & ~degenerate
    mag = jnp.maximum(jnp.abs(gaps), 1e-12 * spread)
    return jnp.where(keep, jnp.sign(gaps) / mag, 0.0)


@_eigh_core.defjvp
def _eigh_core_jvp(sweeps, primals, tangents):
    (a,) = primals
    (da,) = tangents
    vals, vecs = _eigh_core(a, sweeps)
    da = 0.5 * (da + jnp.swapaxes(da, -1, -2))
    s = jnp.einsum("...ji,...jk,...kl->...il", vecs, da, vecs)
    dvals = jnp.diagonal(s, axis1=-2, axis2=-1)
    f = _safe_gap_reciprocal(vals, a.shape[-1])
    dvecs = jnp.einsum("...ik,...kj->...ij", vecs, f * s)
    return (vals, vecs), (dvals, dvecs)


def eigh_batched(a: Array, sweeps: int = None, sort: bool = False) -> Tuple[Array, Array]:
    """Eigendecomposition of a batch of small symmetric matrices.

    Parameters
    ----------
    a : Array (..., n, n)
        Symmetric matrices.
    sweeps : int, optional
        Number of cyclic-Jacobi sweeps (static).  Default is a
        conservative size-based heuristic.
    sort : bool
        Sort eigenvalues (and eigenvectors) ascending.  The moment
        quadrature does not require sorting.

    Returns
    -------
    vals : Array (..., n), vecs : Array (..., n, n)
        ``a ≈ vecs @ diag(vals) @ vecs.T`` (columns are eigenvectors).
    """
    n = a.shape[-1]
    if sweeps is None:
        sweeps = _default_sweeps(n)
    vals, vecs = _eigh_core(a, sweeps)
    if sort:
        order = jnp.argsort(vals, axis=-1)
        vals = jnp.take_along_axis(vals, order, axis=-1)
        vecs = jnp.take_along_axis(vecs, order[..., None, :], axis=-1)
    return vals, vecs


def eigh_xla(a: Array, sort: bool = False) -> Tuple[Array, Array]:
    """XLA's eigh with the same (vals, vecs) return convention."""
    vecs, vals = jax.lax.linalg.eigh(a, sort_eigenvalues=sort)
    return vals, vecs


@functools.partial(jax.custom_jvp, nondiff_argnums=(1,))
def _eigh_refined_core(a: Array, polish_sweeps: int) -> Tuple[Array, Array]:
    # Stage 1: XLA's eigh *in f32*.  The seed only needs ~f32 quality:
    # the stages below restore f64.  Pre-scale by 1/max|a| so entries
    # outside the f32 range (raw-moment operators of wide-spread states
    # overflow; extreme scaled modes underflow) stay representable —
    # eigenvectors are scale-invariant so the seed is unchanged where
    # no over/underflow occurs.
    scale = jnp.max(jnp.abs(a), axis=(-2, -1), keepdims=True)
    scale = jnp.where(scale > 0, scale, 1.0)
    vecs0, _ = jax.lax.linalg.eigh(
        (a / scale).astype(jnp.float32), sort_eigenvalues=False
    )
    vecs0 = vecs0.astype(a.dtype)
    # Stage 1b: one Newton–Schulz iteration re-orthonormalises the
    # approximate eigenbasis in f64 (orthogonality error squares:
    # ~1e-7 -> ~1e-14); without this the similarity transform below is
    # only as exact as stage 1's orthogonality.
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=a.dtype)
    gram = jnp.einsum("...ki,...kj->...ij", vecs0, vecs0)
    vecs0 = jnp.einsum("...ik,...kj->...ij", vecs0, 1.5 * eye - 0.5 * gram)
    # Stage 2: rotate into the approximate eigenbasis with f64 matmuls.
    a1 = jnp.einsum("...ji,...jk,...kl->...il", vecs0, a, vecs0)
    a1 = 0.5 * (a1 + jnp.swapaxes(a1, -1, -2))

    if polish_sweeps > 0:
        # Optional cyclic-Jacobi polish (exact quadratic cleanup, but
        # ~3 matmuls per round).
        vals, v1 = _jacobi_eigh(a1, polish_sweeps)
        vecs = jnp.einsum("...ij,...jk->...ik", vecs0, v1)
        return vals, vecs

    # Default polish: Rayleigh–Schrödinger perturbation on the
    # near-diagonal a1 = D + E (|E| ~ 1e-7 ||a||):
    #   lambda_j = d_j + sum_{i != j} E_ij^2 / (d_j - d_i) + O(E^3),
    #   v_j      = e_j + sum_{i != j} E_ij / (d_j - d_i) e_i + O(E^2).
    # One matmul applies the eigenvector correction; residuals are
    # second order, ~1e-13 for the quadrature's node-gap regime.
    # Near-degenerate pairs (gap comparable to the off-diagonal mass)
    # get no correction — the subspace rotation is already arbitrary.
    d = jnp.diagonal(a1, axis1=-2, axis2=-1)
    off = a1 - d[..., None] * eye
    gaps = d[..., None, :] - d[..., :, None]  # gaps[i, j] = d_j - d_i
    offdiag_scale = jnp.max(jnp.abs(off), axis=(-2, -1), keepdims=True)
    safe = jnp.abs(gaps) > 32.0 * offdiag_scale
    corr = jnp.where(safe, off / jnp.where(safe, gaps, 1.0), 0.0)
    vals = d + jnp.sum(jnp.where(safe, off * corr, 0.0), axis=-2)
    v1 = eye + corr
    vecs = jnp.einsum("...ij,...jk->...ik", vecs0, v1)
    return vals, vecs


@_eigh_refined_core.defjvp
def _eigh_refined_core_jvp(polish_sweeps, primals, tangents):
    (a,) = primals
    (da,) = tangents
    vals, vecs = _eigh_refined_core(a, polish_sweeps)
    da = 0.5 * (da + jnp.swapaxes(da, -1, -2))
    s = jnp.einsum("...ji,...jk,...kl->...il", vecs, da, vecs)
    dvals = jnp.diagonal(s, axis1=-2, axis2=-1)
    f = _safe_gap_reciprocal(vals, a.shape[-1])
    dvecs = jnp.einsum("...ik,...kj->...ij", vecs, f * s)
    return (vals, vecs), (dvals, dvecs)


def eigh_refined(a: Array, polish_sweeps: int = 0, sort: bool = False) -> Tuple[Array, Array]:
    """f32 XLA eigh seed + f64 polish — the filters' default engine.

    The approximate eigenbasis from an f32 ``lax.linalg.eigh`` nearly
    diagonalises the matrix; one Newton–Schulz step restores f64
    orthogonality, and a second-order perturbative correction
    (``polish_sweeps=0``, the default: ~5 f64 matmuls in total) or
    ``polish_sweeps`` cyclic-Jacobi sweeps (exact quadratic cleanup,
    ~3 matmuls per round) finish the job in f64.  Within an exactly
    degenerate cluster (the N-D operators have structurally repeated
    eigenvalues) the basis is left as the seed gives it; any
    orthonormal basis of the cluster gives the same quadrature.
    Differentiable via the standard eigh JVP.
    """
    vals, vecs = _eigh_refined_core(a, polish_sweeps)
    if sort:
        order = jnp.argsort(vals, axis=-1)
        vals = jnp.take_along_axis(vals, order, axis=-1)
        vecs = jnp.take_along_axis(vecs, order[..., None, :], axis=-1)
    return vals, vecs


_ENGINE_FNS = {"refined": eigh_refined, "xla": eigh_xla, "jacobi": eigh_batched}
ENGINES = tuple(_ENGINE_FNS)


def eigh(a: Array, impl: str = "refined", sort: bool = False) -> Tuple[Array, Array]:
    """Eigendecomposition of a batch of symmetric matrices by engine name.

    ``impl`` is one of ``ENGINES`` (anything else raises
    ``ValueError``); returns ``(vals, vecs)`` with the eigenvectors as
    columns, as every engine does.
    """
    if impl not in _ENGINE_FNS:
        raise ValueError(
            f"unknown eigh_impl {impl!r}; valid engines are {', '.join(ENGINES)}"
        )
    return _ENGINE_FNS[impl](a, sort=sort)
