"""Closed-form (matmul) TME transition moments for polynomial SDEs.

The autodiff N-D TME factory (``sde_cond_moments_nd_tme``) evaluates an
order-``k`` nested-JVP tower *per quadrature node* — hundreds of small
fused ops inside every scan step, the dominant cost of the 2D filter
once the quadrature kernel is fused (round-2 profile: ~2.0 s of a
2.1 s N=3 step budget at 256 trials).  For polynomial drift ``a`` and
diffusion outer-product ``b bᵀ`` (e.g. stochastic Lotka–Volterra,
``models/multi_dims.py:61-65``), the SDE generator

    L f = a · ∇f + 1/2 (b bᵀ) : ∇²f

maps polynomials to polynomials, so the whole TME expansion

    E[φ(X_{t+dt}) | X_t = x]  ≈  Σ_k dt^k/k!  (L^k φ)(x)

collapses into *linear algebra over monomial-coefficient vectors*:

- trace time (host NumPy): exact Taylor coefficients of ``a`` and
  ``b bᵀ`` (nested ``jacfwd`` at 0 — exact for polynomials), plus one
  constant operator tensor ``O[(γ, i)] = M_γ D_i`` /
  ``O[(γ, i, j)] = 1/2 M_γ D_i D_j`` per coefficient monomial γ, where
  ``D_i`` differentiates and ``M_γ`` multiplies by ``mono_γ`` on the
  graded-lex basis (``multi_indices.py`` machinery);
- run time: the generator in the *shifted/scaled frame* v = (u−m)/s
  (the frame the central/scaled filters evaluate in — shifting the
  frame rather than the moments avoids the binomial-shift cancellation,
  see ``sde_cond_moments_nd_tme``) is ``L̃ = Σ_t c_t(m, s) O_t`` with
  per-trial scalars ``c_t`` from a Pascal shift/scale transform of the
  base coefficients.  Applying ``L̃ᵀ`` to a value vector is one batched
  GEMM against the stacked constant ``O`` tensor.

The big win is the **fused predict contraction**: the filter's
prediction only ever needs  Σ_node w · E[φ_j | node]  — by linearity
the weight contraction moves *inside* the tower,

    predicted_j = Σ_k dt^k/k! · ( (C̃ᵀ)^k q₀ )_j ,
    q₀ = Σ_node w · mono_ext(v_node) ,

so the TME tower is applied to ONE ``z_ext``-vector per trial instead
of per node: order × (B, z_ext) × (z_ext, n_ops·z_ext) GEMMs per step,
plain matmuls, no autodiff.  Truncation at the extended degree
``2N−1 + order·rise`` is exact for every entry the filter reads (the
coefficient chain from a degree-(2N−1) monomial can't leave the
extended basis within ``order`` applications).

No reference counterpart: ``mfs`` evaluates the external ``tme``
package per node per multi-index (``mfs/multi_dims/moments.py:414-479``).
"""
import math
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.multi_dims.multi_indices import (
    generate_graded_lexico_multi_indices,
    graded_lexico_indexof_multi_index,
)
from mfs_tpu.multi_dims.moments import monomials_nd
from mfs_tpu.typings import Array, FloatScalar


def poly_coefficients(f: Callable, d: int, deg: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact graded-lex Taylor coefficients of a polynomial callable.

    ``f: (d,) -> (k,)`` must be jax-traceable and *polynomial* of total
    degree <= ``deg`` (higher-order structure is silently dropped —
    checked by ``_check_poly``).  Returns ``(coefs (k, z), mis (z, d))``
    with ``z`` the number of multi-indices of degree <= ``deg``.
    Runs nested ``jacfwd`` at 0 on the host at trace time only.
    """
    mis = generate_graded_lexico_multi_indices(d, deg)
    x0 = jnp.zeros((d,))
    out0 = np.asarray(f(x0))
    k = out0.shape[0]
    coefs = np.zeros((k, mis.shape[0]))
    coefs[:, 0] = out0

    fn = f
    for order in range(1, deg + 1):
        fn = jax.jacfwd(fn)
        tensor = np.asarray(fn(x0))  # (k, d, d, ..., d) with `order` d-axes
        for r, alpha in enumerate(mis):
            if alpha.sum() != order:
                continue
            idx: Tuple[int, ...] = ()
            for i, a_i in enumerate(alpha):
                idx += (i,) * int(a_i)
            fact = np.prod([math.factorial(int(a)) for a in alpha])
            coefs[:, r] = tensor[(slice(None),) + idx] / fact
    return coefs, np.asarray(mis, dtype=np.int64)


def _check_poly(f: Callable, coefs: np.ndarray, mis: np.ndarray, rtol=1e-9) -> None:
    """Probe that ``f`` really is the polynomial its coefficients claim."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(5, mis.shape[-1]))
    exact = np.asarray(jax.vmap(f)(jnp.asarray(xs)))
    approx = np.asarray(monomials_nd(jnp.asarray(xs), mis)) @ coefs.T
    scale = np.maximum(np.abs(exact).max(), 1.0)
    if not np.allclose(exact, approx, atol=rtol * scale):
        raise ValueError(
            "callable is not a polynomial of the declared degree "
            f"(max deviation {np.abs(exact - approx).max():.2e})"
        )


def _rank(mis_ext: np.ndarray, alpha: np.ndarray) -> Optional[int]:
    if alpha.sum() > mis_ext.sum(axis=-1).max():
        return None
    return int(graded_lexico_indexof_multi_index(alpha))


def _diff_matrix(mis_ext: np.ndarray, i: int) -> np.ndarray:
    """D_i on coefficient vectors over ``mis_ext``."""
    z = mis_ext.shape[0]
    D = np.zeros((z, z))
    for c, alpha in enumerate(mis_ext):
        if alpha[i] == 0:
            continue
        beta = alpha.copy()
        beta[i] -= 1
        D[_rank(mis_ext, beta), c] = alpha[i]
    return D


def _mul_matrix(mis_ext: np.ndarray, gamma: np.ndarray) -> np.ndarray:
    """M_γ (multiply by mono_γ) on coefficient vectors; truncating."""
    z = mis_ext.shape[0]
    max_deg = int(mis_ext.sum(axis=-1).max())
    M = np.zeros((z, z))
    for c, alpha in enumerate(mis_ext):
        beta = alpha + gamma
        if beta.sum() > max_deg:
            continue
        M[_rank(mis_ext, beta), c] = 1.0
    return M


class _ShiftTable(NamedTuple):
    """Pascal shift/scale transform of a coefficient basis.

    mono_β(s v + m) = Σ_{γ<=β} binom(β,γ) s^γ m^{β-γ} mono_γ(v):
    row r holds one (β, γ) pair as (out_rank γ, in_rank β, binom
    product, s exponents γ, m exponents β−γ).
    """

    out_rank: np.ndarray  # (P,)
    in_rank: np.ndarray  # (P,)
    binom: np.ndarray  # (P,)
    s_pow: np.ndarray  # (P, d)
    m_pow: np.ndarray  # (P, d)


def _shift_table(mis_coef: np.ndarray) -> _ShiftTable:
    rows = []
    for b_r, beta in enumerate(mis_coef):
        for g_r, gamma in enumerate(mis_coef):
            if np.any(gamma > beta):
                continue
            binom = float(
                np.prod([math.comb(int(b), int(g)) for b, g in zip(beta, gamma)])
            )
            rows.append((g_r, b_r, binom, gamma.copy(), (beta - gamma).copy()))
    return _ShiftTable(
        np.array([r[0] for r in rows], dtype=np.int64),
        np.array([r[1] for r in rows], dtype=np.int64),
        np.array([r[2] for r in rows]),
        np.stack([r[3] for r in rows]).astype(np.int64),
        np.stack([r[4] for r in rows]).astype(np.int64),
    )


def _shift_coefs(table: _ShiftTable, base: Array, m: Array, s: Array) -> Array:
    """Per-trial v-frame coefficients: base (k, zc) -> (..., k, zc)."""
    sp = monomials_nd(s, table.s_pow)  # (..., P)
    mp = monomials_nd(m, table.m_pow)  # (..., P)
    w = table.binom * sp * mp  # (..., P)
    contrib = w[..., None, :] * base[:, table.in_rank]  # (..., k, P)
    zc = base.shape[-1]
    seg = jax.nn.one_hot(table.out_rank, zc, dtype=base.dtype)  # (P, zc)
    return jnp.einsum("...kp,pz->...kz", contrib, seg)


class PolyTME(NamedTuple):
    """Precomputed polynomial-TME machinery for one SDE + basis.

    ``ops`` stacks every constant generator building block
    (z_ext, z_ext); the runtime v-frame generator is
    ``Σ_t coefs[..., t] · ops[t]``.
    """

    dt: float
    order: int
    mis: np.ndarray  # filter basis (z, d)
    mis_ext: np.ndarray  # extended basis (z_ext, d)
    ops_t: Array  # (n_ops, z_ext, z_ext), TRANSPOSED operators
    a_coefs: np.ndarray  # (d, zc_a)
    bbt_coefs: np.ndarray  # (d, d, zc_b)
    a_table: _ShiftTable
    b_table: _ShiftTable
    a_slots: np.ndarray  # (d, zc_a) -> op index
    b_slots: np.ndarray  # (d, d, zc_b) -> op index
    small_z: int  # sub-basis size reachable by coordinate towers
    pair_rank: np.ndarray  # (small_z, small_z) -> ext rank of α+β

    def frame_coefs(self, m: Array, s: Array) -> Array:
        """Per-trial scalars c_t(m, s): (..., n_ops)."""
        dtype = jnp.result_type(m, s, jnp.float64)
        m = jnp.asarray(m, dtype)
        s = jnp.asarray(s, dtype)
        a_v = _shift_coefs(self.a_table, jnp.asarray(self.a_coefs, dtype), m, s)
        a_v = a_v / s[..., :, None]  # ã_i = a_i(sv+m)/s_i
        bb = jnp.asarray(
            self.bbt_coefs.reshape(-1, self.bbt_coefs.shape[-1]), dtype
        )
        b_v = _shift_coefs(self.b_table, bb, m, s)
        d = self.a_coefs.shape[0]
        b_v = b_v.reshape(b_v.shape[:-2] + (d, d, b_v.shape[-1]))
        b_v = b_v / (s[..., :, None, None] * s[..., None, :, None])
        n_ops = self.ops_t.shape[0]
        coefs = jnp.zeros(a_v.shape[:-2] + (n_ops,), dtype)
        a_flat = a_v.reshape(a_v.shape[:-2] + (-1,))
        coefs = coefs.at[..., self.a_slots.reshape(-1)].add(a_flat)
        b_flat = b_v.reshape(b_v.shape[:-3] + (-1,))
        coefs = coefs.at[..., self.b_slots.reshape(-1)].add(b_flat)
        return coefs

    def apply_gen_t(self, coefs: Array, q: Array) -> Array:
        """(L̃ᵀ q) for per-trial generators: q (..., z_ext)."""
        r = jnp.einsum("...z,oyz->...oy", q, self.ops_t)
        return jnp.einsum("...o,...oy->...y", coefs, r)

    def tower_t(self, coefs: Array, q0: Array) -> Array:
        """Σ_k dt^k/k! (L̃ᵀ)^k q0, truncated at ``order``."""
        out = q0
        q = q0
        fac = 1.0
        for k in range(1, self.order + 1):
            q = self.apply_gen_t(coefs, q)
            fac *= self.dt / k
            out = out + fac * q
        return out

    # ------------------------------------------------------------------
    # Fused predict: weights+nodes -> (new mean, new cms)
    # ------------------------------------------------------------------
    def predict_cms(self, weights: Array, nodes: Array, mean: Array) -> Tuple[Array, Array]:
        """One fused prediction for the central-moment filter.

        weights (..., n), nodes (..., n, d), mean (..., d) — the
        *current* posterior mean (the quadrature frame).  Returns
        (pred_mean (..., d), pred_cms (..., z)).

        Two towers ride the same frame coefficients: the raw-frame
        conditional mean (degree-1 entries, un-shifted afterwards) and
        the central monomials about the *predicted* mean.
        """
        d = nodes.shape[-1]
        ones = jnp.ones_like(mean)

        # Tower 1: frame shifted by the current mean, scale 1 — gives
        # E[mono((U' - m_old))] weighted; degree-0/1 entries recover the
        # predicted mean exactly: E[U'_i] = m_old_i + tower[e_i].
        coefs_old = self.frame_coefs(mean, ones)
        v = nodes - mean[..., None, :]
        y0 = monomials_nd(v, self.mis_ext)  # (..., n, z_ext)
        q0 = jnp.einsum("...n,...nz->...z", weights, y0)
        t_old = self.tower_t(coefs_old, q0)
        unit_ranks = [
            _rank(self.mis_ext, np.eye(d, dtype=np.int64)[i]) for i in range(d)
        ]
        pred_mean = mean + t_old[..., jnp.array(unit_ranks)]

        # Tower 2: frame shifted by the *predicted* mean — central
        # monomials evaluated without moment-space shifts.
        coefs_new = self.frame_coefs(pred_mean, ones)
        v2 = nodes - pred_mean[..., None, :]
        y2 = monomials_nd(v2, self.mis_ext)
        q2 = jnp.einsum("...n,...nz->...z", weights, y2)
        t_new = self.tower_t(coefs_new, q2)
        z = self.mis.shape[0]
        return pred_mean, t_new[..., :z]

    def predict_scms(
        self, weights: Array, nodes: Array, mean: Array, scale: Array
    ) -> Tuple[Array, Array, Array]:
        """One fused prediction for the scaled-central filter.

        Returns (pred_mean, pred_scale, pred_scms).  Matches the
        filter's law-of-total-variance predicted scale
        (``multi_dims/filtering.py`` scms predict) with the
        consistently truncated conditional covariance: everything is
        computed in the old frame v=(u−m)/s, where the conditional
        mean/variance per node are coefficient-side towers
        c_k = C̃^k e_i over the *small-degree* sub-basis, and their
        weighted products are bilinear forms in q0.
        """
        d = nodes.shape[-1]
        dtype = nodes.dtype
        coefs_old = self.frame_coefs(mean, scale)
        v = (nodes - mean[..., None, :]) / scale[..., None, :]
        y0 = monomials_nd(v, self.mis_ext)
        q0 = jnp.einsum("...n,...nz->...z", weights, y0)

        # Materialised generator on the small sub-basis (the degrees
        # the coordinate towers can reach: 1 + order·rise).
        zs = int(self.small_z)
        C_small_t = jnp.einsum(
            "...o,oyz->...yz", coefs_old, self.ops_t[:, :zs, :zs]
        )  # (..., zs, zs): block of C̃ᵀ

        unit = np.eye(d, dtype=np.int64)
        id_ranks = jnp.array([_rank(self.mis_ext, unit[i]) for i in range(d)])
        sq_ranks = jnp.array([_rank(self.mis_ext, 2 * unit[i]) for i in range(d)])

        # Coefficient towers c_k = C̃^k e_i per coordinate: (..., d, zs).
        c0 = jnp.broadcast_to(
            jnp.eye(zs, dtype=dtype)[id_ranks], mean.shape[:-1] + (d, zs)
        )
        c_ks = [c0]
        for _ in range(self.order):
            # (C̃ c)[y] = Σ_z C̃[y,z] c[z] = Σ_z C̃ᵀ[z,y] c[z]
            c_ks.append(jnp.einsum("...zy,...dz->...dy", C_small_t, c_ks[-1]))

        # Bilinear form Q[α, β] = q0[rank(α + β)] over the small basis:
        # E_w[p_a(v) p_b(v)] = c_aᵀ Q c_b.
        Qmat = q0[..., self.pair_rank]  # (..., zs, zs)

        def Ew(ca, cb):
            return jnp.einsum("...da,...ab,...db->...d", ca, Qmat, cb)

        # Value towers of the squares: (L̃^k v_i²) weighted by w.
        s_ks = [q0[..., sq_ranks]]
        q_iter = q0
        for _ in range(self.order):
            q_iter = self.apply_gen_t(coefs_old, q_iter)
            s_ks.append(q_iter[..., sq_ranks])

        coeffs = [1.0]
        for r in range(1, self.order + 1):
            coeffs.append(coeffs[-1] * self.dt / r)

        # Weighted v-frame conditional mean  E_w[m_cond,v].
        m_v = q0[..., id_ranks]
        for r in range(1, self.order + 1):
            m_v = m_v + coeffs[r] * jnp.einsum(
                "...dz,...z->...d", c_ks[r], q0[..., :zs]
            )

        # E_w[cov_cons,ii + m_cond²]  (law of total variance pieces):
        # m_cond² expands over tower-order pairs; cov_cons is the
        # consistently truncated covariance (``_consistent_mean_cov``).
        second = jnp.zeros_like(m_v)
        for r in range(self.order + 1):
            for r2 in range(self.order + 1):
                second = second + coeffs[r] * coeffs[r2] * Ew(c_ks[r], c_ks[r2])
        for r in range(1, self.order + 1):
            inner = s_ks[r]
            for k in range(r + 1):
                inner = inner - math.comb(r, k) * Ew(c_ks[k], c_ks[r - k])
            second = second + coeffs[r] * inner

        pred_mean = mean + scale * m_v
        pred_scale = scale * jnp.sqrt(second - m_v**2)

        # scms tower in the NEW frame.
        coefs_new = self.frame_coefs(pred_mean, pred_scale)
        v2 = (nodes - pred_mean[..., None, :]) / pred_scale[..., None, :]
        q2 = jnp.einsum(
            "...n,...nz->...z", weights, monomials_nd(v2, self.mis_ext)
        )
        t_new = self.tower_t(coefs_new, q2)
        z = self.mis.shape[0]
        return pred_mean, pred_scale, t_new[..., :z]

    # ------------------------------------------------------------------
    # Per-node callables (TransitionMomentsND-compatible)
    # ------------------------------------------------------------------
    def _per_node(self, nodes: Array, shift: Array, scale: Array) -> Array:
        coefs = self.frame_coefs(shift, scale)
        v = (nodes - shift[..., None, :]) / scale[..., None, :]
        y = monomials_nd(v, self.mis_ext)  # (..., n, z_ext)
        out = self.tower_t(coefs[..., None, :], y)
        return out[..., : self.mis.shape[0]]

    def rms(self, nodes: Array) -> Array:
        zero = jnp.zeros(nodes.shape[:-2] + (nodes.shape[-1],), nodes.dtype)
        return self._per_node(nodes, zero, jnp.ones_like(zero))

    def cms(self, nodes: Array, mean: Array) -> Array:
        mean = jnp.broadcast_to(
            jnp.asarray(mean, nodes.dtype), nodes.shape[:-2] + (nodes.shape[-1],)
        )
        return self._per_node(nodes, mean, jnp.ones_like(mean))

    def scms(self, nodes: Array, mean: Array, scale: Array) -> Array:
        shape = nodes.shape[:-2] + (nodes.shape[-1],)
        mean = jnp.broadcast_to(jnp.asarray(mean, nodes.dtype), shape)
        scale = jnp.broadcast_to(jnp.asarray(scale, nodes.dtype), shape)
        return self._per_node(nodes, mean, scale)

    def mean(self, nodes: Array) -> Array:
        """Conditional mean per node (..., n, d)."""
        d = nodes.shape[-1]
        shape = nodes.shape[:-2] + (d,)
        zero = jnp.zeros(shape, nodes.dtype)
        coefs = self.frame_coefs(zero, jnp.ones_like(zero))
        y = monomials_nd(nodes, self.mis_ext)
        out = self.tower_t(coefs[..., None, :], y)
        unit_ranks = [
            _rank(self.mis_ext, np.eye(d, dtype=np.int64)[i]) for i in range(d)
        ]
        return out[..., jnp.array(unit_ranks)]

    def mean_var(self, nodes: Array) -> Tuple[Array, Array]:
        """Conditional mean + variance diagonal per node.

        Matches ``sde/tme.py:_consistent_mean_cov`` (the consistently
        truncated covariance — NOT E[U²]−E[U]², whose truncation
        injects spurious O(dt²) cross terms)."""
        d = nodes.shape[-1]
        shape = nodes.shape[:-2] + (d,)
        zero = jnp.zeros(shape, nodes.dtype)
        coefs = self.frame_coefs(zero, jnp.ones_like(zero))[..., None, :]
        unit = np.eye(d, dtype=np.int64)
        m_ranks = jnp.array([_rank(self.mis_ext, unit[i]) for i in range(d)])
        sq_ranks = jnp.array([_rank(self.mis_ext, 2 * unit[i]) for i in range(d)])

        terms = [monomials_nd(nodes, self.mis_ext)]  # (L^k mono)(node)
        for _ in range(self.order):
            terms.append(self.apply_gen_t(coefs, terms[-1]))
        ids = [t[..., m_ranks] for t in terms]
        sqs = [t[..., sq_ranks] for t in terms]

        mean = ids[0]
        var = jnp.zeros_like(mean)
        coeff = 1.0
        for r in range(1, self.order + 1):
            coeff = coeff * self.dt / r
            mean = mean + coeff * ids[r]
            inner = sqs[r]
            for k in range(r + 1):
                inner = inner - math.comb(r, k) * ids[k] * ids[r - k]
            var = var + coeff * inner
        return mean, var


def poly_tme_nd(
    drift: Callable,
    dispersion: Callable,
    dt: FloatScalar,
    tme_order: int,
    multi_indices: np.ndarray,
    drift_deg: int,
    dispersion_deg: int,
) -> PolyTME:
    """Build the polynomial-TME machinery (host-side, trace time).

    ``drift: (d,) -> (d,)`` and ``dispersion: (d,) -> (d, d)`` must be
    polynomials of the declared total degrees (validated numerically).
    """
    mi = np.asarray(multi_indices, dtype=np.int64)
    d = mi.shape[-1]
    deg_phi = int(mi.sum(axis=-1).max())
    bbt_deg = 2 * dispersion_deg
    rise = max(drift_deg - 1, bbt_deg - 2, 0)
    # Extended degree: enough for the φ towers AND for products of two
    # coordinate towers (predict_scms' law-of-total-variance bilinear
    # forms reach degree 2·(1 + order·rise)).
    small_deg = 1 + tme_order * rise
    deg_ext = max(deg_phi + tme_order * rise, 2 * small_deg)
    mis_ext = generate_graded_lexico_multi_indices(d, deg_ext)
    mis_small = generate_graded_lexico_multi_indices(d, small_deg)
    small_z = mis_small.shape[0]
    pair_rank = np.zeros((small_z, small_z), dtype=np.int64)
    for i_a, alpha in enumerate(mis_small):
        for i_b, beta in enumerate(mis_small):
            pair_rank[i_a, i_b] = _rank(mis_ext, alpha + beta)

    a_coefs, mis_a = poly_coefficients(drift, d, drift_deg)
    _check_poly(drift, a_coefs, mis_a)

    def bbt_flat(x):
        b = dispersion(x)
        return (b @ b.T).reshape(-1)

    bbt_c, mis_b = poly_coefficients(bbt_flat, d, bbt_deg)
    _check_poly(bbt_flat, bbt_c, mis_b)
    bbt_coefs = bbt_c.reshape(d, d, -1)

    # Constant operator blocks, deduplicated by slot: one op per
    # (γ, i) drift term and per (γ, i, j) diffusion term.
    ops = []
    Ds = [_diff_matrix(mis_ext, i) for i in range(d)]
    a_slots = np.zeros((d, mis_a.shape[0]), dtype=np.int64)
    for i in range(d):
        for g, gamma in enumerate(mis_a):
            ops.append(_mul_matrix(mis_ext, gamma) @ Ds[i])
            a_slots[i, g] = len(ops) - 1
    b_slots = np.zeros((d, d, mis_b.shape[0]), dtype=np.int64)
    for i in range(d):
        for j in range(d):
            for g, gamma in enumerate(mis_b):
                ops.append(0.5 * _mul_matrix(mis_ext, gamma) @ Ds[i] @ Ds[j])
                b_slots[i, j, g] = len(ops) - 1

    ops_t = jnp.asarray(
        np.stack([o.T for o in ops]), dtype=jnp.float64
    )  # (n_ops, z_ext, z_ext)

    return PolyTME(
        dt=float(dt),
        order=int(tme_order),
        mis=mi,
        mis_ext=np.asarray(mis_ext, dtype=np.int64),
        ops_t=ops_t,
        a_coefs=a_coefs,
        bbt_coefs=bbt_coefs,
        a_table=_shift_table(mis_a),
        b_table=_shift_table(mis_b),
        a_slots=a_slots,
        b_slots=b_slots,
        small_z=small_z,
        pair_rank=pair_rank,
    )
