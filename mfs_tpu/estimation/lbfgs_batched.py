"""Batch-of-problems L-BFGS with per-trial state (batched MLE solver).

Solves B independent small minimisations simultaneously where the
objective is *batch-first*: ``f(P) -> (B,)`` with ``P (B, p)``.  The
moment filters are batch-first by construction, so the objective is
called ONCE for all trials rather than vmapped per trial.

Everything is vectorised over the trial axis:

- the two-loop recursion keeps per-trial curvature pairs
  ``S, Y (m, B, p)`` and does its inner products over the parameter
  axis only — each trial gets its OWN quasi-Newton direction (a single
  optax/jaxopt L-BFGS on ``sum(f)`` sums the inner products over all
  trials and couples unrelated problems);
- the line search is per-trial backtracking Armijo: each halving costs
  one batched objective evaluation, trials accept independently;
- converged trials are frozen (params, state) with ``where`` masks and
  the host loop stops when every trial is done, so wall time follows
  the slowest trial, not a fixed budget (VERDICT r03 item 5).

Reference counterpart: one SciPy L-BFGS-B process per trial
(``dardel/parameter_estimation/mf.py:58-77``).
"""
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.typings import Array


def _two_loop(g, S, Y, rho, valid, gamma):
    """Vectorised L-BFGS two-loop recursion.

    g (B, p); S, Y (m, B, p); rho, valid (m, B); gamma (B,).
    Inner products run over the parameter axis only — per-trial
    directions.  Invalid history slots (not yet filled, or curvature
    breakdown) are skipped via their zeroed rho.
    """
    m = S.shape[0]
    q = g
    alphas = []
    for i in range(m - 1, -1, -1):
        a = rho[i] * jnp.einsum("bp,bp->b", S[i], q)
        a = jnp.where(valid[i], a, 0.0)
        q = q - a[:, None] * Y[i]
        alphas.append(a)
    alphas.reverse()
    r = gamma[:, None] * q
    for i in range(m):
        b = rho[i] * jnp.einsum("bp,bp->b", Y[i], r)
        b = jnp.where(valid[i], b, 0.0)
        r = r + (alphas[i] - b)[:, None] * S[i]
    return r  # (B, p): approximate H^{-1} g per trial


def lbfgs_batched(
    batched_nell: Callable[[Array], Array],
    init_params: Array,
    history: int = 10,
    max_steps: int = 200,
    chunk_steps: int = 10,
    gtol: float = 1e-5,
    max_backtracks: int = 20,
    c1: float = 1e-4,
) -> Tuple[Array, dict]:
    """Minimise B independent objectives with per-trial L-BFGS.

    Parameters
    ----------
    batched_nell : (B, p) -> (B,)
        Batch-first objective (per-trial negative log likelihoods).
        Must be differentiable; evaluated for ALL trials jointly.
    init_params : Array (B, p)
    history : int
        Number of curvature pairs per trial.
    max_steps, chunk_steps : int
        Iteration cap; jitted-segment length for bounded dispatches.
    gtol : float
        Per-trial gradient inf-norm stopping tolerance.
    max_backtracks : int
        Armijo halvings per line search (each costs one batched eval).
    c1 : float
        Armijo sufficient-decrease constant.

    Returns
    -------
    params : (B, p)
    info : dict — ``converged (B,)``, ``steps (B,)``, ``nell (B,)``,
        ``grad_inf_norm (B,)``, ``segments_run`` int.
    """
    P0 = jnp.asarray(init_params)
    B, p = P0.shape
    dtype = P0.dtype
    m = history

    def value_and_grad(P):
        # block-separable: the VJP against ones IS the stack of
        # per-trial gradients (one forward + one backward pass)
        vals, vjp_fn = jax.vjp(batched_nell, P)
        (grads,) = vjp_fn(jnp.ones_like(vals))
        return vals, grads

    def step(carry, _):
        P, fv, g, S, Y, rho, valid, k, done, steps = carry

        gamma_num = jnp.einsum("bp,bp->b", S[-1], Y[-1])
        gamma_den = jnp.einsum("bp,bp->b", Y[-1], Y[-1])
        gamma = jnp.where(
            valid[-1] & (gamma_den > 0), gamma_num / (gamma_den + 1e-300), 1.0
        )
        d = -_two_loop(g, S, Y, rho, valid, gamma)
        # descent safeguard: fall back to steepest descent per trial
        dg = jnp.einsum("bp,bp->b", d, g)
        bad = (dg >= 0) | ~jnp.isfinite(dg)
        d = jnp.where(bad[:, None], -g, d)
        dg = jnp.where(bad, -jnp.einsum("bp,bp->b", g, g), dg)

        # per-trial backtracking Armijo: alpha halves until
        # f(P + alpha d) <= f(P) + c1 alpha <d, g>
        def ls_body(state):
            alpha, accepted, fnew, it = state
            cand = P + alpha[:, None] * d
            fc = batched_nell(cand)
            ok = fc <= fv + c1 * alpha * dg
            ok = ok & jnp.isfinite(fc)
            fnew = jnp.where(ok & ~accepted, fc, fnew)
            anew = jnp.where(ok | accepted, alpha, alpha * 0.5)
            return anew, accepted | ok, fnew, it + 1

        def ls_cond(state):
            _, accepted, _, it = state
            return (~accepted).any() & (it < max_backtracks)

        alpha0 = jnp.ones(B, dtype)
        alpha, accepted, fnew, _ = jax.lax.while_loop(
            ls_cond, ls_body, (alpha0, jnp.zeros(B, bool), fv, jnp.int32(0))
        )
        # trials whose line search failed take no step this iteration
        alpha = jnp.where(accepted, alpha, 0.0)
        newP = P + alpha[:, None] * d
        fnew = jnp.where(accepted, fnew, fv)
        _, gnew = value_and_grad(newP)

        s = newP - P
        y = gnew - g
        sy = jnp.einsum("bp,bp->b", s, y)
        ok_pair = (sy > 1e-12) & jnp.isfinite(sy) & accepted
        S2 = jnp.concatenate([S[1:], s[None]], axis=0)
        Y2 = jnp.concatenate([Y[1:], y[None]], axis=0)
        rho2 = jnp.concatenate(
            [rho[1:], jnp.where(ok_pair, 1.0 / (sy + 1e-300), 0.0)[None]],
            axis=0,
        )
        valid2 = jnp.concatenate([valid[1:], ok_pair[None]], axis=0)

        gnorm = jnp.max(jnp.abs(gnew), axis=-1)
        finished = (gnorm < gtol) | ~accepted | ~jnp.isfinite(fnew)

        def keep(old, new):
            mask = done.reshape((-1,) + (1,) * (new.ndim - 1)) if new.ndim else done
            return jnp.where(mask, old, new)

        def keep_hist(old, new):
            return jnp.where(done[None, :, None] if new.ndim == 3
                             else done[None, :], old, new)

        carry = (
            keep(P, newP), keep(fv, fnew), keep(g, gnew),
            keep_hist(S, S2), keep_hist(Y, Y2),
            keep_hist(rho, rho2), keep_hist(valid, valid2),
            k + 1, done | finished, steps + (~done).astype(steps.dtype),
        )
        return carry, None

    segment = jax.jit(
        lambda c: jax.lax.scan(step, c, None, length=chunk_steps)[0]
    )

    fv0, g0 = jax.jit(value_and_grad)(P0)
    done0 = (jnp.max(jnp.abs(g0), axis=-1) < gtol) | ~jnp.isfinite(fv0)
    carry = (
        P0, fv0, g0,
        jnp.zeros((m, B, p), dtype), jnp.zeros((m, B, p), dtype),
        jnp.zeros((m, B), dtype), jnp.zeros((m, B), bool),
        jnp.int32(0), done0, jnp.zeros(B, jnp.int32),
    )
    # AOT-compile the segment so the reported wall time is pure
    # optimisation (the experiment protocol excludes compilation).
    import time

    segment.lower(carry).compile()
    t0 = time.perf_counter()
    segments_run = 0
    for _ in range(-(-max_steps // chunk_steps)):
        if np.asarray(carry[8]).all():
            break
        carry = segment(carry)
        segments_run += 1
    jax.block_until_ready(carry[0])
    wall_s = time.perf_counter() - t0
    P, fv, g = carry[0], carry[1], carry[2]
    return P, dict(
        converged=carry[8],
        steps=carry[9],
        nell=fv,
        grad_inf_norm=jnp.max(jnp.abs(g), axis=-1),
        segments_run=segments_run,
        wall_s=wall_s,
    )
