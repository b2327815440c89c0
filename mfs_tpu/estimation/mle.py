"""Gradient-based maximum-likelihood estimation through the filters.

The moment filters return a differentiable negative log likelihood;
these drivers optimise model parameters with either

- ``fit_mle_scipy``: SciPy L-BFGS-B fed by jitted JAX value-and-grad
  (the reference uses ``jaxopt.ScipyMinimize(L-BFGS-B)``:
  ``dardel/parameter_estimation/mf.py:58-77``), or
- ``fit_mle_optax``: a pure on-device optimiser loop (any optax
  transform; default L-BFGS) — no host round-trips per step, suitable
  for running *many* MLE problems batched on a mesh.
"""
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.typings import Array


def fit_mle_scipy(
    nell_fn: Callable[[Array], Array],
    init_params: Array,
    method: str = "L-BFGS-B",
    tol: Optional[float] = None,
    options: Optional[dict] = None,
):
    """Minimise a differentiable nell with SciPy + JAX gradients.

    Parameters
    ----------
    nell_fn : (p,) -> scalar
        Differentiable negative log likelihood (typically closing over
        the measurements and calling a moment filter).
    init_params : Array (p,)

    Returns
    -------
    scipy.optimize.OptimizeResult
        ``result.x`` are the fitted parameters.
    """
    import scipy.optimize

    vg = jax.jit(jax.value_and_grad(nell_fn))

    def fun(x):
        v, g = vg(jnp.asarray(x))
        return float(v), np.asarray(g, dtype=np.float64)

    return scipy.optimize.minimize(
        fun,
        np.asarray(init_params, dtype=np.float64),
        jac=True,
        method=method,
        tol=tol,
        options=options,
    )


def fit_mle_optax(
    nell_fn: Callable[[Array], Array],
    init_params: Array,
    optimiser: Any = None,
    num_steps: int = 100,
    chunk_steps: int = 0,
) -> Tuple[Array, Array]:
    """On-device MLE: a jitted ``lax.scan`` over optimiser updates.

    Because the whole loop is one compiled program, it vmaps/shards
    over many independent MLE problems (e.g. one per Monte-Carlo trial)
    — the batched replacement for the reference's per-trial SciPy
    processes.

    ``chunk_steps > 0`` runs the loop as jitted segments of that many
    optimiser steps carried across a host loop (one compile — every
    segment shares its shape; the optimiser state is the carry).  Use
    it to bound the length of one device dispatch, e.g. to report
    progress from the host between segments.  The chunked trajectory is
    numerically identical to the single-dispatch run (verified to
    1e-12; XLA recompiles the scan at the segment length, so exact
    bitwise identity is not guaranteed).

    Returns
    -------
    params : Array (p,), losses : Array (num_steps,)
    """
    import optax

    if optimiser is None:
        optimiser = optax.lbfgs()

    value_and_grad = optax.value_and_grad_from_state(nell_fn)

    def step(carry, _):
        params, state = carry
        loss, grads = value_and_grad(params, state=state)
        updates, state = optimiser.update(
            grads, state, params, value=loss, grad=grads, value_fn=nell_fn
        )
        params = optax.apply_updates(params, updates)
        return (params, state), loss

    init_params = jnp.asarray(init_params)
    state0 = optimiser.init(init_params)
    if not chunk_steps or chunk_steps >= num_steps:
        (params, _), losses = jax.lax.scan(
            step, (init_params, state0), None, length=num_steps
        )
        return params, losses

    if num_steps % chunk_steps:
        raise ValueError(
            f"chunk_steps {chunk_steps} must divide num_steps {num_steps}"
        )
    segment = jax.jit(
        lambda c: jax.lax.scan(step, c, None, length=chunk_steps)
    )
    carry, parts = (init_params, state0), []
    for _ in range(num_steps // chunk_steps):
        carry, losses = segment(carry)
        jax.block_until_ready(losses)
        parts.append(losses)
    return carry[0], jnp.concatenate(parts, axis=0)


def fit_mle_batched(
    per_trial_nell: Callable[[Array, Any], Array],
    init_params: Array,
    data: Any,
    optimiser: Any = None,
    max_steps: int = 200,
    chunk_steps: int = 10,
    gtol: float = 1e-5,
    ptol: float = 0.0,
) -> Tuple[Array, dict]:
    """Per-trial L-BFGS over a batch of independent MLE problems.

    The batched replacement for the reference's one-SciPy-process-
    per-trial protocol (``dardel/parameter_estimation/mf.py:58-77``):
    ``jax.vmap`` of a full optax L-BFGS step (curvature history, zoom
    line search and all) drives every trial's *own* quasi-Newton
    iteration in lockstep on the device.  This differs from running
    one global L-BFGS on the summed nell: there the curvature inner
    products couple unrelated trials and degrade the search direction;
    here each trial gets exactly the per-trial iteration the reference
    uses, just batched.

    Convergence control: a trial is frozen once its gradient inf-norm
    drops below ``gtol`` (or its parameter step below ``ptol``), and
    the host loop stops as soon as every trial is done — wall time
    follows the *slowest* trial instead of a fixed iteration budget.

    Parameters
    ----------
    per_trial_nell : (params (p,), datum) -> scalar nell
        Objective for one trial; ``datum`` is the per-trial slice of
        ``data``.
    init_params : Array (B, p)
    data : pytree with leading trial axis B (e.g. the measurements).
    max_steps, chunk_steps : int
        Iteration cap and jitted-segment length (bounded dispatches
        for remote devices; see ``fit_mle_optax``).
    gtol, ptol : float
        Per-trial stopping tolerances.

    Returns
    -------
    params : Array (B, p)
    info : dict with ``converged (B,)``, ``steps (B,)``, ``nell (B,)``,
        ``segments_run`` (int).
    """
    import optax

    if optimiser is None:
        optimiser = optax.lbfgs()

    init_params = jnp.asarray(init_params)
    B = init_params.shape[0]

    def step_one(p, state, datum):
        obj = lambda q: per_trial_nell(q, datum)
        loss, g = optax.value_and_grad_from_state(obj)(p, state=state)
        updates, state = optimiser.update(
            g, state, p, value=loss, grad=g, value_fn=obj
        )
        return optax.apply_updates(p, updates), state, loss, g

    def masked_step(carry, _):
        P, S, done, steps = carry
        newP, newS, loss, G = jax.vmap(step_one)(P, S, data)
        # Freeze finished trials: their params and optimiser state stay
        # exactly where they converged (select, not cond — all lanes
        # compute, only unconverged lanes commit).
        def keep(old, new):
            mask = done.reshape((B,) + (1,) * (new.ndim - 1))
            return jnp.where(mask, old, new)

        P2 = keep(P, newP)
        S2 = jax.tree_util.tree_map(keep, S, newS)
        gnorm = jnp.max(jnp.abs(G), axis=-1)
        delta = jnp.max(jnp.abs(newP - P), axis=-1)
        finished = (gnorm < gtol) | (delta <= ptol) | ~jnp.isfinite(loss)
        done2 = done | finished
        steps2 = steps + (~done).astype(steps.dtype)
        return (P2, S2, done2, steps2), None

    segment = jax.jit(
        lambda c: jax.lax.scan(masked_step, c, None, length=chunk_steps)[0]
    )

    S0 = jax.vmap(optimiser.init)(init_params)
    carry = (
        init_params,
        S0,
        jnp.zeros(B, bool),
        jnp.zeros(B, jnp.int32),
    )
    segments_run = 0
    for _ in range(-(-max_steps // chunk_steps)):
        carry = segment(carry)
        segments_run += 1
        done = np.asarray(carry[2])
        if done.all():
            break
    P, _, done, steps = carry
    nell = jax.vmap(per_trial_nell)(P, data)
    return P, dict(
        converged=done, steps=steps, nell=nell, segments_run=segments_run
    )
