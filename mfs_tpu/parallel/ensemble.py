"""Sharded Monte-Carlo ensemble execution.

``run_ensemble_filter`` runs a batch-first filter with the trial axis
sharded over a mesh; ``sharded_nell_grad`` is the distributed
parameter-estimation step (mean per-trial nell + gradient, with the
cross-device reduction inserted by XLA from the sharding annotations);
``rescue_diverged`` is the tiered robustness pattern (fast pass, then
re-run only the diverged trials through a robust path).
"""
from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mfs_tpu.parallel.mesh import TRIAL_AXIS, shard_trials, replicate


def run_ensemble_filter(
    filter_fn: Callable,
    init_moments: Any,
    ys: Any,
    mesh: Mesh,
    donate: bool = False,
) -> Any:
    """Run ``filter_fn(init_moments, ys)`` with trials sharded on ``mesh``.

    Parameters
    ----------
    filter_fn : (init (B, ...), ys (T, B, ...)) -> outputs
        A batch-first filter closure (e.g. wrapping
        ``moment_filter_rms`` with the model callables bound).
    init_moments : pytree with leading trial axis B.
    ys : pytree with trial axis at position 1 (time leads).
    mesh : Mesh from ``trial_mesh()``.

    Returns
    -------
    The filter outputs, trial axis sharded.
    """
    init_moments = shard_trials(init_moments, mesh, axis=0)
    ys = shard_trials(ys, mesh, axis=1)
    fn = jax.jit(filter_fn, donate_argnums=(0,) if donate else ())
    return fn(init_moments, ys)


def sharded_nell_grad(
    nell_fn: Callable,
    params: Any,
    ys: Any,
    mesh: Mesh,
) -> Tuple[jax.Array, Any]:
    """Mean nell over sharded trials and its gradient w.r.t. params.

    ``nell_fn(params, ys) -> (B,)`` per-trial negative log likelihoods.
    Params are replicated; trials sharded; the mean over the trial axis
    becomes one all-reduce across the mesh.
    """
    params = replicate(params, mesh)
    ys = shard_trials(ys, mesh, axis=1)

    @jax.jit
    def value_and_grad(p, y):
        return jax.value_and_grad(lambda q: jnp.mean(nell_fn(q, y)))(p)

    return value_and_grad(params, ys)


def rescue_diverged(
    run_fast: Callable[[jax.Array], Dict[str, Any]],
    run_robust: Callable[[jax.Array], Dict[str, Any]],
    ys: jax.Array,
    finite_fn: Callable[[Dict[str, Any]], Any],
    trial_axes: Dict[str, int],
) -> Tuple[Dict[str, Any], np.ndarray, int]:
    """Tiered divergence rescue for batched Monte-Carlo filtering.

    Run the whole trial ensemble through ``run_fast`` (e.g. the default
    ``eigh_impl="refined"`` filter), then re-run *only the trials that
    diverged* through ``run_robust`` (e.g. the ``stable=True``
    LDL-completion path, or LAPACK f64 on the host) and splice the
    rescued trajectories back in.  The failure sets of two arithmetics
    overlap but are not nested, so the surviving-divergence count is
    their intersection, at a small amortised cost, since the robust
    pass sees only the diverged subset.  This is the batched analogue
    of the reference's NaN-trial
    resampling protocol (``dardel/time_profile/mf.py:100-104``), except
    no trial is thrown away.

    Parameters
    ----------
    run_fast, run_robust : (T, B, ...) observations -> dict of arrays
        Filter drivers returning equally-keyed dicts of outputs.
    ys : Array (T, B, ...)
        Observations, trial axis 1.  The robust pass is padded back to
        width B (repeating trial 0) so it compiles once per shape.
    finite_fn : dict -> (B,) bool array
        Extracts the per-trial finiteness mask from a driver's output.
    trial_axes : {key: axis}
        Trial axis of each output array to splice (keys absent from a
        driver's output are ignored).

    Returns
    -------
    merged : dict, finite : (B,) bool ndarray, rescued : int

    ``run_robust`` may also be a *sequence* of drivers, applied in
    order to the (shrinking) set of still-diverged trials — e.g. the
    on-device ``stable=True`` path first and the host LAPACK-f64 +
    LDL-completion pass as the final fallback.
    """
    tiers = (
        list(run_robust) if isinstance(run_robust, (list, tuple))
        else [run_robust]
    )
    out = run_fast(ys)
    finite = np.asarray(finite_fn(out))
    n = finite.shape[0]
    merged = dict(out)
    total_rescued = 0

    for tier in tiers:
        if finite.all():
            break
        idx = np.where(~finite)[0]
        k = idx.shape[0]
        pad = np.concatenate([idx, np.zeros(n - k, dtype=idx.dtype)])
        robust = tier(jnp.take(ys, jnp.asarray(pad), axis=1))
        finite_r = np.asarray(finite_fn(robust))[:k]
        good = idx[finite_r]
        sel = np.where(finite_r)[0]

        for key, ax in trial_axes.items():
            if key not in merged or key not in robust:
                continue
            a = np.asarray(merged[key]).copy()
            b = np.asarray(robust[key])
            dst = [slice(None)] * a.ndim
            src = [slice(None)] * b.ndim
            dst[ax], src[ax] = good, sel
            a[tuple(dst)] = b[tuple(src)]
            merged[key] = a
        finite = finite.copy()
        finite[good] = True
        total_rescued += int(good.shape[0])
    return merged, finite, total_rescued
