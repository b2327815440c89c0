"""Well–Poisson MLE baselines: GHF, EKF, and particle filter.

Counterpart of reference ``dardel/parameter_estimation/ghf_ekf.py`` and
``dardel/parameter_estimation/pf.py`` (the Figure-6 protocol fits the
two Well–Poisson parameters with *three* estimator families; without
the Gaussian-filter and particle-filter baselines the moment filter's
MLE spread cannot be attributed).

Batched execution: the reference runs one SciPy L-BFGS-B process per
(trial, method); here every method drives all trials' *own* L-BFGS
iterations batched on device (``mfs_tpu.estimation.fit_mle_batched``:
vmapped optax L-BFGS with per-trial convergence freeze + global early
stop).  Trials and data are IDENTICAL to the moment-filter leg
(``experiments/parameter_estimation.py``, same seed protocol), so the
per-method (p1, p2) spreads are directly comparable.

Usage:
    python experiments/parameter_estimation_baselines.py \
        --methods ghf ekf pf --trials 1000 --T 1000
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from experiments import common


def simulate_trials(args):
    """Identical data protocol to experiments/parameter_estimation.py."""
    from mfs_tpu.models import well_poisson

    dt, T_full, ts, ic, drift, disp, emission, meas_pmf, simulate = well_poisson(
        args.true_p1, N=args.N
    )
    key_sim, key_meas = jax.random.split(jax.random.PRNGKey(args.seed))
    xss = simulate(key_sim, args.trials, 20)[:, : args.T]  # (B, T)
    yss = jax.random.poisson(key_meas, emission(xss, args.true_p2)).astype(
        xss.dtype
    )
    return dt, ic, drift, disp, emission, meas_pmf, yss


def fit(method, args, dt, ic, drift, disp, emission, meas_pmf, yss,
        trial_ids=None):
    """One batched MLE leg; returns (p_hat (B, 2), info, wall_s)."""
    from mfs_tpu.estimation import lbfgs_batched

    if trial_ids is None:
        trial_ids = jnp.arange(yss.shape[0])
    B = yss.shape[0]
    softplus = lambda v: jnp.logaddexp(0.0, v)

    if method in ("ghf", "ekf"):
        from mfs_tpu.filters.gaussian import ekf, sgp_filter
        from mfs_tpu.filters.sigma_points import SigmaPoints

        sgps = SigmaPoints.gauss_hermite(d=1, order=args.gh) if method == "ghf" else None
        m0 = jnp.atleast_1d(jnp.asarray(ic.mean))
        v0 = jnp.atleast_2d(jnp.asarray(ic.variance))

        def per_trial_nell(q, ys_i):
            p1, p2 = softplus(q[0]), softplus(q[1])

            # Euler transition (reference --euler branch,
            # ghf_ekf.py:52-54): mean/cov of X_{k+1} | X_k = x.
            def state_cond_m_cov(x, _dt):
                return x + x * (1.0 - p1 * x**2) * _dt, jnp.atleast_2d(_dt)

            def measurement_cond_m_cov(x):
                lam = jnp.logaddexp(0.0, p2 * x[0])
                return jnp.atleast_1d(lam), jnp.atleast_2d(lam)

            if method == "ghf":
                _, _, nells = sgp_filter(
                    state_cond_m_cov, measurement_cond_m_cov, sgps,
                    m0, v0, dt, ys_i[:, None],
                )
            else:
                _, _, nells = ekf(
                    state_cond_m_cov, measurement_cond_m_cov,
                    m0, v0, dt, ys_i[:, None],
                )
            return nells[-1]

        data = yss  # (B, T)

    elif method == "pf":
        from mfs_tpu.filters.smc import bootstrap_filter

        n = args.nparticles
        key_pf = jax.random.PRNGKey(args.seed + 99)
        keys_pf = jax.vmap(lambda i: jax.random.fold_in(key_pf, i))(trial_ids)

        def per_trial_nell(q, datum):
            ys_i, k_i = datum
            p1, p2 = softplus(q[0]), softplus(q[1])

            def transition_sampler(x, k):
                eps = jax.random.normal(k, x.shape)
                return x + x * (1.0 - p1 * x**2) * dt + jnp.sqrt(dt) * eps

            def mpdf(y, x):
                return meas_pmf(y, x, p2)

            _, nell = bootstrap_filter(
                transition_sampler, mpdf, ys_i, ic.sampler, k_i, n,
                None, conti_resampling=True, remat_chunk=args.remat_chunk,
            )
            return nell

        data = (yss, keys_pf)
    else:
        raise ValueError(method)

    P0 = jnp.full((B, 2), 0.5)
    # One optimiser for every estimator family (comparability): the
    # per-trial batched L-BFGS drives a vmapped per-trial objective —
    # its Armijo line search compiles ~10x faster than the vmapped
    # optax zoom search and converges equivalently on these 2-param
    # problems (tests/test_estimation.py cross-checks the two).
    batched_nell = lambda P: jax.vmap(per_trial_nell)(P, data)
    p_raw, info = lbfgs_batched(
        batched_nell, P0,
        max_steps=args.opt_steps, chunk_steps=args.chunk_steps,
        gtol=args.gtol,
    )
    return softplus(p_raw), info, info["wall_s"]


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--N", type=int, default=4)
    p.add_argument("--T", type=int, default=1000)
    p.add_argument("--true-p1", type=float, default=3.0)
    p.add_argument("--true-p2", type=float, default=3.0)
    p.add_argument("--methods", nargs="+", default=["ghf", "ekf", "pf"],
                   choices=["ghf", "ekf", "pf"])
    p.add_argument("--gh", type=int, default=11)
    p.add_argument("--nparticles", type=int, default=512)
    p.add_argument("--remat-chunk", type=int, default=50)
    p.add_argument("--opt-steps", type=int, default=100)
    p.add_argument("--chunk-steps", type=int, default=5)
    p.add_argument("--trial-chunk", type=int, default=0,
                   help="fit the trial ensemble in slices of this many "
                        "trials (0 = all at once); per-trial L-BFGS "
                        "makes the slicing exact")
    p.add_argument("--gtol", type=float, default=1e-5)
    args = p.parse_args()
    common.setup(args)

    dt, ic, drift, disp, emission, meas_pmf, yss = simulate_trials(args)

    rows = []
    for method in args.methods:
        # Per-trial L-BFGS is trial-independent, so slicing the trial
        # batch into chunks gives the identical ensemble with smaller
        # device working sets.
        tc = args.trial_chunk or args.trials
        p_parts, info_parts, wall = [], [], 0.0
        for lo in range(0, args.trials, tc):
            ids = jnp.arange(lo, min(lo + tc, args.trials))
            p_c, info_c, wall_c = fit(
                method, args, dt, ic, drift, disp, emission, meas_pmf,
                yss[lo:lo + tc], trial_ids=ids,
            )
            p_parts.append(p_c)
            info_parts.append(info_c)
            wall += wall_c
            print(f"[{method}] chunk {lo}-{lo + len(ids)}: "
                  f"{wall_c:.1f}s, converged "
                  f"{int(np.asarray(info_c['converged']).sum())}/{len(ids)}",
                  flush=True)
        p_hat = jnp.concatenate(p_parts, axis=0)
        info = {
            k: np.concatenate([np.asarray(i[k]) for i in info_parts])
            for k in ("converged", "steps", "nell")
        }
        finite = jnp.isfinite(p_hat).all(axis=-1) & jnp.asarray(
            np.asarray(info["converged"])
        )
        common.save_results(
            "parameter_estimation", f"{method}_s{args.seed}",
            p_hat=p_hat, nell=info["nell"], steps=info["steps"],
            converged=info["converged"],
        )
        row = dict(
            experiment="parameter_estimation_baselines", method=method,
            trials=args.trials, T=args.T,
            converged=int(np.asarray(info["converged"]).sum()),
            divergent=int(args.trials - finite.sum()),
            median_steps=int(np.median(np.asarray(info["steps"]))),
            p1_mean=float(jnp.mean(p_hat[finite, 0])),
            p1_std=float(jnp.std(p_hat[finite, 0])),
            p2_mean=float(jnp.mean(p_hat[finite, 1])),
            p2_std=float(jnp.std(p_hat[finite, 1])),
            wall_time_s=round(wall, 3),
            trials_per_sec=round(args.trials / wall, 3),
        )
        if method == "ghf":
            row["gh_order"] = args.gh
        if method == "pf":
            row["nparticles"] = args.nparticles
        # Per-row protocol hyperparameters: rows survive partial
        # --methods re-runs, so each must carry the settings it was
        # produced under (a shared string could misdescribe retained
        # rows from runs with different gh/nparticles/gtol).
        row["gtol"] = args.gtol
        rows.append(row)
        common.emit(row)

    # Merge into the parameter-estimation summary next to the MF leg.
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "SUMMARY_parameter_estimation.json")
    summary = {}
    if os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    # Update per method (a partial --methods invocation must not clobber
    # rows from earlier runs of the other estimators).
    merged = {r["method"]: r for r in summary.get("baselines", [])}
    merged.update({r["method"]: r for r in rows})
    summary["baselines"] = [merged[m] for m in ("ghf", "ekf", "pf")
                            if m in merged]
    summary["baselines_protocol"] = (
        "GHF / EKF / bootstrap PF (continuous resampling) MLE on trials "
        "identical to the MF leg; per-trial batched L-BFGS "
        "(fit_mle_batched); hyperparameters (gh_order / nparticles / "
        "gtol) are stored per row since rows survive partial --methods "
        "re-runs; counterpart of dardel/parameter_estimation/ghf_ekf.py "
        "and pf.py (SciPy L-BFGS-B, one process per trial)."
    )
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
