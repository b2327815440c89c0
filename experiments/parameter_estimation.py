"""Monte-Carlo parameter-estimation study on the Well–Poisson model.

Counterpart of reference ``dardel/parameter_estimation/mf.py``: per
trial, simulate a trajectory at the true parameters (p1, p2) = (3, 3),
then maximise the moment-filter likelihood with L-BFGS under a
softplus reparameterisation.  The on-device BFGS path runs *all
trials' optimisations batched* (vmapped) — the reference needs one
SciPy process per trial.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json

import jax
import jax.numpy as jnp
import numpy as np

from experiments import common
from mfs_tpu.ops.eigh import ENGINES


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--N", type=int, default=4)
    p.add_argument("--T", type=int, default=1000)
    p.add_argument("--true-p1", type=float, default=3.0)
    p.add_argument("--true-p2", type=float, default=3.0)
    p.add_argument("--opt-steps", type=int, default=100)
    p.add_argument("--chunk-steps", type=int, default=10,
                   help="run the batched L-BFGS as dispatches of this "
                        "many optimiser steps (0 = one dispatch)")
    p.add_argument("--eigh-impl", default="refined",
                   choices=list(ENGINES))
    p.add_argument("--gtol", type=float, default=1e-5,
                   help="per-trial gradient inf-norm stopping tolerance")
    p.add_argument("--scipy-check", type=int, default=0,
                   help="cross-check this many trials against per-trial "
                        "SciPy L-BFGS-B on CPU (reference optimiser)")
    p.add_argument("--grad-bench", action="store_true",
                   help="also time one batched grad(sum nell) per eigh impl")
    args = p.parse_args()
    common.setup(args)

    from mfs_tpu.models import well_poisson
    from mfs_tpu.one_dim.filtering import moment_filter_cms
    from mfs_tpu.sde import sde_cond_moments_euler

    N, B = args.N, args.trials
    dt, T_full, ts, ic, drift, disp, emission, meas_pmf, simulate = well_poisson(
        args.true_p1, N=N
    )
    key_sim, key_meas = jax.random.split(jax.random.PRNGKey(args.seed))
    xss = simulate(key_sim, B, 20)[:, : args.T]  # (B, T)
    yss = jax.random.poisson(key_meas, emission(xss, args.true_p2)).astype(xss.dtype)
    ys = jnp.swapaxes(yss, 0, 1)  # (T, B)

    mle_impl = args.eigh_impl

    # Batch-first MLE: every trial optimises its OWN (p1, p2), but all
    # trials flow through ONE filter call per objective evaluation —
    # the per-trial parameters broadcast through the transition/emission
    # closures along the native batch axis, and because the summed nell
    # is block-separable in the per-trial parameters, its VJP against
    # ones IS the stack of per-trial gradients.  ``lbfgs_batched``
    # drives every trial's OWN L-BFGS iteration (per-trial curvature
    # history + Armijo line search), freezes converged trials, and
    # stops when all are done — the reference drives SciPy L-BFGS-B
    # one OS process per trial (``dardel/parameter_estimation/mf.py:37-73``).
    from mfs_tpu.estimation.lbfgs_batched import lbfgs_batched

    def nell_all(P, ys_all, n_t=None, impl=None):
        n_t = n_t if n_t is not None else B
        p1 = jnp.logaddexp(0.0, P[:, 0])[:, None]  # (B,1): broadcasts over nodes
        p2 = jnp.logaddexp(0.0, P[:, 1])[:, None]
        trans = sde_cond_moments_euler(lambda u: drift(u, p1), disp, dt, N)
        _, _, out = moment_filter_cms(
            trans.cms, trans.mean,
            lambda y, u: meas_pmf(y, u, p2),
            jnp.broadcast_to(ic.cms, (n_t, 2 * N)), ic.mean * jnp.ones(n_t),
            ys_all, eigh_impl=impl or mle_impl,
        )
        return out  # (B,)

    p_raw, info = lbfgs_batched(
        lambda P: nell_all(P, ys), jnp.full((B, 2), 0.5),
        max_steps=args.opt_steps, chunk_steps=args.chunk_steps or 10,
        gtol=args.gtol,
    )
    p_hat = jnp.logaddexp(0.0, p_raw)
    final_nell = info["nell"]
    dt_run = info["wall_s"]

    finite = jnp.isfinite(p_hat).all(axis=-1) & jnp.asarray(info["converged"])
    common.save_results(
        "parameter_estimation", f"mf_N{N}_s{args.seed}", p_hat=p_hat,
        nell=final_nell, steps=info["steps"], converged=info["converged"],
    )
    mle_row = dict(
        experiment="parameter_estimation", N=N, trials=B, T=args.T,
        eigh_impl=mle_impl,
        divergent=int(B - finite.sum()),
        median_steps=int(np.median(np.asarray(info["steps"]))),
        max_steps_used=int(np.asarray(info["steps"]).max()),
        p1_mean=float(jnp.mean(p_hat[finite, 0])),
        p1_std=float(jnp.std(p_hat[finite, 0])),
        p2_mean=float(jnp.mean(p_hat[finite, 1])),
        p2_std=float(jnp.std(p_hat[finite, 1])),
        wall_time_s=round(float(dt_run), 3),
        trials_per_sec=round(B / float(dt_run), 2),
    )
    common.emit(mle_row)

    # --- per-trial SciPy L-BFGS-B quality cross-check (VERDICT r03
    # item 5): rerun the first --scipy-check trials through the
    # reference's own optimiser (SciPy, one problem at a time, CPU
    # xla-f64 filter) on IDENTICAL data and compare the fitted params.
    scipy_rows = None
    if args.scipy_check:
        import scipy.optimize as sopt

        K = min(args.scipy_check, B)
        cpu = jax.devices("cpu")[0]
        diffs = []
        with jax.default_device(cpu):
            ys_cpu = jax.device_put(np.asarray(ys[:, :K]), cpu)

            def nell_one_host(q, ys_col):
                out = nell_all(
                    jnp.broadcast_to(q, (1, 2)), ys_col[:, None], n_t=1,
                    impl="xla",
                )
                return out[0]

            # one compile for all K trials (the column is an argument)
            vg = jax.jit(jax.value_and_grad(nell_one_host))
            for i in range(K):
                r = sopt.minimize(
                    lambda x, i=i: [
                        np.asarray(v, np.float64)
                        for v in vg(jnp.asarray(x), ys_cpu[:, i])
                    ],
                    np.full(2, 0.5), jac=True, method="L-BFGS-B",
                )
                p_sp = np.logaddexp(0.0, r.x)
                diffs.append(p_sp - np.asarray(p_hat[i]))
        diffs = np.asarray(diffs)
        scipy_rows = dict(
            trials_checked=K,
            max_abs_param_diff=float(np.nanmax(np.abs(diffs))),
            median_abs_param_diff=float(np.nanmedian(np.abs(diffs))),
        )
        common.emit(dict(experiment="parameter_estimation_scipy_check",
                         **scipy_rows))

    # --- gradient-throughput ablation (VERDICT r02 item 3) ---
    # One batched grad(sum nell) evaluation at the init point per
    # eigh implementation: the quantity L-BFGS spends its time on.
    grad_rows = []
    if args.grad_bench:
        params0 = jnp.array([0.5, 0.5])
        cms0_b = jnp.broadcast_to(ic.cms, (B, 2 * N))
        mean0_b = ic.mean * jnp.ones(B)
        for impl in ENGINES:
            # Batch-first: the whole trial ensemble flows through ONE
            # filter call, as in production, not under a per-trial vmap.
            def nell_batch(params, ys_b, impl=impl):
                p1 = jnp.logaddexp(0.0, params[0])
                p2 = jnp.logaddexp(0.0, params[1])
                trans = sde_cond_moments_euler(lambda u: drift(u, p1), disp, dt, N)
                _, _, out = moment_filter_cms(
                    trans.cms, trans.mean,
                    lambda y, u: meas_pmf(y, u, p2),
                    cms0_b, mean0_b, ys_b, eigh_impl=impl,
                )
                return jnp.sum(out)

            g = jax.jit(jax.grad(nell_batch))
            gval, t_g = common.timed_call(g, params0, ys)
            row = dict(
                eigh_impl=impl, trials=B, T=args.T,
                grad_wall_time_s=round(float(t_g), 3),
                grad_trials_per_sec=round(B / float(t_g), 2),
                grad_l2=float(jnp.linalg.norm(gval)),
            )
            grad_rows.append(row)
            common.emit(row)

    out = dict(
        protocol=(
            f"Well-Poisson MLE, (p1,p2)=({args.true_p1},{args.true_p2}), "
            f"T={args.T}, N={N}, {B} MC trials, per-trial batched "
            f"L-BFGS (lbfgs_batched: softplus reparam, gtol={args.gtol}, "
            f"early stop, cap {args.opt_steps} iters) on the "
            f"moment_filter_cms nell; counterpart of "
            f"dardel/parameter_estimation/mf.py:37-77 (SciPy L-BFGS-B, "
            f"one process per trial).  grad_rows: one batched "
            f"grad(sum nell) at the init point per eigh implementation."
        ),
        hardware=common.hardware(),
        mle=mle_row,
        scipy_check=scipy_rows,
        grad_rows=grad_rows,
    )
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "SUMMARY_parameter_estimation.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
