"""2D prey-predator baselines: GHF, EKF, bootstrap PF filtering errors.

Counterpart of reference ``dardel/prey_predator/ghf_ekf.py`` and
``dardel/prey_predator/pf.py``: score the Gaussian-filter and
particle-filter baselines' absolute filtering-mean error against the
simulated trajectory, on trials IDENTICAL to the moment-filter sweep
(``experiments/prey_predator.py``, same seed protocol) so the rows in
``SUMMARY_prey_predator.json`` are directly comparable.

Batched: GHF/EKF run vmapped over the trial ensemble in one program;
the PF runs through the batch-first ``bootstrap_filter`` with
vector-state particles and a per-step mean reduction (no O(T x n)
trajectory materialisation).  The reference runs one OS process per
trial.

Usage:
    python experiments/prey_predator_baselines.py --methods ghf ekf pf \
        --trials 64 --T 200 --nparticles 4000
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json

import jax
import jax.numpy as jnp
import numpy as np

from experiments import common


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--T", type=int, default=200)
    p.add_argument("--methods", nargs="+", default=["ghf", "ekf", "pf"],
                   choices=["ghf", "ekf", "pf"])
    p.add_argument("--gh", type=int, default=11)
    p.add_argument("--nparticles", type=int, default=4000)
    args = p.parse_args()
    common.setup(args)

    from mfs_tpu.filters.gaussian import ekf, sgp_filter
    from mfs_tpu.filters.resampling import stratified
    from mfs_tpu.filters.sigma_points import SigmaPoints
    from mfs_tpu.filters.smc import bootstrap_filter
    from mfs_tpu.models import prey_predator
    from mfs_tpu.multi_dims import generate_graded_lexico_multi_indices

    B, T = args.trials, args.T
    mis = generate_graded_lexico_multi_indices(2, 1)
    model = prey_predator(mis)
    ic = model.init_cond
    # identical data protocol to experiments/prey_predator.py
    x0s, xss, yss = model.simulate(jax.random.PRNGKey(args.seed), B)
    xs, ys = xss[:T], yss[:T]  # (T, B, 2), (T, B, 1)
    dt = model.dt
    sigma = 0.1

    # Euler transition mean/cov (reference ghf_ekf.py default --trans)
    def state_cond_m_cov(x, _dt):
        return x + model.drift(x) * _dt, model.dispersion(x) ** 2 * _dt

    def measurement_cond_m_cov(x):
        prob = model.emission(x[0])
        return jnp.atleast_1d(prob), jnp.atleast_2d(prob * (1 - prob))

    rows = []

    def emit(method, means, dt_run, extra=None):
        finite = jnp.isfinite(means).all(axis=(0, 2))
        err = jnp.abs(means - xs)
        row = dict(
            experiment="prey_predator_baselines", method=method, trials=B,
            T=T, divergent=int(B - finite.sum()),
            mean_abs_err=float(
                jnp.mean(jnp.where(finite[None, :, None], err, 0.0))
                * B / jnp.maximum(finite.sum(), 1)
            ),
            wall_time_s=round(float(dt_run), 3),
        )
        row.update(extra or {})
        common.save_results(
            "prey_predator", f"{method}_s{args.seed}",
            means=means, xs=xs, finite=finite,
        )
        rows.append(row)
        common.emit(row)

    m0 = jnp.asarray(ic.mean)
    v0 = jnp.asarray(ic.cov)

    if "ghf" in args.methods:
        sgps = SigmaPoints.gauss_hermite(d=2, order=args.gh)
        fn = jax.jit(
            jax.vmap(
                lambda y: sgp_filter(
                    state_cond_m_cov, measurement_cond_m_cov, sgps,
                    m0, v0, dt, y,
                )[0],
                in_axes=1, out_axes=1,
            )
        )
        means, dt_run = common.timed_call(fn, ys)
        emit("ghf", means, dt_run, {"gh_order": args.gh})

    if "ekf" in args.methods:
        fn = jax.jit(
            jax.vmap(
                lambda y: ekf(
                    state_cond_m_cov, measurement_cond_m_cov, m0, v0, dt, y
                )[0],
                in_axes=1, out_axes=1,
            )
        )
        means, dt_run = common.timed_call(fn, ys)
        emit("ekf", means, dt_run)

    if "pf" in args.methods:
        n = args.nparticles

        def transition_sampler(x, k):
            # Euler–Maruyama with the diagonal multiplicative noise
            eps = jax.random.normal(k, x.shape)
            return x + model.drift(x) * dt + sigma * x * jnp.sqrt(dt) * eps

        def mpdf(y, x):
            return model.measurement_cond_pdf(y, x)

        def init_sampler(k, ns):
            keys = jax.random.split(k, B)
            return jax.vmap(lambda kk: ic.sampler(kk, ns))(keys)  # (B, n, 2)

        fn = jax.jit(
            lambda y, k: bootstrap_filter(
                transition_sampler, mpdf, y, init_sampler, k, n,
                stratified, vector_state=True,
                out_fn=lambda s: jnp.mean(s, axis=-2),
            )[0]
        )
        means, dt_run = common.timed_call(
            fn, ys, jax.random.PRNGKey(args.seed + 13)
        )
        emit("pf", means, dt_run, {"nparticles": n})

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "SUMMARY_prey_predator.json")
    summary = {}
    if os.path.exists(path):
        with open(path) as f:
            summary = json.load(f)
    summary["baselines"] = rows
    summary["baselines_protocol"] = (
        "GHF (GH order {gh}, {np2} sigma points) / EKF / bootstrap PF "
        "({np} particles, stratified) on trials identical to the MF "
        "sweep; Euler transitions (reference "
        "dardel/prey_predator/ghf_ekf.py and pf.py defaults); abs "
        "filtering-mean error vs the simulated trajectory."
    ).format(gh=args.gh, np2=args.gh**2, np=args.nparticles)
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
