"""3D Lotka–Volterra food-chain filtering: moment filter vs GHF/EKF.

The first ≥3-dimensional end-to-end deployment of the N-D machinery:
the reference's multi-index/quadrature code is
general-d (``mfs/multi_dims/multi_indices.py:25-58``,
``mfs/multi_dims/quadratures.py:120-178``) but its experiments stop at
d = 2.  Here the 3-species stochastic Lotka–Volterra chain
(``mfs_tpu.models.lotka_volterra_3d``) is filtered with
``moment_filter_nd_cms`` at several orders N (tensor-product
quadrature: s = C(N-1+3, 3) basis polynomials, s^3 nodes per step) and
scored against the simulated trajectory, with GHF/EKF baselines on
identical trials.

Usage:
    python experiments/lotka_volterra_3d.py --Ns 2 3 4 --trials 64 \
        --T 200 --methods mf ghf ekf --summary
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json

import jax
import jax.numpy as jnp
import numpy as np

from experiments import common
from mfs_tpu.ops.eigh import ENGINES


def run_mf(N, model_of, trials, T, eigh_impl, seed, chunk_T):
    from mfs_tpu.multi_dims import (
        generate_graded_lexico_multi_indices,
        gram_and_hankel_indices_graded_lexico,
        moment_filter_nd_cms,
        poly_tme_nd,
    )

    B = trials
    mis = generate_graded_lexico_multi_indices(3, 2 * N - 1)
    inds = gram_and_hankel_indices_graded_lexico(N, 3)
    model = model_of(mis)
    x0s, xss, yss = model.simulate(jax.random.PRNGKey(seed), B)
    ys = yss[:T]

    poly = poly_tme_nd(
        model.drift, model.dispersion, model.dt, 2, mis,
        drift_deg=2, dispersion_deg=1,
    )
    ic = model.init_cond
    cms0 = jnp.broadcast_to(ic.cms, (B,) + ic.cms.shape)
    mean0 = jnp.broadcast_to(ic.mean, (B, 3))
    fn = jax.jit(
        lambda c0, m0, y: moment_filter_nd_cms(
            poly.cms, poly.mean, model.measurement_cond_pdf, y,
            (mis, inds), c0, m0, eigh_impl=eigh_impl,
            predict_fn=poly.predict_cms,
        )
    )
    (cmss, means, nell), dt_run = common.timed_call_time_chunked(
        fn, (cms0, mean0), ys, chunk_T, traj_idx=(0, 1)
    )
    err = jnp.abs(means - xss[:T])
    finite = jnp.isfinite(means).all(axis=(0, 2))
    common.save_results(
        "lotka_volterra_3d", f"mf_N{N}_s{seed}_{eigh_impl}",
        means=means, nell=nell, xss=xss[:T], finite=finite,
    )
    row = dict(
        experiment="lotka_volterra_3d", d=3, N=N, s=int(inds.shape[1]),
        trials=B, T=T, transition="poly", eigh_impl=eigh_impl,
        divergent=int(B - finite.sum()),
        mean_abs_err=float(jnp.mean(jnp.where(finite[None, :, None], err, 0.0))),
        wall_time_s=round(float(dt_run), 3),
    )
    return row, jnp.where(finite, nell, jnp.nan)


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--Ns", type=int, nargs="+", default=[2, 3])
    p.add_argument("--T", type=int, default=200)
    p.add_argument("--chunk-T", type=int, default=50)
    p.add_argument("--methods", nargs="+", default=["mf", "ghf", "ekf"],
                   choices=["mf", "ghf", "ekf"])
    p.add_argument("--eigh-impls", nargs="+", default=["refined"],
                   choices=list(ENGINES))
    p.add_argument("--gh", type=int, default=7)
    p.add_argument("--summary", action="store_true")
    args = p.parse_args()
    common.setup(args)

    from mfs_tpu.filters.gaussian import ekf, sgp_filter
    from mfs_tpu.filters.sigma_points import SigmaPoints
    from mfs_tpu.models import lotka_volterra_3d
    from mfs_tpu.multi_dims import generate_graded_lexico_multi_indices

    rows = []
    if "mf" in args.methods:
        for N in args.Ns:
            nells = {}
            for impl in args.eigh_impls:
                row, nell = run_mf(
                    N, lotka_volterra_3d, args.trials, args.T, impl,
                    args.seed, args.chunk_T,
                )
                nells[impl] = nell
                rows.append(row)
                common.emit(row)
            if len(nells) > 1:
                impls = list(nells)
                base = nells[impls[0]]
                for other in impls[1:]:
                    dmax = jnp.nanmax(jnp.abs(nells[other] - base))
                    agree = dict(
                        d=3, N=N,
                        nell_agreement=f"{impls[0]} vs {other}",
                        max_abs_diff=float(dmax),
                        max_rel_diff=float(dmax / jnp.nanmax(jnp.abs(base))),
                    )
                    rows.append(agree)
                    common.emit(agree)

    # --- Gaussian baselines on identical trials -----------------------
    B, T = args.trials, args.T
    mis1 = generate_graded_lexico_multi_indices(3, 1)
    model = lotka_volterra_3d(mis1)
    ic = model.init_cond
    x0s, xss, yss = model.simulate(jax.random.PRNGKey(args.seed), B)
    xs, ys = xss[:T], yss[:T]
    dt = model.dt

    def state_cond_m_cov(x, _dt):
        return x + model.drift(x) * _dt, model.dispersion(x) ** 2 * _dt

    def measurement_cond_m_cov(x):
        prob = model.emission(x[0])
        return jnp.atleast_1d(prob), jnp.atleast_2d(prob * (1 - prob))

    def emit_baseline(method, means, dt_run, extra=None):
        finite = jnp.isfinite(means).all(axis=(0, 2))
        err = jnp.abs(means - xs)
        row = dict(
            experiment="lotka_volterra_3d", d=3, method=method, trials=B,
            T=T, divergent=int(B - finite.sum()),
            mean_abs_err=float(
                jnp.mean(jnp.where(finite[None, :, None], err, 0.0))
                * B / jnp.maximum(finite.sum(), 1)
            ),
            wall_time_s=round(float(dt_run), 3),
        )
        row.update(extra or {})
        common.save_results(
            "lotka_volterra_3d", f"{method}_s{args.seed}",
            means=means, xs=xs, finite=finite,
        )
        rows.append(row)
        common.emit(row)

    m0 = jnp.asarray(ic.mean)
    v0 = jnp.asarray(ic.cov)

    if "ghf" in args.methods:
        sgps = SigmaPoints.gauss_hermite(d=3, order=args.gh)
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
        emit_baseline("ghf", means, dt_run, {"gh_order": args.gh})

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
        emit_baseline("ekf", means, dt_run)

    if args.summary:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "SUMMARY_lotka_volterra_3d.json")
        out = dict(
            protocol=(
                f"3-species stochastic Lotka-Volterra food chain "
                f"(d=3), T={args.T}, central mode, poly-TME-2, f64 "
                f"I/O, {common.hardware()}; moment filter (tensor-product "
                f"quadrature, s^3 nodes) vs GHF(gh={args.gh}) / EKF on "
                f"identical trials; abs filtering-mean error vs the "
                f"simulated trajectory. First d=3 deployment — the "
                f"reference's experiments stop at d=2."
            ),
            rows=rows,
        )
        if os.path.exists(path):
            with open(path) as f:
                old = json.load(f)

            def rowkey(r):
                return (r.get("N"), r.get("eigh_impl"), r.get("method"),
                        r.get("nell_agreement"))

            mine = {rowkey(r) for r in rows}
            out["rows"] = [
                r for r in old.get("rows", []) if rowkey(r) not in mine
            ] + rows
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", path)


if __name__ == "__main__":
    main()
