"""2D prey–predator moment filtering (counterpart of reference
``dardel/prey_predator/mf.py`` + ``run_prey_predator_mf_gpu.sh``).

The reference splits N > 5 onto single-GPU Slurm array tasks; here the
trial ensemble is one batched scan (shard with ``mfs_tpu.parallel`` on
a multi-device mesh).  Reports the absolute error of the filtering mean
against the simulated trajectory, the wall time per eigensolver
engine, and the nell agreement between engines per N.

Usage (reference GPU-sweep territory is N in {3, 5, 7}):
    python experiments/prey_predator.py --Ns 3 5 7 \
        --eigh-impls refined xla --transition poly --trials 64
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json

import jax
import jax.numpy as jnp

from experiments import common
from mfs_tpu.ops.eigh import ENGINES


def run_one(N, mode, trials, T, tme_order, eigh_impl, transition, seed,
            chunk_T=0):
    from mfs_tpu.models import prey_predator
    from mfs_tpu.multi_dims import (
        generate_graded_lexico_multi_indices,
        gram_and_hankel_indices_graded_lexico,
        moment_filter_nd_cms,
        moment_filter_nd_scms,
        sde_cond_moments_nd_tme,
    )

    B = trials
    mis = generate_graded_lexico_multi_indices(2, 2 * N - 1)
    inds = gram_and_hankel_indices_graded_lexico(N, 2)
    model = prey_predator(mis)
    x0s, xss, yss = model.simulate(jax.random.PRNGKey(seed), B)
    ys = yss[:T]

    trans = sde_cond_moments_nd_tme(
        model.drift, model.dispersion, model.dt, tme_order, mis
    )
    predict_fn = None
    if transition == "poly":
        from mfs_tpu.multi_dims import poly_tme_nd

        poly = poly_tme_nd(
            model.drift, model.dispersion, model.dt, tme_order, mis,
            drift_deg=2, dispersion_deg=1,
        )
        # Both modes get the fused weight-inside-the-tower predict.
        predict_fn = poly.predict_cms if mode == "central" else poly.predict_scms
        trans = poly
    ic = model.init_cond
    if mode == "central":
        cms0 = jnp.broadcast_to(ic.cms, (B,) + ic.cms.shape)
        mean0 = jnp.broadcast_to(ic.mean, (B, 2))
        fn = jax.jit(
            lambda c0, m0, y: moment_filter_nd_cms(
                trans.cms, trans.mean, model.measurement_cond_pdf, y,
                (mis, inds), c0, m0, eigh_impl=eigh_impl,
                predict_fn=predict_fn,
            )
        )
        (cmss, means, nell), dt_run = common.timed_call_time_chunked(
            fn, (cms0, mean0), ys, chunk_T, traj_idx=(0, 1)
        )
    else:
        from mfs_tpu.multi_dims.moments import monomials_nd

        scale0_1 = jnp.sqrt(jnp.diagonal(ic.cov))
        scms0 = jnp.broadcast_to(
            ic.cms / monomials_nd(scale0_1, mis), (B,) + ic.cms.shape
        )
        mean0 = jnp.broadcast_to(ic.mean, (B, 2))
        scale0 = jnp.broadcast_to(scale0_1, (B, 2))
        fn = jax.jit(
            lambda s0, m0, sc0, y: moment_filter_nd_scms(
                trans.scms, trans.mean_var, model.measurement_cond_pdf, y,
                (mis, inds), s0, m0, sc0, eigh_impl=eigh_impl,
                predict_fn=predict_fn,
            )
        )
        (scmss, means, scales, nell), dt_run = common.timed_call_time_chunked(
            fn, (scms0, mean0, scale0), ys, chunk_T, traj_idx=(0, 1, 2)
        )

    err = jnp.abs(means - xss[:T])  # (T, B, 2)
    finite = jnp.isfinite(means).all(axis=(0, 2))
    tag = "" if transition == "autodiff" else f"_{transition}"
    if eigh_impl != "refined":
        tag += f"_{eigh_impl}"
    common.save_results(
        "prey_predator", f"mf_N{N}_{mode}_s{seed}{tag}",
        means=means, nell=nell, xss=xss[:T], finite=finite,
    )
    row = dict(
        experiment="prey_predator", N=N, mode=mode, trials=B,
        T=T, transition=transition, eigh_impl=eigh_impl,
        divergent=int(B - finite.sum()),
        mean_abs_err=float(jnp.mean(jnp.where(finite[None, :, None], err, 0.0))),
        wall_time_s=round(float(dt_run), 3),
    )
    return row, jnp.where(finite, nell, jnp.nan)


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--Ns", type=int, nargs="+", default=[3])
    p.add_argument("--T", type=int, default=2000)
    p.add_argument("--chunk-T", type=int, default=250,
                   help="split the time scan into dispatches of this "
                        "many steps (0 = one dispatch)")
    p.add_argument("--mode", choices=["central", "scaled"], default="central")
    p.add_argument("--tme-order", type=int, default=2)
    p.add_argument("--eigh-impls", nargs="+", default=["refined"],
                   choices=list(ENGINES))
    p.add_argument("--transition", default="autodiff",
                   choices=["autodiff", "poly"],
                   help="poly = closed-form matmul TME with the fused "
                        "predict contraction (both modes)")
    p.add_argument("--summary", action="store_true",
                   help="write SUMMARY_prey_predator.json")
    args = p.parse_args()
    common.setup(args)

    rows = []
    for N in args.Ns:
        nells = {}
        for impl in args.eigh_impls:
            row, nell = run_one(
                N, args.mode, args.trials, args.T, args.tme_order,
                impl, args.transition, args.seed, chunk_T=args.chunk_T,
            )
            nells[impl] = nell
            rows.append(row)
            common.emit(row)
        if len(nells) > 1:
            impls = list(nells)
            base = nells[impls[0]]
            for other in impls[1:]:
                d = jnp.nanmax(jnp.abs(nells[other] - base))
                rel = d / jnp.nanmax(jnp.abs(base))
                agree = dict(
                    N=N, nell_agreement=f"{impls[0]} vs {other}",
                    max_abs_diff=float(d), max_rel_diff=float(rel),
                )
                rows.append(agree)
                common.emit(agree)

    if args.summary:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "SUMMARY_prey_predator.json")
        out = dict(
            protocol=(
                f"prey-predator 2D Lotka-Volterra, {args.mode} mode, "
                f"TME-{args.tme_order} ({args.transition} transition), "
                f"f64 I/O, {common.hardware()}; N sweep x eigh "
                f"implementation with per-N nell cross-checks; T and "
                f"trials per row (reference "
                f"dardel/run_prey_predator_mf_gpu.sh:4-40 runs N>5 on "
                f"one GPU per Slurm task)"
            ),
            rows=rows,
        )
        # Merge: a partial --Ns re-run must not clobber other Ns' rows.
        if os.path.exists(path):
            with open(path) as f:
                old = json.load(f)

            def rowkey(r):
                return (r.get("N"), r.get("eigh_impl"),
                        r.get("nell_agreement"), r.get("mode"))

            mine = {rowkey(r) for r in rows}
            out["rows"] = [
                r for r in old.get("rows", []) if rowkey(r) not in mine
            ] + rows
            out["rows"].sort(key=lambda r: (r.get("N") or 0))
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", path)


if __name__ == "__main__":
    main()
