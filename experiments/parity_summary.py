"""Side-by-side scoring of ours vs the reference's filter engine.

Consumes the npz artifacts of ``experiments/benes_bernoulli.py``
(ours) and ``experiments/reference_parity.py`` (the reference's
own ``moment_filter_*`` on identical trials, CPU f64), scores BOTH
against the shared brute-force grid truth with the reference's CF
metrics (``dardel/benes_bernoulli/compute_errs.py:94-113``), and emits
one record per (N, mode, closure) cell:

    {N, mode, closure, ours: {divergent, cf_sup, ...}, ref: {...}}

Metric means are taken over the trials where BOTH engines stayed
finite, so the accuracy comparison is paired.  The full table is
written to ``experiments/SUMMARY_reference_parity.json``.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json

import jax.numpy as jnp
import numpy as np

from experiments import common
from experiments.benes_bernoulli import cell_name
from experiments.compute_errors import brute_force_truth, cf_errors_chunked


def _truth(seed, any_yss, grid_n, substeps):
    cache = os.path.join(
        common.RESULTS_DIR, "benes_bernoulli", f"truth_s{seed}_{any_yss.shape[0]}.npz"
    )
    if os.path.exists(cache):
        data = np.load(cache)
        return jnp.asarray(data["pss"]), jnp.asarray(data["xs_grid"])
    pss, xs_grid = brute_force_truth(
        jnp.asarray(any_yss), grid_n=grid_n, substeps=substeps
    )
    np.savez(cache, pss=np.asarray(pss), xs_grid=np.asarray(xs_grid))
    return pss, xs_grid


def _score_arrays(data, mode, pss, xs_grid, zs, bf_means):
    """Per-trial metric arrays (trials,) / (trials, T) for one engine."""
    moments = jnp.asarray(data["moments"])
    mean = None if mode == "raw" else jnp.asarray(data["means"])
    scale = None
    if mode == "scaled":
        scale = jnp.asarray(
            data["scales"] if "scales" in data else np.sqrt(data["variances"])
        )
    sup_e, l1_e, l2_e = cf_errors_chunked(
        moments, pss, xs_grid, zs, mean=mean, scale=scale
    )
    est_means = (moments[..., 1].T if mode == "raw" else jnp.asarray(data["means"]).T)
    mean_err = jnp.abs(est_means - bf_means)
    return dict(cf_sup=sup_e, cf_l1=l1_e, cf_l2=l2_e, mean_abs_err=mean_err)


def _reduce(arrays, mask, divergent):
    out = {k: float(jnp.mean(v[mask])) for k, v in arrays.items()}
    out["divergent"] = divergent
    return out


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--Ns", type=int, nargs="+", default=list(range(2, 16)))
    p.add_argument("--modes", nargs="+", default=["raw", "central", "scaled"])
    p.add_argument("--closures", nargs="+", default=["tme", "tme-normal"])
    p.add_argument("--impl-suffix", default="", help="ours-side npz suffix")
    p.add_argument("--grid-n", type=int, default=2000)
    p.add_argument("--substeps", type=int, default=100)
    p.add_argument("--zs-n", type=int, default=400)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "SUMMARY_reference_parity.json"
    ))
    args = p.parse_args()
    common.setup(args)

    zs = jnp.linspace(-2.0, 2.0, args.zs_n)
    truth = None
    records = []
    for mode in args.modes:
        for closure in args.closures:
            for N in args.Ns:
                name_ours = cell_name(N, mode, closure, args.seed) + args.impl_suffix
                name_ref = f"refcode_N{N}_{mode}_{closure}_s{args.seed}"
                try:
                    ours = common.load_results("benes_bernoulli", name_ours)
                    ref = common.load_results("benes_bernoulli", name_ref)
                except FileNotFoundError as e:
                    common.emit(dict(N=N, mode=mode, closure=closure,
                                     skipped=str(e)[:120]))
                    continue
                if truth is None:
                    pss, xs_grid = _truth(
                        args.seed, ours["yss"], args.grid_n, args.substeps
                    )
                    bf_means = jnp.trapezoid(pss * xs_grid, xs_grid, axis=-1)
                    truth = (pss, xs_grid, bf_means)
                pss, xs_grid, bf_means = truth

                mask = np.asarray(ours["finite"]) & np.asarray(ref["finite"])
                a_ours = _score_arrays(ours, mode, pss, xs_grid, zs, bf_means)
                a_ref = _score_arrays(ref, mode, pss, xs_grid, zs, bf_means)
                # Joint scoring mask: the metric means are paired over
                # trials where BOTH engines are finite AND both score
                # cleanly (re-quadrature of a finite-but-near-singular
                # moment trajectory can still NaN; such trials must not
                # poison either side's mean).
                scored = mask.copy()
                for arrs in (a_ours, a_ref):
                    for v in arrs.values():
                        fin = np.asarray(jnp.isfinite(v))
                        scored &= fin if fin.ndim == 1 else fin.all(axis=1)
                n_all = int(np.asarray(ours["finite"]).shape[0])
                rec = dict(
                    N=N, mode=mode, closure=closure,
                    trials=n_all,
                    both_finite=int(mask.sum()),
                    scored=int(scored.sum()),
                    ours=_reduce(
                        a_ours, scored,
                        int(n_all - np.asarray(ours["finite"]).sum()),
                    ),
                    ref=_reduce(
                        a_ref, scored,
                        int(n_all - np.asarray(ref["finite"]).sum()),
                    ),
                )
                rec["ours"]["wall_time_s"] = round(float(ours["wall_time"]), 4)
                if "rescued" in ours:
                    rec["ours"]["rescued"] = int(ours["rescued"])
                records.append(rec)
                common.emit(rec)

    with open(args.out, "w") as f:
        json.dump(
            dict(
                protocol="benes_bernoulli N x mode x closure, ours vs "
                         "reference code (CPU f64) on identical trials",
                hardware=common.hardware(),
                seed=args.seed, records=records,
            ),
            f, indent=1,
        )
    print(f"wrote {args.out} ({len(records)} cells)")


if __name__ == "__main__":
    main()
