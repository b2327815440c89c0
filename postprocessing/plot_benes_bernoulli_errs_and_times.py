"""Beneš–Bernoulli error/time curves vs moment order N (paper Fig. 4).

Reads the artifacts of ``experiments/benes_bernoulli.py`` (timings,
divergences) and ``experiments/compute_errors.py`` (characteristic-
function and mean errors vs the brute-force grid truth), counts
divergent trials per N, and plots error-vs-N and per-trial-time-vs-N
curves.

Counterpart of reference
``reproduce_paper_plots/plot_benes_bernoulli_errs_and_times.py``.

Usage:
    python postprocessing/plot_benes_bernoulli_errs_and_times.py \
        --Ns 3 5 8 11 15 --mode raw --closure tme-normal --seed 0
"""
import argparse
import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import matplotlib.pyplot as plt

from postprocessing import common


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--Ns", type=int, nargs="+", default=[3, 5, 8, 11, 15])
    p.add_argument("--mode", default="raw")
    p.add_argument("--closure", default="tme-normal")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--impl-suffix", default="", help="npz suffix of the cell")
    p.add_argument("--summary", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "experiments", "SUMMARY_benes_bernoulli.json"),
        help="per-N aggregates used where no npz artifact exists")
    args = p.parse_args()

    # Summary fallback: the per-N aggregates of an earlier run render
    # the figure when the raw .npz artifacts are absent.
    summary_rows = {}
    spath = args.summary
    if os.path.exists(spath):
        import json

        with open(spath) as f:
            summary_rows = {r["N"]: r for r in json.load(f).get("rows", [])}

    rows = []
    for N in args.Ns:
        name = f"mf_N{N}_{args.mode}_{args.closure}_s{args.seed}{args.impl_suffix}"
        run = common.maybe_load("benes_bernoulli", name)
        errs = common.maybe_load("benes_bernoulli", f"errs_{name}")

        if run is not None:
            finite = np.asarray(run["finite"], bool)
            trials = finite.shape[0]
            ndiv = int(trials - finite.sum())
            wall = float(run["wall_time"])
            row = dict(
                N=N, trials=trials, divergent=ndiv,
                per_trial_ms=1e3 * wall / trials,
            )
            if errs is not None:
                mask = np.asarray(errs["finite"], bool)
                for k in ("cf_sup", "cf_l1", "cf_l2"):
                    row[k] = float(np.mean(np.asarray(errs[k])[mask]))
                row["mean_abs_err"] = float(
                    np.mean(np.asarray(errs["mean_err"])[mask])
                )
        elif N in summary_rows:
            s = summary_rows[N]
            row = dict(
                N=N, trials=s["trials"], divergent=s["divergent"],
                per_trial_ms=1e3 / s["trials_per_sec"],
                **{k: s[k] for k in
                   ("cf_sup", "cf_l1", "cf_l2", "mean_abs_err") if k in s},
            )
        else:
            raise FileNotFoundError(
                f"neither an npz artifact for {name} nor a SUMMARY row "
                f"for N={N} — run experiments/benes_bernoulli.py first"
            )
        rows.append(row)

    hdr = ["N", "trials", "divergent", "per_trial_ms",
           "cf_sup", "cf_l1", "cf_l2", "mean_abs_err"]
    print("  ".join(f"{h:>12s}" for h in hdr))
    for r in rows:
        print("  ".join(
            f"{r.get(h, float('nan')):12.6g}" if h != "N" else f"{r['N']:>12d}"
            for h in hdr
        ))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    Ns = [r["N"] for r in rows]
    for key, style in (("cf_sup", "o-"), ("cf_l1", "s-"), ("cf_l2", "^-"),
                       ("mean_abs_err", "d--")):
        vals = [r.get(key) for r in rows]
        if all(v is not None for v in vals):
            ax1.semilogy(Ns, vals, style, label=key.replace("_", " "))
    ax1.set_xlabel("moment order N")
    ax1.set_ylabel("mean error vs brute-force truth")
    ax1.set_title(f"Beneš–Bernoulli errors ({args.mode}, {args.closure})")
    ax1.legend()
    ax1.grid(True, which="both", alpha=0.3)

    ax2.semilogy(Ns, [r["per_trial_ms"] for r in rows], "o-",
                 label="moment filter (batched)")
    for r in rows:
        if r["divergent"]:
            ax2.annotate(f"{r['divergent']} div", (r["N"], r["per_trial_ms"]),
                         textcoords="offset points", xytext=(0, 8), fontsize=8)
    ax2.set_xlabel("moment order N")
    ax2.set_ylabel("wall time per trial [ms]")
    ax2.set_title("throughput")
    ax2.legend()
    ax2.grid(True, which="both", alpha=0.3)
    common.savefig(fig, f"benes_bernoulli_errs_and_times_{args.mode}")


if __name__ == "__main__":
    main()
