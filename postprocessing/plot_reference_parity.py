"""Side-by-side parity figure: our filter engine vs the reference's
own ``moment_filter_*`` (its code, CPU f64) on identical trials.

Reads ``experiments/SUMMARY_reference_parity.json`` (written by
``experiments/parity_summary.py``) and draws, per moment mode x
closure: CF sup-distance vs N for both engines, plus divergence counts
— the "matches-or-beats" evidence, the
comparison the reference's Fig. 4 pipeline
(``reproduce_paper_plots/plot_benes_bernoulli_errs_and_times.py``)
never makes because it has only one engine.
"""
import argparse
import json
import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import matplotlib.pyplot as plt

from postprocessing import common


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--metric", default="cf_sup",
                   choices=["cf_sup", "cf_l1", "cf_l2", "mean_abs_err"])
    args = p.parse_args()

    path = os.path.join(os.path.dirname(common.HERE), "experiments",
                        "SUMMARY_reference_parity.json")
    with open(path) as f:
        summary = json.load(f)
    rows = summary["records"] if isinstance(summary, dict) else summary

    cells = {}
    for r in rows:
        cells.setdefault((r["mode"], r["closure"]), []).append(r)

    modes = sorted({m for m, _ in cells})
    closures = sorted({c for _, c in cells})
    fig, axes = plt.subplots(
        len(closures), len(modes),
        figsize=(4.2 * len(modes), 3.4 * len(closures)),
        sharex=True, sharey=True, squeeze=False,
    )
    for i, closure in enumerate(closures):
        for j, mode in enumerate(modes):
            ax = axes[i][j]
            rs = sorted(cells.get((mode, closure), []), key=lambda r: r["N"])
            if not rs:
                ax.set_axis_off()
                continue
            Ns = [r["N"] for r in rs]
            ax.semilogy(Ns, [r["ours"][args.metric] for r in rs],
                        "o-", label="ours")
            ax.semilogy(Ns, [r["ref"][args.metric] for r in rs],
                        "s--", label="reference code (CPU f64)")
            for r in rs:
                do, dr = r["ours"]["divergent"], r["ref"]["divergent"]
                if do or dr:
                    ax.annotate(f"{do}/{dr}", (r["N"], r["ours"][args.metric]),
                                fontsize=7, textcoords="offset points",
                                xytext=(0, 6))
            ax.set_title(f"{mode} / {closure}", fontsize=10)
            if i == len(closures) - 1:
                ax.set_xlabel("moment order N")
            if j == 0:
                ax.set_ylabel(args.metric)
            ax.grid(True, which="both", alpha=0.3)
    axes[0][0].legend(fontsize=8)
    fig.suptitle(
        "Beneš–Bernoulli filtering accuracy vs brute-force truth — "
        "identical trials, two engines (annotations: divergent ours/ref)",
        fontsize=11,
    )
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    out = os.path.join(common.FIGURES_DIR,
                       f"reference_parity_{args.metric}.png")
    fig.savefig(out, dpi=130)
    print("wrote", out)


if __name__ == "__main__":
    main()
