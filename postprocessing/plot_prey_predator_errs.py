"""Prey–predator (2D) filtering error summary (paper Fig. 7).

Reads ``experiments/prey_predator.py`` artifacts (filtered means vs the
simulated trajectories) and plots the per-dimension absolute error over
time per moment order, with divergence accounting.

Counterpart of reference
``reproduce_paper_plots/plot_prey_predator_errs.py``.
"""
import argparse
import sys, os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import matplotlib.pyplot as plt

from postprocessing import common


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--Ns", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--mode", default="central")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tag", default="",
                   help="artifact-name suffix written by "
                        "experiments/prey_predator.py for non-default "
                        "transition/eigh (e.g. _poly_jacobi)")
    args = p.parse_args()

    fig, axes = plt.subplots(1, 2, figsize=(10, 3.8), sharey=True)
    for N in args.Ns:
        data = common.maybe_load(
            "prey_predator", f"mf_N{N}_{args.mode}_s{args.seed}{args.tag}"
        )
        if data is None:
            print(f"N={N}: no artifact, skipped")
            continue
        means = np.asarray(data["means"])  # (T, B, 2)
        xss = np.asarray(data["xss"])  # (T, B, 2)
        finite = np.asarray(data["finite"], bool)
        ndiv = int((~finite).sum())
        err = np.abs(means[:, finite] - xss[:, finite])  # (T, kept, 2)
        print(
            f"N={N}: trials={finite.shape[0]} divergent={ndiv} "
            f"mean_abs_err={err.mean():.5f}"
        )
        for d in range(2):
            axes[d].plot(err[..., d].mean(axis=1), label=f"N={N}")
    for d, ax in enumerate(axes):
        ax.set_xlabel("time step")
        ax.set_title(f"|filter mean - truth|, dim {d + 1}")
        ax.grid(alpha=0.3)
        ax.legend()
    common.savefig(fig, f"prey_predator_errs_{args.mode}")


if __name__ == "__main__":
    main()
