"""Regenerate ``SUMMARY_benes_bernoulli.json`` from the parity records.

The flagship per-N accuracy table (ours-side: central mode, tme-normal
closure, default engine + divergence rescue) is a projection of
``SUMMARY_reference_parity.json``; this keeps the two committed
artifacts consistent after any re-scoring.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np

from experiments import common
from experiments.benes_bernoulli import cell_name


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="central")
    p.add_argument("--closure", default="tme-normal")
    p.add_argument("--impl", default="refined")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--summary", default=os.path.join(
        here, "SUMMARY_reference_parity.json"))
    p.add_argument("--out", default=os.path.join(
        here, "SUMMARY_benes_bernoulli.json"))
    args = p.parse_args()

    with open(args.summary) as f:
        records = json.load(f)["records"]

    rows = []
    for r in sorted(records, key=lambda r: r["N"]):
        if r["mode"] != args.mode or r["closure"] != args.closure:
            continue
        o = r["ours"]
        name = cell_name(r["N"], args.mode, args.closure, args.seed, args.impl)
        run = common.load_results("benes_bernoulli", name)
        wall = float(run["wall_time"])
        rows.append(dict(
            N=r["N"], trials=r["trials"], divergent=o["divergent"],
            rescued=o.get("rescued", 0),
            trials_per_sec=round(r["trials"] / wall, 1),
            cf_sup=o["cf_sup"], cf_l1=o["cf_l1"], cf_l2=o["cf_l2"],
            mean_abs_err=o["mean_abs_err"],
        ))

    out = dict(
        protocol=(
            f"Benes-Bernoulli, T=100, {args.mode} mode, TME-3 "
            f"{args.closure} closure, eigh_impl={args.impl} + "
            "divergence rescue on the host CPU, f64 I/O, "
            "1000 MC trials, errors vs brute-force grid truth (grid 2000 "
            "pts on [-6,6], chapman-tme-3, 100 substeps; CF distances on "
            "z in [-2,2], 400 pts), paired with the reference engine on "
            "the trials where both stayed finite (see "
            "SUMMARY_reference_parity.json)"
        ),
        hardware=f"{common.hardware()} (filters); host CPU f64 (grid truth + rescue)",
        rows=rows,
    )
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out, f"({len(rows)} rows)")


if __name__ == "__main__":
    main()
