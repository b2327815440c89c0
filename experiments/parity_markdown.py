"""Render SUMMARY_reference_parity.json as PARITY.md.

One markdown table per (mode, closure): per N, side-by-side divergence
counts and CF-distance / mean-error metrics for our engine vs the
reference's own ``moment_filter_*`` on identical trials, plus the
ours-beats-or-matches verdict per cell (ours' divergence <=
reference's and error <= its error at every N, modulo the
paired-metric noise floor).
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json


def fmt(x):
    return f"{x:.3g}"


def main():
    p = argparse.ArgumentParser(description=__doc__)
    here = os.path.dirname(os.path.abspath(__file__))
    p.add_argument("--summary", default=os.path.join(
        here, "SUMMARY_reference_parity.json"))
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(here), "PARITY.md"))
    # Paired metrics closer than this relative gap count as a tie.
    p.add_argument("--rel-tol", type=float, default=0.02)
    args = p.parse_args()

    with open(args.summary) as f:
        data = json.load(f)
    records = data["records"]

    groups = {}
    for r in records:
        groups.setdefault((r["mode"], r["closure"]), []).append(r)

    lines = [
        f"# PARITY — ours ({data.get('hardware', 'device not recorded')}) "
        "vs the reference's own filters",
        "",
        "Protocol: Beneš–Bernoulli, T=100, TME order 3, 1000 Monte-Carlo",
        "trials per cell, **identical simulated trajectories and",
        "measurements for both engines** (the reference's",
        "`moment_filter_{rms,cms,scms}` imported from a checkout of the",
        "reference and run on CPU f64 with its experiment defaults,",
        "`stable=False`; ours with `stable=True` and the tiered divergence",
        "rescue of `mfs_tpu.parallel.ensemble.rescue_diverged`: trials the",
        "first pass loses are re-run through LAPACK f64 eigh + LDL",
        "PD-completion — `resc` counts them).  Both are scored against the",
        "shared brute-force grid",
        "truth with the reference's own characteristic-function metrics",
        "(`dardel/benes_bernoulli/compute_errs.py:94-113`); metric means are",
        "taken over the trials where *both* engines stayed finite, so every",
        "comparison is paired.  `div` = divergent trials of 1000.",
        "Generated by `experiments/parity_markdown.py` from",
        "`experiments/SUMMARY_reference_parity.json`.",
        "",
    ]

    total = wins = ties = losses = 0
    div_ours_total = div_ref_total = rescued_total = 0
    for (mode, closure), rs in groups.items():
        rs = sorted(rs, key=lambda r: r["N"])
        lines.append(f"## {mode} × {closure}")
        lines.append("")
        lines.append(
            "| N | div ours | resc | div ref | cf_sup ours | cf_sup ref | "
            "cf_l1 ours | cf_l1 ref | mean_abs_err ours | mean_abs_err ref | verdict |"
        )
        lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
        for r in rs:
            o, e = r["ours"], r["ref"]
            total += 1
            div_ours_total += o["divergent"]
            div_ref_total += e["divergent"]
            rescued_total += o.get("rescued", 0)
            better = (
                o["divergent"] <= e["divergent"]
                and o["cf_sup"] <= e["cf_sup"] * (1 + args.rel_tol)
            )
            # Strictly better: matched accuracy with strictly fewer
            # divergences, or matched stability with strictly lower
            # CF error.
            strictly = better and (
                o["divergent"] < e["divergent"]
                or o["cf_sup"] < e["cf_sup"] * (1 - args.rel_tol)
            )
            if strictly:
                verdict = "**ours better**"
                wins += 1
            elif better:
                verdict = "parity"
                ties += 1
            else:
                verdict = "ref better"
                losses += 1
            lines.append(
                f"| {r['N']} | {o['divergent']} | {o.get('rescued', 0)} | "
                f"{e['divergent']} | "
                f"{fmt(o['cf_sup'])} | {fmt(e['cf_sup'])} | "
                f"{fmt(o['cf_l1'])} | {fmt(e['cf_l1'])} | "
                f"{fmt(o['mean_abs_err'])} | {fmt(e['mean_abs_err'])} | {verdict} |"
            )
        lines.append("")

    lines.append("## Totals")
    lines.append("")
    lines.append(
        f"- Cells: {total} — ours strictly better on {wins}, parity on "
        f"{ties}, reference better on {losses} "
        f"(tie band ±{args.rel_tol:.0%} on cf_sup)."
    )
    lines.append(
        f"- Divergent trials, summed over all cells: ours "
        f"{div_ours_total}, reference {div_ref_total} "
        f"(ours rescued {rescued_total} further trials that the fused "
        f"kernel alone would have lost)."
    )
    lines.append("")

    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {args.out}: {total} cells, {wins} wins / {ties} parity / "
          f"{losses} losses")


if __name__ == "__main__":
    main()
