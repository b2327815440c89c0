"""Flagship throughput: Beneš–Bernoulli N=15 moment filter on one GPU.

Workload (reference ``dardel/time_profile/mf.py:83-108``): the 1D Beneš
SDE with Bernoulli measurements, T=100 steps, moment order 2N-1 = 29
(N=15), TME-2 Normal-closure transitions, f64, central-moment
representation, default engine with ``stable=True``.  The metric is
Monte-Carlo *trials per second* for the full filtering pass (compile
excluded, ``block_until_ready`` timed), printed as one JSON line that
names the device it ran on.  Refuses to run anywhere but a GPU.

    python bench.py            # BENCH_BATCH=4096 trials by default
"""
import json
import os

import jax

from chip_smoke import (
    card_name_and_power_limit,
    cms_filter,
    compile_and_run,
    finite_trials,
    flagship_problem,
    require_gpu,
)
from mfs_tpu.config import enable_compile_cache

N = 15
BATCH = int(os.environ.get("BENCH_BATCH", "4096"))


def main():
    devices = jax.devices()
    require_gpu(devices)
    enable_compile_cache()
    model, trans, cms0, mean0, ys = flagship_problem(N, BATCH, seed=0)
    (cmss, _, nell), compile_s, run_s = compile_and_run(
        cms_filter(model, trans, stable=True), cms0, mean0, ys
    )
    print(json.dumps({
        "metric": f"benes_bernoulli_N{N}_T{ys.shape[0]}_f64_trials_per_sec",
        "value": BATCH / run_s,
        "unit": "trials/s",
        "finite_frac": float(finite_trials(cmss, nell).mean()),
        "compile_s": compile_s,
        "batch": BATCH,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": card_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()
