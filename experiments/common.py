"""Shared experiment utilities.

The reference farms Monte-Carlo trials to Slurm array tasks keyed by a
pre-generated ``rng_keys.npy`` file (reference:
``dardel/generate_rng_key.py:1-12``, ``dardel/benes_bernoulli/mf.py:74``).
Here the reproducibility protocol is ``jax.random.fold_in`` on a single
experiment seed — the whole trial ensemble lives in one process and one
device mesh, so per-trial key files are unnecessary; ``trial_keys``
reproduces any trial subset deterministically.
"""
import argparse
import json
import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mfs_tpu.config import enable_compile_cache

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "results")


def trial_keys(seed: int, num_trials: int) -> jax.Array:
    """Deterministic per-trial PRNG keys: fold_in(seed_key, trial_id)."""
    base = jax.random.PRNGKey(seed)
    return jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(num_trials))


def save_results(experiment: str, name: str, **arrays) -> str:
    out_dir = os.path.join(RESULTS_DIR, experiment)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return path


def load_results(experiment: str, name: str):
    return np.load(os.path.join(RESULTS_DIR, experiment, f"{name}.npz"))


def run_chunked(
    experiment: str,
    name: str,
    trials: int,
    chunk: int,
    run_chunk,
    trial_axes: Optional[dict] = None,
    sum_keys: tuple = (),
):
    """Resumable chunked Monte-Carlo sweep.

    ``run_chunk(trial_lo, n) -> dict`` computes trials
    ``[trial_lo, trial_lo + n)``; each chunk is persisted as
    ``<name>.part<k>.npz`` and *skipped on re-run* if the file exists,
    so a crashed sweep resumes at chunk granularity (the batch-first
    counterpart of the reference's one-npz-per-trial Slurm protocol,
    ``dardel/benes_bernoulli/mf.py:83-92``).  After all chunks exist
    they are merged into ``<name>.npz`` (concatenated along
    ``trial_axes.get(key, 0)``; 0-d entries are summed when listed in
    ``sum_keys``, else taken from the last chunk) and the part files
    are removed.

    Chunk results must be reproducible per trial id (use
    ``model.simulate_trials`` / ``trial_keys``) for the merge to be
    independent of the chunk size.
    """
    out_dir = os.path.join(RESULTS_DIR, experiment)
    os.makedirs(out_dir, exist_ok=True)
    final = os.path.join(out_dir, f"{name}.npz")
    bounds = [(lo, min(chunk, trials - lo)) for lo in range(0, trials, chunk)]
    if os.path.exists(final):
        return dict(np.load(final)), final

    parts = []
    for ci, (lo, n) in enumerate(bounds):
        ppath = os.path.join(out_dir, f"{name}.part{ci}.npz")
        if os.path.exists(ppath):
            parts.append(dict(np.load(ppath)))
            continue
        out = {k: np.asarray(v) for k, v in run_chunk(lo, n).items()}
        tmp = ppath + ".tmp.npz"
        np.savez_compressed(tmp, **out)
        os.replace(tmp, ppath)
        parts.append(out)

    merged = {}
    for k in parts[0]:
        if parts[0][k].ndim == 0:
            vals = [p[k] for p in parts]
            merged[k] = np.sum(vals) if k in sum_keys else vals[-1]
        else:
            ax = (trial_axes or {}).get(k, 0)
            merged[k] = np.concatenate([p[k] for p in parts], axis=ax)
    tmp = final + ".tmp.npz"
    np.savez_compressed(tmp, **merged)
    os.replace(tmp, final)
    for ci in range(len(bounds)):
        ppath = os.path.join(out_dir, f"{name}.part{ci}.npz")
        if os.path.exists(ppath):
            os.remove(ppath)
    return merged, final


def timed_call(fn, *args, warmup: bool = True):
    """The reference's timing protocol: one warm-up call (compile), then
    wall clock around a blocked call (``dardel/time_profile/mf.py:83-106``)."""
    if warmup:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def timed_call_time_chunked(fn, state, ys, chunk, traj_idx, warmup=True):
    """Run a scan-over-time filter as several bounded device dispatches.

    A single XLA execution covering a long scan (e.g. T=2000 at 2D N=5)
    can run for minutes; splitting the time axis into equal chunks keeps
    each dispatch short while compiling exactly once (all chunks share
    one shape).

    ``fn(*state, ys_chunk)`` must return a tuple whose entries listed in
    ``traj_idx`` are time-major trajectories; the next chunk's carry is
    their final time slice, in order (the moment filters' state is
    exactly the last (moments, mean[, scale]) row).  Every other entry
    (the nell) accumulates additively across chunks.
    """
    T = ys.shape[0]
    if chunk <= 0 or chunk >= T:
        return timed_call(fn, *state, ys, warmup=warmup)
    if T % chunk:
        raise ValueError(f"chunk {chunk} must divide T {T}")
    assert len(state) == len(traj_idx)

    def run(st):
        parts = []
        for i in range(0, T, chunk):
            out = fn(*st, ys[i:i + chunk])
            st = tuple(out[k][-1] for k in traj_idx)
            parts.append(out)
        return parts

    if warmup:
        jax.block_until_ready(fn(*state, ys[:chunk]))
    t0 = time.perf_counter()
    parts = run(state)
    jax.block_until_ready(parts)
    dt = time.perf_counter() - t0
    merged = tuple(
        jnp.concatenate([p[k] for p in parts], axis=0)
        if k in traj_idx
        else sum(p[k] for p in parts)
        for k in range(len(parts[0]))
    )
    return merged, dt


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trials", type=int, default=100)
    p.add_argument("--x64", action="store_true", default=True)
    p.add_argument("--platform", type=str, default=None, help="cpu/gpu override")
    return p


def setup(args) -> None:
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.x64:
        jax.config.update("jax_enable_x64", True)
    # Persistent compilation cache: the sweeps re-launch one process per
    # (mode, closure) group and re-compile the same per-N programs;
    # caching them on disk turns every re-run/resume into a cache hit.
    enable_compile_cache()


def hardware() -> str:
    """The device the run's arrays land on, for summary records."""
    devices = jax.devices()
    return f"{len(devices)} x {devices[0].device_kind} ({devices[0].platform})"


def emit(record: dict) -> None:
    print(json.dumps(record))
