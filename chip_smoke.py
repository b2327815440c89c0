"""Smoke run of mfs-tpu on an NVIDIA GPU: the main path, end to end.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # only the sharded path on 4 cards

One process holds the card from start to end; the plain reference runs
on the same process's CPU device (LAPACK f64 ``eigh_impl="xla"``,
``stable=True``).  Phases:

1. device: refuses anything but a GPU, prints the card's name and
   power limit;
2. flagship: Beneš–Bernoulli N=15 (moments to order 29), T=100,
   B=4096 trials, TME-2 Normal closure, central mode, f64, default
   engine with the LDL completion (``stable=True``, as the reference's
   own filters run); compile and run times apart; then 256 trials (and
   the same batch at N=8) against the CPU reference;
3. convergence: one trial at N in {3, 5, 8, 11} against the brute-force
   grid filter;
4. gradient: ``value_and_grad`` of the mean nell in per-trial drift
   and emission parameters (N=15, B=1024) against a central difference;
5. 2D: prey-predator N=8 (s=36), B=256, T=200 against the CPU
   reference on 32 trials.

Everything runs in f64, where XLA computes no matrix product in TF32;
the only f32 work is the eigh seed of the default ``refined`` engine,
a solver call rather than a matrix product.  Every number goes on a
line before the last.  The last line is the JSON contract, printed only
when every phase passed; otherwise the exit code is 1.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mfs_tpu.config import enable_compile_cache  # noqa: E402
from mfs_tpu.models import benes_bernoulli  # noqa: E402
from mfs_tpu.one_dim.filtering import moment_filter_cms  # noqa: E402
from mfs_tpu.sde import sde_cond_moments_tme_normal  # noqa: E402

N_FLAGSHIP, B_FLAGSHIP = 15, 4096
B_REF = 256  # flagship trials re-run on the CPU reference
B_GRAD = 1024
N_2D, B_2D, T_2D, B_2D_REF = 8, 256, 200, 32

# Tolerances.  Relative nell difference against the CPU LAPACK f64
# reference, on trials finite on both sides:
# - N=15: the Hankel matrices are near the edge of f64 (condition
#   ~1e13); the default engine's f32-seeded polish and LAPACK agree to
#   ~1e-12 on most trials but a few ill-conditioned ones move by up to
#   ~1e-7, so the median is held to 1e-6.
# - N=8: well conditioned, so every trial is held to 1e-9.
# - 2D N=8: the s=36 operators have repeated eigenvalues; the median
#   is held to 1e-6.
TOL_FLAGSHIP_MEDIAN = 1e-6
TOL_N8_MAX = 1e-9
TOL_2D_MEDIAN = 1e-6
# Divergent trials: the GPU may lose at most 1% more than the CPU.
FINITE_SLACK = 0.01
# Convergence: grid-truth RMSE must fall with N and be this small at
# N=11 (reference points N=3 ~0.1, N=11 ~2e-4).
TOL_CONVERGENCE_N11 = 1e-3
# Gradient against a central difference with step FD_EPS (f64), trial
# by trial.  At N=15 the nell is only piecewise smooth at the f64 edge:
# a few trials in a hundred switch an LDL pivot clamp or carry ~1e-9
# of noise within the step, and their difference quotients are off by
# up to O(1) (measured on the CPU at B=32: median 1e-6, max 2.6).  So
# the median trial is held to TOL_GRAD; the mean gradient would be
# dominated by those few.
FD_EPS = 1e-4
TOL_GRAD = 1e-5
# The check needs each trial finite at five parameter points; each
# evaluation may lose ~0.5% of N=15 trials (flagship finite_frac 0.997
# on the GPU), so at least 90% must survive all five.
MIN_GRAD_FINITE = 0.9
# Two programs that compute the same N=15 trials but differ in shapes
# (sharded against single-device runs, where the per-device batch and
# so cuSOLVER's batched algorithm and the reduction order change; shared
# against per-trial parameters) may differ in the last bits, which the
# Hankel conditioning amplifies: measured 2.2e-9 relative on the mean
# gradient for the shared/per-trial pair on the CPU.
TOL_SAME_TRIALS = 1e-6


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def require_gpu(devices):
    """Exit non-zero unless JAX's devices are GPUs; never fall back."""
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"{os.path.basename(sys.argv[0])}: needs a GPU, but JAX found "
            f"platform {platform!r} ({devices})"
        )


def contract_line(devices):
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
    })


def card_name_and_power_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def peak_bytes(device):
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def compile_and_run(fn, *args, reps=3):
    """AOT-compile ``fn`` for ``args``; return (out, compile_s, run_s)
    with run_s the median of ``reps`` calls ending in block_until_ready."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        runs.append(time.perf_counter() - t0)
    return out, compile_s, float(np.median(runs))


def on_cpu(fn, *args):
    """The plain reference: ``fn`` jitted on this process's CPU device."""
    cpu = jax.devices("cpu")[0]
    args = [jax.device_put(np.asarray(a), cpu) for a in args]
    with jax.default_device(cpu):
        return jax.block_until_ready(jax.jit(fn)(*args))


def rel_diff(a, b):
    return np.abs(a - b) / np.abs(b)


# ---- workloads -----------------------------------------------------------


def flagship_problem(N, B, seed):
    """The Beneš–Bernoulli ensemble: (model, trans, cms0, mean0, ys)."""
    model = benes_bernoulli(N=N)
    trans = sde_cond_moments_tme_normal(
        model.drift, model.dispersion, model.dt, 2, N
    )
    key_x, key_y = jax.random.split(jax.random.PRNGKey(seed))
    xs = model.simulate(key_x, B)  # (B, T)
    ys = jax.random.bernoulli(key_y, model.emission(xs)).astype(xs.dtype).T
    ic = model.init_cond
    cms0 = jnp.broadcast_to(ic.cms, (B, 2 * N))
    mean0 = jnp.full((B,), ic.mean, dtype=cms0.dtype)
    return model, trans, cms0, mean0, ys


def cms_filter(model, trans, **kw):
    def run(cms0, mean0, ys):
        return moment_filter_cms(
            trans.cms, trans.mean, model.measurement_cond_pdf,
            cms0, mean0, ys, **kw,
        )
    return run


def finite_trials(cmss, nell):
    return np.asarray(jnp.isfinite(cmss[-1]).all(-1) & jnp.isfinite(nell))


def param_nell(model, N, cms0, mean0):
    """Per-trial nell as a function of (theta, gamma): the drift
    ``theta * tanh(x)`` and the emission sharpness ``gamma`` of the
    Beneš–Bernoulli model (true values 1, 1)."""
    def nell_of(params, ys):
        # scalars shared by all trials, or (B,) vectors, one per trial
        theta, gamma = (jnp.asarray(p)[..., None] for p in params)
        trans = sde_cond_moments_tme_normal(
            lambda x: theta * jnp.tanh(x), model.dispersion, model.dt, 2, N
        )

        def pdf(y, x):
            p = 1.0 / (1.0 + jnp.exp(-gamma * x**3 / 5.0))
            return jnp.where(y == 1, p, 1.0 - p)

        b = ys.shape[1]
        _, _, nell = moment_filter_cms(
            trans.cms, trans.mean, pdf, cms0[:b], mean0[:b], ys, stable=True
        )
        return nell
    return nell_of


def per_trial_grad(model, N, cms0, mean0):
    """``value_and_grad`` of the mean nell in per-trial drift and
    emission parameters, the step of a per-trial MLE: trial i's
    parameters touch only trial i's nell, so a diverged trial's nan
    stays in its own entries.  (params, ys) -> ((mean nell, nell),
    grads)."""
    nell_of = param_nell(model, N, cms0, mean0)
    loss = lambda p, y: (lambda nell: (jnp.mean(nell), nell))(nell_of(p, y))
    return jax.value_and_grad(loss, has_aux=True)


def fd_points(p, i):
    """``p`` moved by +-FD_EPS in its i-th entry."""
    hi = tuple(q + FD_EPS if j == i else q for j, q in enumerate(p))
    lo = tuple(q - FD_EPS if j == i else q for j, q in enumerate(p))
    return hi, lo


# ---- phases ----------------------------------------------------------------


def compare_with_reference(label, nell_dev, finite_dev, nell_ref,
                           tol_median=None, tol_max=None):
    nell_ref = np.asarray(nell_ref)
    finite_ref = np.isfinite(nell_ref)
    both = finite_dev & finite_ref
    rel = rel_diff(np.asarray(nell_dev)[both], nell_ref[both])
    print(f"{label}: gpu finite_frac={finite_dev.mean()} "
          f"cpu finite_frac={finite_ref.mean()} jointly finite={both.sum()} "
          f"rel nell diff max={rel.max()} median={np.median(rel)}")
    check(finite_dev.mean() >= finite_ref.mean() - FINITE_SLACK,
          f"{label}: GPU lost more than {FINITE_SLACK} of trials")
    if tol_median is not None:
        check(np.median(rel) <= tol_median,
              f"{label}: median rel diff {np.median(rel)} > {tol_median}")
    if tol_max is not None:
        check(rel.max() <= tol_max,
              f"{label}: max rel diff {rel.max()} > {tol_max}")


def phase_flagship(args, dev):
    for N in (N_FLAGSHIP, 8):
        model, trans, cms0, mean0, ys = flagship_problem(N, B_FLAGSHIP, args.seed)
        (cmss, _, nell), compile_s, run_s = compile_and_run(
            cms_filter(model, trans, stable=True), cms0, mean0, ys
        )
        finite = finite_trials(cmss, nell)
        print(f"flagship N={N} T={ys.shape[0]} B={B_FLAGSHIP}: "
              f"compile_s={compile_s} run_s={run_s} "
              f"trials_per_s={B_FLAGSHIP / run_s} finite_frac={finite.mean()} "
              f"peak_bytes_in_use={peak_bytes(dev)}")
        _, _, nell_ref = on_cpu(
            cms_filter(model, trans, stable=True, eigh_impl="xla"),
            cms0[:B_REF], mean0[:B_REF], ys[:, :B_REF],
        )
        if N == N_FLAGSHIP:
            compare_with_reference(
                f"flagship N={N} vs CPU reference ({B_REF} trials)",
                nell[:B_REF], finite[:B_REF], nell_ref,
                tol_median=TOL_FLAGSHIP_MEDIAN,
            )
        else:
            compare_with_reference(
                f"flagship N={N} vs CPU reference ({B_REF} trials)",
                nell[:B_REF], finite[:B_REF], nell_ref, tol_max=TOL_N8_MAX,
            )


def phase_convergence(args, dev):
    from mfs_tpu.filters.grid import brute_force_filter

    model = benes_bernoulli(N=3)
    xs = model.simulate(jax.random.PRNGKey(args.seed), 1)[0]
    ys = jax.random.bernoulli(
        jax.random.PRNGKey(args.seed + 1), model.emission(xs)
    ).astype(xs.dtype)
    ic = model.init_cond
    # Truth: brute-force grid filter on [-6, 6], 2000 points, 100
    # Chapman substeps per step, from the Gaussian-mixture initial law.
    grid = jnp.linspace(-6.0, 6.0, 2000)
    ps0 = ic.pdf(grid)
    ps0 = ps0 / jnp.trapezoid(ps0, grid)
    pss = brute_force_filter(
        model.drift, model.dispersion, model.measurement_cond_pdf,
        ps0, grid, ys, model.dt, integration_steps=100,
        pred_method="chapman-tme-3",
    )
    true_mean = jnp.trapezoid(pss * grid, grid, axis=-1)
    true_var = jnp.trapezoid(pss * grid**2, grid, axis=-1) - true_mean**2

    rmses = []
    for N in (3, 5, 8, 11):
        m = benes_bernoulli(N=N)
        trans = sde_cond_moments_tme_normal(m.drift, m.dispersion, m.dt, 3, N)
        cmss, means, _ = jax.jit(cms_filter(m, trans))(
            m.init_cond.cms, m.init_cond.mean, ys
        )
        r_mean = float(jnp.sqrt(jnp.mean((means - true_mean) ** 2)))
        r_var = float(jnp.sqrt(jnp.mean((cmss[:, 2] - true_var) ** 2)))
        rmses.append((r_mean, r_var))
        print(f"convergence N={N}: mean RMSE={r_mean} variance RMSE={r_var}")
    for i, name in enumerate(("mean", "variance")):
        seq = [r[i] for r in rmses]
        check(all(np.isfinite(seq)), f"convergence: non-finite {name} RMSE")
        check(all(a > b for a, b in zip(seq, seq[1:])),
              f"convergence: {name} RMSE does not fall with N: {seq}")
        check(seq[-1] <= TOL_CONVERGENCE_N11,
              f"convergence: {name} RMSE {seq[-1]} at N=11 > {TOL_CONVERGENCE_N11}")


def phase_gradient(args, dev):
    """``per_trial_grad`` at N=15, B=1024 against a central difference."""
    N = N_FLAGSHIP
    model, _, cms0, mean0, ys = flagship_problem(N, B_GRAD, args.seed + 2)
    pv = tuple(jnp.ones(B_GRAD) for _ in range(2))
    ((_, nell), grad), compile_s, run_s = compile_and_run(
        per_trial_grad(model, N, cms0, mean0), pv, ys
    )
    f = jax.jit(param_nell(model, N, cms0, mean0))
    steps = [fd_points(pv, i) for i in range(len(pv))]
    shifted = [[np.asarray(f(p, ys)) for p in pair] for pair in steps]
    keep = np.isfinite(np.asarray(nell)) & np.all(np.isfinite(shifted), axis=(0, 1))
    keep &= np.all([np.isfinite(np.asarray(g)) for g in grad], axis=0)
    print(f"gradient N={N} T={ys.shape[0]} B={B_GRAD}: compile_s={compile_s} "
          f"run_s={run_s} trials_per_s={B_GRAD / run_s} finite at p and at "
          f"every difference point={keep.sum()} mean nell there="
          f"{np.asarray(nell)[keep].mean()} peak_bytes_in_use={peak_bytes(dev)}")
    check(keep.mean() >= MIN_GRAD_FINITE,
          f"gradient: only {keep.sum()} trials finite")
    for i, name in enumerate(("theta", "gamma")):
        g = np.asarray(grad[i])[keep] * B_GRAD  # d nell_i / d param_i
        fd = (shifted[i][0] - shifted[i][1])[keep] / (2 * FD_EPS)
        rel = rel_diff(g, fd)
        print(f"gradient d/d{name}: mean over trials autodiff={g.mean()} "
              f"central difference={fd.mean()}; per-trial rel diff median="
              f"{np.median(rel)} 90th percentile={np.percentile(rel, 90)} "
              f"max={rel.max()}")
        check(np.median(rel) <= TOL_GRAD,
              f"gradient d/d{name}: median rel diff {np.median(rel)} > {TOL_GRAD}")


def phase_2d(args, dev):
    from mfs_tpu.models import prey_predator
    from mfs_tpu.multi_dims import (
        generate_graded_lexico_multi_indices,
        gram_and_hankel_indices_graded_lexico,
        moment_filter_nd_cms,
        poly_tme_nd,
    )

    mis = generate_graded_lexico_multi_indices(2, 2 * N_2D - 1)
    inds = gram_and_hankel_indices_graded_lexico(N_2D, 2)
    model = prey_predator(mis)
    poly = poly_tme_nd(
        model.drift, model.dispersion, model.dt, 2, mis,
        drift_deg=2, dispersion_deg=1,
    )
    _, _, yss = model.simulate(jax.random.PRNGKey(args.seed + 3), B_2D)
    ys = yss[:T_2D]
    ic = model.init_cond
    cms0 = jnp.broadcast_to(ic.cms, (B_2D,) + ic.cms.shape)
    mean0 = jnp.broadcast_to(ic.mean, (B_2D, 2))

    def run(cms0, mean0, ys, **kw):
        return moment_filter_nd_cms(
            poly.cms, poly.mean, model.measurement_cond_pdf, ys,
            (mis, inds), cms0, mean0, predict_fn=poly.predict_cms, **kw,
        )

    (cmss, _, nell), compile_s, run_s = compile_and_run(run, cms0, mean0, ys)
    finite = finite_trials(cmss, nell)
    print(f"2D prey-predator N={N_2D} s={inds.shape[1]} T={T_2D} B={B_2D}: "
          f"compile_s={compile_s} run_s={run_s} trials_per_s={B_2D / run_s} "
          f"finite_frac={finite.mean()} peak_bytes_in_use={peak_bytes(dev)}")
    _, _, nell_ref = on_cpu(
        lambda c, m, y: run(c, m, y, stable=True, eigh_impl="xla"),
        cms0[:B_2D_REF], mean0[:B_2D_REF], ys[:, :B_2D_REF],
    )
    compare_with_reference(
        f"2D N={N_2D} vs CPU reference ({B_2D_REF} trials)",
        nell[:B_2D_REF], finite[:B_2D_REF], nell_ref,
        tol_median=TOL_2D_MEDIAN,
    )


def on_one_card_in_chunks(fn, device, n, args, axes):
    """``fn`` on one device over ``n`` equal chunks of the trials, the
    shapes each card of the mesh sees.  ``axes`` gives each argument's
    trial axis (None: passed whole).  Returns (outputs per chunk,
    compile_s, median run_s of one chunk)."""
    B = next(jax.tree.leaves(a)[0].shape[ax] for a, ax in zip(args, axes)
             if ax is not None)
    b = B // n

    def chunk(a, ax, i):
        return a if ax is None else jax.tree.map(
            lambda x: jax.lax.slice_in_dim(x, i * b, (i + 1) * b, axis=ax), a
        )

    chunks = [jax.device_put(tuple(chunk(a, ax, i) for a, ax in zip(args, axes)), device)
              for i in range(n)]
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*chunks[0]).compile()
    compile_s = time.perf_counter() - t0
    outs, runs = [], []
    for c in chunks:
        t0 = time.perf_counter()
        outs.append(jax.block_until_ready(compiled(*c)))
        runs.append(time.perf_counter() - t0)
    return outs, compile_s, float(np.median(runs))


def phase_four_cards(args, devices):
    """Flagship at 4x4096 trials and the sharded gradient at 4x1024 on a
    1-D trial mesh, each against one device running the same trials in
    the per-card chunks (the per-card shapes, so both sides run the same
    batched solvers)."""
    from mfs_tpu.parallel.ensemble import run_ensemble_filter, sharded_nell_grad
    from mfs_tpu.parallel.mesh import trial_mesh

    mesh = trial_mesh(devices=devices)
    n = len(devices)
    one = devices[0]
    N = N_FLAGSHIP

    def landed_on_every_card(x, label):
        shards = x.addressable_shards
        cards = {s.device for s in shards}
        print(f"{label}: {len(shards)} shards of {[s.data.shape for s in shards]} "
              f"on {sorted(str(c) for c in cards)}")
        check(cards == set(devices), f"{label}: trials not on all {n} cards")

    B = n * B_FLAGSHIP
    model, trans, cms0, mean0, ys = flagship_problem(N, B, args.seed)
    filt = cms_filter(model, trans, stable=True)
    sharded = lambda init, y: filt(*init, y)  # one object: jit caches it
    times = []
    for _ in range(2):  # the first call compiles
        t0 = time.perf_counter()
        cmss_sh, _, nell_sh = jax.block_until_ready(
            run_ensemble_filter(sharded, (cms0, mean0), ys, mesh)
        )
        times.append(time.perf_counter() - t0)
    first_s, run_s = times
    landed_on_every_card(nell_sh, "sharded flagship nell")
    outs, compile_1, run_1 = on_one_card_in_chunks(
        filt, one, n, (cms0, mean0, ys), (0, 0, 1)
    )
    cmss_1 = jnp.concatenate([o[0] for o in outs], axis=1)
    nell_1 = jnp.concatenate([o[2] for o in outs])
    fin_sh = finite_trials(cmss_sh, nell_sh)
    fin_1 = finite_trials(cmss_1, nell_1)
    both = fin_sh & fin_1
    rel = rel_diff(np.asarray(nell_sh)[both], np.asarray(nell_1)[both])
    print(f"four cards flagship N={N} B={B}: sharded first call (compile+run) "
          f"s={first_s} run_s={run_s} trials_per_s={B / run_s}; one card, "
          f"{n} chunks of {B // n}: compile_s={compile_1} run_s per chunk={run_1} "
          f"trials_per_s={B / (n * run_1)}; finite_frac sharded={fin_sh.mean()} "
          f"one card={fin_1.mean()}; rel nell diff max={rel.max()}")
    check(abs(fin_sh.mean() - fin_1.mean()) <= 1.0 / B_FLAGSHIP,
          "four cards: finite fractions differ")
    check(rel.max() <= TOL_SAME_TRIALS, f"four cards: rel nell diff {rel.max()}")

    # The gradient: per-trial parameters, so a trial that diverges in the
    # gradient program (at N=15 not always one that diverged in the
    # forward filter) leaves nan only in its own entries.  The one-card
    # side is the gradient phase's own program on each per-card chunk.
    Bg = n * B_GRAD
    model, _, cms0, mean0, ys = flagship_problem(N, Bg, args.seed + 2)
    pv = tuple(jnp.ones(Bg) for _ in range(2))
    t0 = time.perf_counter()
    # sharded_nell_grad jits a fresh closure on every call, so a second
    # call would only time another compile: the one call is timed.
    v_sh, g_sh = jax.block_until_ready(
        sharded_nell_grad(param_nell(model, N, cms0, mean0), pv, ys, mesh)
    )
    first_s = time.perf_counter() - t0
    landed_on_every_card(g_sh[0], "sharded per-trial gradient")
    outs, compile_1, run_1 = on_one_card_in_chunks(
        per_trial_grad(model, N, cms0[:B_GRAD], mean0[:B_GRAD]), one, n,
        (pv, ys), (0, 1),
    )
    nell_1 = np.concatenate([np.asarray(o[0][1]) for o in outs])
    v_1 = nell_1.mean()
    # d nell_i / d param_i on each side (each side's mean has its own 1/B)
    g_sh = np.stack([np.asarray(g) * Bg for g in g_sh])
    g_1 = np.stack([np.concatenate([np.asarray(o[1][k]) for o in outs])
                    for k in range(2)]) * B_GRAD
    fin_sh = np.isfinite(g_sh).all(0)
    fin_1 = np.isfinite(g_1).all(0)
    both = fin_sh & fin_1
    rel = rel_diff(g_sh[:, both], g_1[:, both])
    print(f"four cards sharded_nell_grad N={N} B={Bg}: sharded call "
          f"(compile+run) s={first_s}; one card, {n} chunks: compile_s="
          f"{compile_1} run_s per chunk={run_1}; mean nell sharded={float(v_sh)} "
          f"one card={v_1}; trials with finite gradient sharded={fin_sh.sum()} "
          f"one card={fin_1.sum()}; per-trial gradient rel diff median="
          f"{np.median(rel)} max={rel.max()}")
    check(both.mean() >= MIN_GRAD_FINITE, f"four cards: only {both.sum()} "
          "trials with a finite gradient")
    check(abs(fin_sh.mean() - fin_1.mean()) <= FINITE_SLACK,
          "four cards: finite gradient fractions differ")
    check(np.isclose(float(v_sh), v_1, rtol=TOL_SAME_TRIALS, atol=0, equal_nan=True),
          "four cards: mean nell differs")
    check(np.median(rel) <= TOL_SAME_TRIALS,
          f"four cards: median per-trial gradient rel diff {np.median(rel)}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded path on 4 GPUs")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    print(f"jax {jax.__version__} devices: {devices}")
    print(f"device_kind={devices[0].device_kind} count={len(devices)}")
    print(f"card (name, power limit): {card_name_and_power_limit()}")
    print(f"compile cache: {enable_compile_cache()}")

    if args.four_cards:
        check(len(devices) >= 4, f"--four-cards needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        phases = [("four cards", lambda: phase_four_cards(args, devices))]
    else:
        dev = devices[0]
        phases = [
            (name, (lambda fn=fn: fn(args, dev)))
            for name, fn in (
                ("flagship", phase_flagship),
                ("convergence", phase_convergence),
                ("gradient", phase_gradient),
                ("2D", phase_2d),
            )
        ]

    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception:  # reported below; the run then exits 1
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(contract_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
