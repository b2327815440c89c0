"""Beneš–Bernoulli Monte-Carlo filtering sweep (flagship experiment).

Batched counterpart of reference ``dardel/benes_bernoulli/mf.py`` +
``run_benes_bernoulli_mf.sh``: instead of one OS process per trial, the
whole ensemble runs as one batched scan; N / mode / closure sweeps are
plain loops over jitted programs.  Trials are processed in resumable
chunks (``common.run_chunked``): each chunk's data depends only on
(seed, trial id), a crashed sweep resumes at chunk granularity, and the
merged npz is identical for any chunk size.

Usage:
    python experiments/benes_bernoulli.py --trials 1000 --Ns 3 5 8 11 15 \
        --mode raw --closure tme-normal
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from experiments import common
from mfs_tpu.ops.eigh import ENGINES


def cell_name(N, mode, closure, seed, eigh_impl="refined"):
    name = f"mf_N{N}_{mode}_{closure}_s{seed}"
    if eigh_impl != "refined":
        name += f"_{eigh_impl}"
    return name


def run_cell(N, mode, closure, trials, seed, chunk=None, stable=True,
             tme_order=2, eigh_impl="refined", rescue=True):
    from mfs_tpu.models import benes_bernoulli
    from mfs_tpu.one_dim.filtering import (
        moment_filter_cms,
        moment_filter_rms,
        moment_filter_scms,
    )
    from mfs_tpu.parallel.ensemble import rescue_diverged
    from mfs_tpu.sde import sde_cond_moments_tme, sde_cond_moments_tme_normal

    chunk = chunk or trials
    model = benes_bernoulli(N=N)
    factory = (
        sde_cond_moments_tme_normal if closure == "tme-normal" else sde_cond_moments_tme
    )
    trans = factory(model.drift, model.dispersion, model.dt, tme_order, N)
    key_sim, key_meas = jax.random.split(jax.random.PRNGKey(seed))
    ic = model.init_cond

    trial_axes = {
        "moments": 1, "means": 1, "variances": 1, "scales": 1, "nell": 0,
    }

    def make_run(impl, device=None):
        def run(ys_in):
            if device is not None:
                ys_in = jax.device_put(jnp.asarray(ys_in), device)
            ctx = (
                jax.default_device(device)
                if device is not None
                else contextlib.nullcontext()
            )
            with ctx:
                return _run_inner(impl, ys_in)

        return run

    def _run_inner(impl, ys_in):
            n = ys_in.shape[1]
            if mode == "raw":
                rms0 = jnp.broadcast_to(ic.rms, (n, 2 * N))
                fn = jax.jit(
                    lambda r0, y: moment_filter_rms(
                        trans.rms, model.measurement_cond_pdf, r0, y,
                        stable=stable, eigh_impl=impl,
                    )
                )
                (mss, nell), dt_run = common.timed_call(fn, rms0, ys_in)
                means = mss[..., 1]
                variances = mss[..., 2] - means**2
                out = dict(moments=mss, means=means, variances=variances,
                           nell=nell)
            elif mode == "central":
                cms0 = jnp.broadcast_to(ic.cms, (n, 2 * N))
                fn = jax.jit(
                    lambda c0, y: moment_filter_cms(
                        trans.cms, trans.mean, model.measurement_cond_pdf, c0,
                        ic.mean * jnp.ones(n), y, stable=stable,
                        eigh_impl=impl,
                    )
                )
                (mss, means, nell), dt_run = common.timed_call(fn, cms0, ys_in)
                out = dict(moments=mss, means=means, variances=mss[..., 2],
                           nell=nell)
            else:  # scaled
                scms0 = jnp.broadcast_to(ic.scms, (n, 2 * N))
                fn = jax.jit(
                    lambda s0, y: moment_filter_scms(
                        trans.scms, trans.mean_var, model.measurement_cond_pdf,
                        s0, ic.mean * jnp.ones(n),
                        jnp.sqrt(ic.variance) * jnp.ones(n),
                        y, stable=stable, eigh_impl=impl,
                    )
                )
                (mss, means, scales, nell), dt_run = common.timed_call(
                    fn, scms0, ys_in
                )
                out = dict(moments=mss, means=means, variances=scales**2,
                           nell=nell, scales=scales)
            out["_dt"] = dt_run
            return out

    def finite_fn(out):
        mss = out["moments"]
        return np.asarray(
            jnp.isfinite(mss.reshape(mss.shape[0], mss.shape[1], -1)).all(
                axis=(0, 2)
            )
        )

    def run_chunk(lo, n):
        ids = jnp.arange(lo, lo + n)
        xss = model.simulate_trials(key_sim, ids)  # (n, T)
        meas_keys = jax.vmap(lambda i: jax.random.fold_in(key_meas, i))(ids)
        yss = jax.vmap(
            lambda k, x: jax.random.bernoulli(k, model.emission(x))
        )(meas_keys, xss).astype(xss.dtype)
        ys = jnp.swapaxes(yss, 0, 1)  # (T, n)

        wall = dict(t=0.0)

        def timed(run):
            def wrapped(ys_in):
                out = run(ys_in)
                wall["t"] += out.pop("_dt")
                return out

            return wrapped

        fast = timed(make_run(eigh_impl))
        if rescue:
            # Robustness: re-run only the diverged trials with native-f64
            # LAPACK eigh + LDL PD-completion on the host CPU (see
            # ``mfs_tpu.parallel.ensemble.rescue_diverged``).
            robust = timed(make_run("xla", device=jax.devices("cpu")[0]))
            out, finite, rescued = rescue_diverged(
                fast, robust, ys, finite_fn, trial_axes
            )
        else:
            out = fast(ys)
            finite = finite_fn(out)
            rescued = 0

        out.update(
            xss=xss, yss=yss, finite=finite, wall_time=wall["t"],
            rescued=rescued,
        )
        return out

    return common.run_chunked(
        "benes_bernoulli", cell_name(N, mode, closure, seed, eigh_impl),
        trials, chunk, run_chunk,
        trial_axes={"moments": 1, "means": 1, "variances": 1, "scales": 1,
                    "nell": 0},
        sum_keys=("wall_time", "rescued"),
    )


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--Ns", type=int, nargs="+", default=[3, 5, 8, 11, 15])
    p.add_argument("--mode", choices=["raw", "central", "scaled"], default="raw")
    p.add_argument("--closure", choices=["tme", "tme-normal"], default="tme-normal")
    p.add_argument("--tme-order", type=int, default=2)
    p.add_argument("--no-stable", action="store_true")
    p.add_argument("--no-rescue", action="store_true")
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--eigh-impl", default="refined",
                   choices=list(ENGINES))
    args = p.parse_args()
    common.setup(args)

    for N in args.Ns:
        out, path = run_cell(
            N, args.mode, args.closure, args.trials, args.seed,
            chunk=args.chunk, stable=not args.no_stable,
            tme_order=args.tme_order, eigh_impl=args.eigh_impl,
            rescue=not args.no_rescue,
        )
        common.emit(
            dict(
                experiment="benes_bernoulli", N=N, mode=args.mode,
                closure=args.closure, trials=args.trials,
                divergent=int(args.trials - out["finite"].sum()),
                rescued=int(out.get("rescued", 0)),
                wall_time_s=round(float(out["wall_time"]), 4),
                trials_per_sec=round(args.trials / float(out["wall_time"]), 2),
                saved=path,
            )
        )


if __name__ == "__main__":
    main()
