"""Run the REFERENCE's own moment filters on our exact trials.

The parity audit: import
``mfs.one_dim.filtering.moment_filter_{rms,cms,scms}`` from a checkout
of the reference (``--reference``) and run them — CPU, f64, the reference's own
defaults (``stable=False``, TME order 3 per
``dardel/benes_bernoulli/mf.py:21``) — on the *identical* measurement
sequences our sweep produced (loaded from the
``experiments/benes_bernoulli.py`` npz files), so divergence counts and
accuracy can be compared side by side with nothing varying but the
filter engine.  The transition-moment callables are this repo's
factories wrapped in the reference's signatures (the reference's own
factories need the external ``tme`` package, absent here; ours are
validated against exact LTI discretisation in
``tests/test_one_dim_moments.py``), so both engines consume identical
model inputs.

Run AFTER the ours-side sweep:
    python experiments/reference_parity.py --reference PATH/TO/mfs \
        --Ns 2 .. 15 --modes raw central scaled --closures tme tme-normal --trials 1000

Chunk-resumable per cell; writes ``refcode_N{N}_{mode}_{closure}_s{seed}.npz``.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from experiments import common
from experiments.benes_bernoulli import cell_name


def _ref_filters(ref_path):
    if ref_path not in sys.path:
        sys.path.insert(0, ref_path)
    from mfs.one_dim.filtering import (  # noqa: E402
        moment_filter_cms,
        moment_filter_rms,
        moment_filter_scms,
    )

    return moment_filter_rms, moment_filter_cms, moment_filter_scms


def run_ref_cell(ref_path, N, mode, closure, trials, seed, chunk=None,
                 tme_order=3, impl_suffix="", stable=False):
    from mfs_tpu.models import benes_bernoulli
    from mfs_tpu.sde import sde_cond_moments_tme, sde_cond_moments_tme_normal

    ref_rms, ref_cms, ref_scms = _ref_filters(ref_path)
    chunk = chunk or trials
    model = benes_bernoulli(N=N)
    factory = (
        sde_cond_moments_tme_normal if closure == "tme-normal" else sde_cond_moments_tme
    )
    trans = factory(model.drift, model.dispersion, model.dt, tme_order, N)
    ic = model.init_cond

    ours = common.load_results(
        "benes_bernoulli", cell_name(N, mode, closure, seed) + impl_suffix
    )
    yss_all = jnp.asarray(ours["yss"])  # (trials, T)
    if yss_all.shape[0] < trials:
        raise ValueError(
            f"ours-side npz has {yss_all.shape[0]} trials < {trials}"
        )

    meas = model.measurement_cond_pdf

    if mode == "raw":
        def one(ys_one):
            rmss, nell = ref_rms(
                lambda x, p: trans.rms(x), meas, ic.rms, ys_one, stable=stable
            )
            return rmss, rmss[:, 1], rmss[:, 2] - rmss[:, 1] ** 2, nell
    elif mode == "central":
        def one(ys_one):
            cmss, means, nell = ref_cms(
                lambda x, o, m: trans.cms(x, m), trans.mean, meas,
                ic.cms, ic.mean, ys_one, stable=stable,
            )
            return cmss, means, cmss[:, 2], nell
    else:  # scaled
        def one(ys_one):
            scmss, means, scales, nell = ref_scms(
                lambda x, o, m, s: trans.scms(x, m, s), trans.mean_var, meas,
                ic.scms, ic.mean, jnp.sqrt(ic.variance), ys_one, stable=stable,
            )
            return scmss, means, scales**2, nell

    fn = jax.jit(jax.vmap(one))

    def run_chunk(lo, n):
        mss, means, variances, nell = fn(yss_all[lo:lo + n])
        # (n, T, ...) -> (T, n, ...): the ours-side npz layout.
        mss = jnp.swapaxes(mss, 0, 1)
        means = jnp.swapaxes(means, 0, 1)
        variances = jnp.swapaxes(variances, 0, 1)
        finite = jnp.isfinite(mss.reshape(mss.shape[0], n, -1)).all(axis=(0, 2))
        return dict(
            moments=mss, means=means, variances=variances, nell=nell,
            finite=finite,
        )

    return common.run_chunked(
        "benes_bernoulli",
        f"refcode_N{N}_{mode}_{closure}_s{seed}",
        trials, chunk, run_chunk,
        trial_axes={"moments": 1, "means": 1, "variances": 1},
    )


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--reference", required=True,
                   help="checkout of the reference library (holds mfs/)")
    p.add_argument("--Ns", type=int, nargs="+", default=list(range(2, 16)))
    p.add_argument("--modes", nargs="+", default=["raw", "central", "scaled"])
    p.add_argument("--closures", nargs="+", default=["tme", "tme-normal"])
    p.add_argument("--tme-order", type=int, default=3)
    p.add_argument("--chunk", type=int, default=250)
    p.add_argument("--impl-suffix", default="", help="ours-side npz suffix")
    p.add_argument("--stable", action="store_true",
                   help="reference stable=True (its experiment default is False)")
    args = p.parse_args()
    common.setup(args)

    for mode in args.modes:
        for closure in args.closures:
            for N in args.Ns:
                out, path = run_ref_cell(
                    args.reference, N, mode, closure, args.trials, args.seed,
                    chunk=args.chunk, tme_order=args.tme_order,
                    impl_suffix=args.impl_suffix, stable=args.stable,
                )
                common.emit(
                    dict(
                        experiment="reference_parity", N=N, mode=mode,
                        closure=closure, trials=args.trials,
                        divergent=int(args.trials - out["finite"].sum()),
                        saved=path,
                    )
                )


if __name__ == "__main__":
    main()
