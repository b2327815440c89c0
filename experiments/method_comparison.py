"""Method-comparison accuracy: GHF and bootstrap PF scored against the
brute-force grid truth with the same CF metrics as the moment filter.

The other half of the reference's Fig 4: ``dardel/benes_bernoulli/{ghf,pf}.py`` run the Gauss-Hermite
filter (gh=11) and the bootstrap particle filter (10k particles,
stratified) on the same trials as the moment filter, and
``compute_errs.py:94-113`` scores all three with sup/L1/L2
characteristic-function distances against the grid truth plus absolute
mean errors.  This script is the batched counterpart: it loads the
measurement sequences from an ours-side sweep cell
(``experiments/benes_bernoulli.py`` npz — all cells share identical
trials for a given seed), runs both baselines over the whole ensemble,
and emits one record per method into
``experiments/SUMMARY_method_comparison.json``.

CF conventions: GHF is a Gaussian, so its CF is exp(izm - z^2 v / 2);
the PF CF is the empirical ensemble CF mean_j exp(iz x_j) (what the
reference's ``pf.py`` stores).  Truth CF and metrics reuse
``experiments/compute_errors.py`` and the cached grid truth.

Usage (after at least one benes_bernoulli.py cell exists):
    python experiments/method_comparison.py --trials 1000
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json

import jax
import jax.numpy as jnp
import numpy as np

from experiments import common
from experiments.benes_bernoulli import cell_name
from experiments.compute_errors import brute_force_truth


def _truth_cached(seed, yss, grid_n, substeps):
    cache = os.path.join(
        common.RESULTS_DIR, "benes_bernoulli", f"truth_s{seed}_{yss.shape[0]}.npz"
    )
    if os.path.exists(cache):
        data = np.load(cache)
        return jnp.asarray(data["pss"]), jnp.asarray(data["xs_grid"])
    pss, xs_grid = brute_force_truth(jnp.asarray(yss), grid_n=grid_n,
                                     substeps=substeps)
    np.savez(cache, pss=np.asarray(pss), xs_grid=np.asarray(xs_grid))
    return pss, xs_grid


def _true_cf_and_mean(pss, xs_grid, zs, chunk=64):
    """(trials, T, z) true CF (re, im) by trapezoid + (trials, T) means.

    Real cos/sin arithmetic: two real contractions, no complex dtype.
    """
    dx = xs_grid[1] - xs_grid[0]
    tw = jnp.full_like(xs_grid, dx).at[0].mul(0.5).at[-1].mul(0.5)
    ang = zs[:, None] * xs_grid  # (z, grid)
    cos_p, sin_p = jnp.cos(ang) * tw, jnp.sin(ang) * tw

    fn = jax.jit(lambda ps: (
        jnp.einsum("zg,btg->btz", cos_p, ps),
        jnp.einsum("zg,btg->btz", sin_p, ps),
        jnp.einsum("g,btg->bt", xs_grid * tw, ps),
    ))
    res, ims, means = [], [], []
    for s0 in range(0, pss.shape[0], chunk):
        re, im, m = fn(pss[s0:s0 + chunk])
        res.append(re)
        ims.append(im)
        means.append(m)
    return (
        jnp.concatenate(res, axis=0),
        jnp.concatenate(ims, axis=0),
        jnp.concatenate(means, axis=0),
    )


def _metrics(cf_est, cf_true, est_means, true_means, finite, zs):
    """Reference compute_errs metrics, meaned over finite trials and T.

    ``cf_est``/``cf_true`` are (re, im) pairs of (trials, T, z) arrays.
    """
    diff = jnp.sqrt(
        (cf_est[0] - cf_true[0]) ** 2 + (cf_est[1] - cf_true[1]) ** 2
    )  # (trials, T, z)
    dz = zs[1] - zs[0]
    sup_e = jnp.max(diff, axis=-1)
    l1_e = jnp.sum(diff, axis=-1) * dz
    l2_e = jnp.sqrt(jnp.sum(diff**2, axis=-1) * dz)
    mean_err = jnp.abs(est_means - true_means)
    mask = np.asarray(finite, dtype=bool)
    return dict(
        divergent=int(mask.shape[0] - mask.sum()),
        cf_sup=float(jnp.mean(sup_e[mask])),
        cf_l1=float(jnp.mean(l1_e[mask])),
        cf_l2=float(jnp.mean(l2_e[mask])),
        mean_abs_err=float(jnp.mean(mean_err[mask])),
    )


def run_ghf(model, ys, gh_order):
    """Batched Gauss-Hermite filter -> (trials, T) means/vars + nell."""
    from mfs_tpu.filters.gaussian import sgp_filter
    from mfs_tpu.filters.sigma_points import SigmaPoints
    from mfs_tpu.sde import tme

    sgps = SigmaPoints.gauss_hermite(d=1, order=gh_order)

    def cond_m_cov(x, dt):
        m, v = tme.mean_and_var_1d(x[0], dt, model.drift, model.dispersion, 3)
        return m[None], v[None, None]

    def meas_m_cov(x):
        p = model.emission(x[0])
        return p[None], (p * (1 - p))[None, None]

    ghf_one = lambda y: sgp_filter(
        cond_m_cov, meas_m_cov, sgps,
        jnp.array([model.init_cond.mean]),
        jnp.array([[model.init_cond.variance]]),
        model.dt, y[:, None],
    )
    mfs, vfs, nell = jax.jit(
        lambda ys_b: jax.vmap(ghf_one, in_axes=1)(ys_b)
    )(ys)
    return mfs[..., 0], vfs[..., 0, 0], nell  # (trials, T), (trials, T)


def run_pf_chunk(model, ys_chunk, key, particles, zs):
    """Bootstrap PF on one trial chunk -> means + empirical CF.

    Returns ((chunk, T) means, (chunk, T, z) CF, (chunk,) nell).  The
    CF is accumulated from the particle cloud per step as separate
    cos/sin ensemble means (real f64 throughout).
    """
    from mfs_tpu.filters.resampling import stratified
    from mfs_tpu.filters.smc import bootstrap_filter
    from mfs_tpu.sde import tme

    B = ys_chunk.shape[1]

    def transition_sampler(samples, k):
        m, v = tme.mean_and_var_1d(samples, model.dt, model.drift,
                                   model.dispersion, 3)
        return m + jnp.sqrt(v) * jax.random.normal(k, samples.shape)

    def init_sampler(k, n):
        return model.init_cond.sampler(k, B * n).reshape(B, n)

    samples, nell = bootstrap_filter(
        transition_sampler, model.measurement_cond_pdf, ys_chunk,
        init_sampler, key, particles, stratified,
    )  # (T, B, n)
    means = jnp.mean(samples, axis=-1)  # (T, B)

    # Empirical CF without materialising (T, B, particles, z): map over
    # time steps and scan over z-blocks, so the live tensor is
    # (B, particles, z_block) — ~200 MB instead of ~80 GB.
    z_block = 50
    zs_blocks = zs.reshape(-1, z_block)

    def cf_step(s_t):  # (B, particles)
        def one_block(_, z_blk):
            ang = s_t[..., None] * z_blk  # (B, particles, z_block)
            return _, (jnp.mean(jnp.cos(ang), axis=-2),
                       jnp.mean(jnp.sin(ang), axis=-2))

        _, (re, im) = jax.lax.scan(one_block, 0, zs_blocks)
        # (n_blocks, B, z_block) -> (B, z)
        return (
            jnp.moveaxis(re, 0, 1).reshape(s_t.shape[0], -1),
            jnp.moveaxis(im, 0, 1).reshape(s_t.shape[0], -1),
        )

    cf_re, cf_im = jax.lax.map(cf_step, samples)  # (T, B, z)
    return (
        jnp.swapaxes(means, 0, 1),
        jnp.swapaxes(cf_re, 0, 1),
        jnp.swapaxes(cf_im, 0, 1),
        nell,
    )


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--cell-N", type=int, default=8,
                   help="which sweep cell's npz supplies the trials")
    p.add_argument("--cell-mode", default="raw")
    p.add_argument("--cell-closure", default="tme")
    p.add_argument("--impl-suffix", default="", help="npz suffix of the ours-side cell")
    p.add_argument("--gh-order", type=int, default=11)
    p.add_argument("--particles", type=int, default=10_000)
    p.add_argument("--pf-chunk", type=int, default=50)
    p.add_argument("--grid-n", type=int, default=2000)
    p.add_argument("--substeps", type=int, default=100)
    p.add_argument("--z-n", type=int, default=400)
    args = p.parse_args()
    common.setup(args)

    from mfs_tpu.models import benes_bernoulli

    cell = cell_name(args.cell_N, args.cell_mode, args.cell_closure, args.seed)
    ours = common.load_results("benes_bernoulli", cell + args.impl_suffix)
    yss = jnp.asarray(ours["yss"])[: args.trials]  # (trials, T)
    xss = jnp.asarray(ours["xss"])[: args.trials]
    trials = yss.shape[0]
    ys = jnp.swapaxes(yss, 0, 1)  # (T, trials)

    model = benes_bernoulli(N=2)
    zs = jnp.linspace(-2.0, 2.0, args.z_n)

    pss, xs_grid = _truth_cached(args.seed, yss, args.grid_n, args.substeps)
    true_re, true_im, true_means = _true_cf_and_mean(pss, xs_grid, zs)
    cf_true = (true_re, true_im)

    rows = []

    # --- GHF ---
    (ghf_m, ghf_v, ghf_nell), t_ghf = common.timed_call(
        lambda: run_ghf(model, ys, args.gh_order)
    )
    # Gaussian CF exp(izm - z^2 v / 2), as a real (re, im) pair.
    amp = jnp.exp(-0.5 * ghf_v[..., None] * zs**2)
    ang = ghf_m[..., None] * zs
    cf_ghf = (amp * jnp.cos(ang), amp * jnp.sin(ang))
    finite = np.isfinite(np.asarray(ghf_m)).all(axis=1)
    row = dict(method=f"ghf_gh{args.gh_order}", trials=trials,
               wall_time_s=round(float(t_ghf), 4),
               **_metrics(cf_ghf, cf_true, ghf_m, true_means, finite, zs))
    rows.append(row)
    common.emit(row)

    # --- bootstrap PF (chunked over trials) ---
    key_pf = jax.random.PRNGKey(args.seed + 1)
    pf_means, pf_res, pf_ims, t_pf = [], [], [], 0.0
    run = jax.jit(
        lambda y, k: run_pf_chunk(model, y, k, args.particles, zs)
    )
    for s0 in range(0, trials, args.pf_chunk):
        k = jax.random.fold_in(key_pf, s0)
        (m, cf_re, cf_im, _), dt_c = common.timed_call(
            run, ys[:, s0:s0 + args.pf_chunk], k, warmup=(s0 == 0)
        )
        t_pf += dt_c
        pf_means.append(m)
        pf_res.append(cf_re)
        pf_ims.append(cf_im)
    pf_m = jnp.concatenate(pf_means, axis=0)
    pf_cf = (jnp.concatenate(pf_res, axis=0), jnp.concatenate(pf_ims, axis=0))
    finite = np.isfinite(np.asarray(pf_m)).all(axis=1)
    row = dict(method=f"bootstrap_pf_{args.particles}", trials=trials,
               wall_time_s=round(float(t_pf), 4),
               **_metrics(pf_cf, cf_true, pf_m, true_means, finite, zs))
    rows.append(row)
    common.emit(row)

    out = dict(
        protocol=(
            f"Benes-Bernoulli T=100, {trials} MC trials (shared with the "
            f"moment-filter sweep, seed {args.seed}); GHF gh={args.gh_order} "
            f"TME-3; bootstrap PF {args.particles} particles, stratified, "
            f"TME-3 proposal; errors vs brute-force grid truth "
            f"(grid {args.grid_n} on [-6,6], chapman-tme-3, "
            f"{args.substeps} substeps; CF on z in [-2,2], {args.z_n} pts). "
            f"Counterpart of dardel/benes_bernoulli/{{ghf,pf}}.py + "
            f"compute_errs.py:94-113."
        ),
        hardware=common.hardware(),
        rows=rows,
    )
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "SUMMARY_method_comparison.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
