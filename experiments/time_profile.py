"""Wall-clock profile of the three filter families on Beneš–Bernoulli.

Counterpart of reference ``dardel/time_profile/{mf,ghf,pf}.py`` and
``run_time_profile.sh``: per method, exclude the compile run, time
jitted calls with ``block_until_ready``, and report per-trial cost.
The moment filter additionally reports the batched-ensemble throughput
(the batched execution model); GHF and the bootstrap PF are timed both
singly and vmapped over trials for a like-for-like comparison.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import jax
import jax.numpy as jnp

from experiments import common
from mfs_tpu.ops.eigh import ENGINES


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--N", type=int, default=15)
    p.add_argument("--gh-order", type=int, default=11)
    p.add_argument("--particles", type=int, default=10_000)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--eigh-impl", default="refined",
                   choices=list(ENGINES))
    args = p.parse_args()
    common.setup(args)

    from mfs_tpu.filters.gaussian import sgp_filter
    from mfs_tpu.filters.resampling import stratified
    from mfs_tpu.filters.sigma_points import SigmaPoints
    from mfs_tpu.filters.smc import bootstrap_filter
    from mfs_tpu.models import benes_bernoulli
    from mfs_tpu.one_dim.filtering import moment_filter_rms
    from mfs_tpu.sde import sde_cond_moments_tme_normal
    from mfs_tpu.sde import tme

    N, B = args.N, args.trials
    model = benes_bernoulli(N=N)
    key_sim, key_meas, key_pf = jax.random.split(jax.random.PRNGKey(args.seed), 3)
    xss = model.simulate(key_sim, min(B, 16))
    probs = model.emission(jnp.tile(xss, (B // xss.shape[0] + 1, 1))[:B])
    ys = jax.random.bernoulli(key_meas, probs).astype(probs.dtype).T  # (T, B)

    def timeit(fn, *a):
        jax.block_until_ready(fn(*a))
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*a))
            best = min(best, time.perf_counter() - t0)
        return best

    # --- moment filter (batched ensemble) ---
    trans = sde_cond_moments_tme_normal(model.drift, model.dispersion, model.dt, 2, N)
    rms0 = jnp.broadcast_to(model.init_cond.rms, (B, 2 * N))
    mf = jax.jit(
        lambda r0, y: moment_filter_rms(
            trans.rms, model.measurement_cond_pdf, r0, y,
            stable=True, eigh_impl=args.eigh_impl,
        )
    )
    t_mf = timeit(mf, rms0, ys)
    common.emit(
        dict(method=f"moment_filter_N{N}_{args.eigh_impl}", trials=B, wall_time_s=round(t_mf, 4),
             per_trial_ms=round(t_mf / B * 1e3, 4))
    )

    # --- Gauss–Hermite filter (vmapped ensemble) ---
    sgps = SigmaPoints.gauss_hermite(d=1, order=args.gh_order)

    def cond_m_cov(x, dt):
        m, v = tme.mean_and_var_1d(x[0], dt, model.drift, model.dispersion, 2)
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
    ghf = jax.jit(lambda ys_b: jax.vmap(ghf_one, in_axes=1)(ys_b))
    t_ghf = timeit(ghf, ys)
    common.emit(
        dict(method=f"ghf_gh{args.gh_order}", trials=B, wall_time_s=round(t_ghf, 4),
             per_trial_ms=round(t_ghf / B * 1e3, 4))
    )

    # --- bootstrap particle filter (vmapped ensemble) ---
    def transition_sampler(samples, key):
        m, v = tme.mean_and_var_1d(samples, model.dt, model.drift, model.dispersion, 2)
        return m + jnp.sqrt(v) * jax.random.normal(key, samples.shape)

    # The PF ensemble is capped: (T, trials, particles) trajectories are
    # materialised by the filter output, so 1024 x 10k particles would
    # need terabytes; 16 trials suffice for a stable per-trial time.
    B_pf = min(B, 16)

    def init_sampler(key, n):
        return model.init_cond.sampler(key, B_pf * n).reshape(B_pf, n)

    pf = jax.jit(
        lambda ys_b: bootstrap_filter(
            transition_sampler, model.measurement_cond_pdf, ys_b,
            init_sampler, key_pf, args.particles, stratified,
        )[1]
    )
    t_pf = timeit(pf, ys[:, :B_pf])
    common.emit(
        dict(method=f"bootstrap_pf_{args.particles}", trials=B_pf,
             wall_time_s=round(t_pf, 4), per_trial_ms=round(t_pf / B_pf * 1e3, 4))
    )


if __name__ == "__main__":
    main()
