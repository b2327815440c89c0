"""Convergence study: moment filter vs the exact Kalman filter on the
OU / Matérn-1/2 model, sweeping the moment order N.

Counterpart of reference ``dardel/convergence/convergence_mf.py``:
reports absolute mean/variance errors and the Gaussian KL divergence
per N, averaged over Monte-Carlo trials — all trials batched.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import math

import jax
import jax.numpy as jnp

from experiments import common
from mfs_tpu.ops.eigh import ENGINES

DT, T = 1e-1, 100
ELL, SIGMA, XI = 1.0, 0.5, 1.0
MEAN0, VAR0 = 0.0, SIGMA**2


def kalman_batch(ys):
    F = math.exp(-DT / ELL)
    Q = SIGMA**2 * (1 - math.exp(-2 * DT / ELL))

    def step(carry, y):
        mf, vf = carry
        mp, vp = F * mf, F * vf * F + Q
        s = vp + XI
        gain = vp / s
        mf = mp + gain * (y - mp)
        vf = vp - vp * gain
        return (mf, vf), (mf, vf)

    B = ys.shape[1]
    init = (MEAN0 * jnp.ones(B), VAR0 * jnp.ones(B))
    _, (mfs, vfs) = jax.lax.scan(step, init, ys)
    return mfs, vfs


def simulate(trials, seed):
    F = math.exp(-DT / ELL)
    Q = SIGMA**2 * (1 - math.exp(-2 * DT / ELL))
    key = jax.random.PRNGKey(seed)
    k0, ks, ko = jax.random.split(key, 3)
    x = MEAN0 + jnp.sqrt(VAR0) * jax.random.normal(k0, (trials,))
    steps = jax.random.normal(ks, (T, trials))
    noise = jax.random.normal(ko, (T, trials))

    def body(x, eps):
        x = F * x + math.sqrt(Q) * eps
        return x, x

    _, xs = jax.lax.scan(body, x, steps)
    return xs, xs + math.sqrt(XI) * noise


def main():
    p = common.base_parser(__doc__)
    p.add_argument("--Ns", type=int, nargs="*", default=[2, 3, 4, 6, 8, 10])
    # The reference sweeps both modes N=2..15
    # (``dardel/run_convergence_mf.sh:26-30``); the raw representation
    # loses the high-order information of a near-Gaussian posterior and
    # diverges at high N for ANY arithmetic (verified: our f64 refined
    # path fails identically), so ``central`` is the headline mode.
    p.add_argument("--mode", choices=["raw", "central"], default="central")
    p.add_argument("--eigh-impl", default="refined",
                   choices=list(ENGINES))
    p.add_argument("--pf-particles", type=int, nargs="*", default=[],
                   help="also run the particle-filter convergence foil at "
                        "these particle counts (reference "
                        "dardel/convergence/convergence_pf.py)")
    args = p.parse_args()
    common.setup(args)

    from mfs_tpu.one_dim.filtering import moment_filter_cms, moment_filter_rms
    from mfs_tpu.one_dim.moments import raw_to_central
    from mfs_tpu.utils.gaussian import normal_raw_moments_all

    xs, ys = simulate(args.trials, args.seed)
    kf_m, kf_v = kalman_batch(ys)
    rows = []

    meas = lambda y, x: jnp.exp(-0.5 * (y - x) ** 2 / XI) / jnp.sqrt(2 * jnp.pi * XI)

    # Exact LTI discretisation, like the reference's closed-form
    # ``raw_moment_of_normal(F x, Q)`` conditional moments
    # (``convergence_mf.py:86-113``): the transition density is exactly
    # N(F x, Q), so the only error left to measure is the moment
    # filter's own truncation at order 2N.
    F = math.exp(-DT / ELL)
    Q = SIGMA**2 * (1 - math.exp(-2 * DT / ELL))

    for N in args.Ns:
        def cond_rms(nodes, N=N):
            return normal_raw_moments_all(F * nodes, Q, 2 * N)

        def cond_cms(nodes, mean, N=N):
            return normal_raw_moments_all(F * nodes - mean, Q, 2 * N)

        cond_mean = lambda nodes: F * nodes

        rms0 = jnp.broadcast_to(
            normal_raw_moments_all(MEAN0, VAR0, 2 * N), (args.trials, 2 * N)
        )
        if args.mode == "raw":
            fn = jax.jit(
                lambda r0, y, f=cond_rms: moment_filter_rms(
                    f, meas, r0, y, eigh_impl=args.eigh_impl
                )
            )
            (rmss, nell), dt_run = common.timed_call(fn, rms0, ys)
            means = rmss[..., 1]
            variances = rmss[..., 2] - means**2
        else:
            cms0 = raw_to_central(rms0)
            mean0 = MEAN0 * jnp.ones(args.trials)
            fn = jax.jit(
                lambda c0, m0, y, f=cond_cms: moment_filter_cms(
                    f, cond_mean, meas, c0, m0, y,
                    eigh_impl=args.eigh_impl,
                )
            )
            (cmss, means, nell), dt_run = common.timed_call(fn, cms0, mean0, ys)
            variances = cmss[..., 2]
        # Divergent trials are counted and excluded, never averaged in
        # (the reference masks them in post-processing:
        # ``reproduce_paper_plots/plot_benes_bernoulli_errs_and_times.py:11-35``).
        finite = (
            jnp.isfinite(means).all(axis=0)
            & jnp.isfinite(variances).all(axis=0)
            & (variances > 0).all(axis=0)
        )
        abs_m = jnp.abs(means - kf_m)[:, finite]
        abs_v = jnp.abs(variances - kf_v)[:, finite]
        v_f, m_f = variances[:, finite], means[:, finite]
        kf_m_f, kf_v_f = kf_m[:, finite], kf_v[:, finite]
        kl = 0.5 * (
            jnp.log(kf_v_f / v_f) + (v_f + (m_f - kf_m_f) ** 2) / kf_v_f - 1.0
        )
        common.save_results(
            "convergence", f"mf_N{N}_{args.mode}_s{args.seed}",
            means=means, variances=variances, kf_m=kf_m, kf_v=kf_v, nell=nell,
            finite=finite,
        )
        row = dict(
            experiment="convergence", N=N, mode=args.mode,
            trials=args.trials,
            divergent=int(args.trials - finite.sum()),
            abs_mean_err=float(jnp.mean(abs_m)),
            abs_var_err=float(jnp.mean(abs_v)),
            gauss_kl=float(jnp.mean(kl)),
            wall_time_s=round(float(dt_run), 4),
        )
        rows.append(row)
        common.emit(row)

    # --- particle-filter convergence foil (reference
    # ``dardel/convergence/convergence_pf.py``): variance-optimal
    # proposal SMC vs the same exact KF, swept over particle counts.
    # One batched call per count — the reference runs 10k separate OS
    # processes; the per-step ``out_fn`` reduction keeps memory at
    # O(B x n) so 1000 trials x 1e4 particles fit on one chip.
    if args.pf_particles:
        from mfs_tpu.filters.resampling import stratified
        from mfs_tpu.filters.smc import particle_filter

        K_gain = Q / (Q + XI)
        prop_cov = Q - K_gain * Q

        def proposal_sampler(anc, y, key):
            m = F * anc + K_gain * (y - F * anc)
            return m + math.sqrt(prop_cov) * jax.random.normal(key, anc.shape)

        def proposal_density(x, anc, y):
            m = F * anc + K_gain * (y - F * anc)
            return jnp.exp(-0.5 * (x - m) ** 2 / prop_cov) / math.sqrt(
                2 * math.pi * prop_cov
            )

        def transition_density(x, anc):
            return jnp.exp(-0.5 * (x - F * anc) ** 2 / Q) / math.sqrt(
                2 * math.pi * Q
            )

        B = args.trials
        for npart in args.pf_particles:
            init_sampler = lambda key, n: MEAN0 + math.sqrt(
                VAR0
            ) * jax.random.normal(key, (B, n))
            fn = jax.jit(
                lambda y, key, n=npart: particle_filter(
                    proposal_sampler, proposal_density, transition_density,
                    meas, y, init_sampler, key, n, stratified,
                    out_fn=lambda s: (
                        jnp.mean(s, axis=-1), jnp.var(s, axis=-1)
                    ),
                )
            )
            (pf_m, pf_v), dt_run = common.timed_call(
                fn, ys, jax.random.PRNGKey(args.seed + 7)
            )
            finite = (
                jnp.isfinite(pf_m).all(axis=0)
                & jnp.isfinite(pf_v).all(axis=0)
                & (pf_v > 0).all(axis=0)
            )
            m_f, v_f = pf_m[:, finite], pf_v[:, finite]
            kf_m_f, kf_v_f = kf_m[:, finite], kf_v[:, finite]
            kl = 0.5 * (
                jnp.log(kf_v_f / v_f)
                + (v_f + (m_f - kf_m_f) ** 2) / kf_v_f
                - 1.0
            )
            common.save_results(
                "convergence", f"pf_{npart}_s{args.seed}",
                means=pf_m, variances=pf_v, finite=finite,
                kf_m=kf_m, kf_v=kf_v,
            )
            row = dict(
                experiment="convergence", method="pf", nparticles=npart,
                trials=B,
                divergent=int(B - finite.sum()),
                abs_mean_err=float(jnp.mean(jnp.abs(m_f - kf_m_f))),
                abs_var_err=float(jnp.mean(jnp.abs(v_f - kf_v_f))),
                gauss_kl=float(jnp.mean(kl)),
                wall_time_s=round(float(dt_run), 4),
            )
            rows.append(row)
            common.emit(row)

    import json

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "SUMMARY_convergence.json")
    # Merge with rows from other modes so raw/central invocations
    # accumulate into one committed artifact.
    old_rows = []
    if os.path.exists(out):
        try:
            with open(out) as f:
                old_rows = json.load(f).get("rows", [])
        except Exception:
            old_rows = []
    key_of = lambda r: (r.get("N"), r.get("mode"), r.get("nparticles"))
    mine = {key_of(r) for r in rows}
    keep = [r for r in old_rows if key_of(r) not in mine]
    with open(out, "w") as f:
        json.dump(
            dict(
                protocol="OU/Matern-1/2 vs exact KF, exact LTI transition "
                         "moments (closed-form normal, like the reference), "
                         f"T={T}, dt={DT}, batched trials "
                         "(reference dardel/convergence/convergence_mf.py, "
                         "run_convergence_mf.sh:26-30 sweeps both modes)",
                eigh_impl=args.eigh_impl,
                seed=args.seed, rows=keep + rows,
            ),
            f, indent=1,
        )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
