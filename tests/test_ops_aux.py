"""Auxiliary ops: FLOP accounting, SMC options."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfs_tpu.ops.flops import count_flops


def test_count_flops_matmul_and_scan():
    r = count_flops(lambda a, b: a @ b, jnp.ones((4, 8)), jnp.ones((8, 16)))
    assert r["total"] == 2 * 4 * 16 * 8
    g = lambda x: jax.lax.scan(
        lambda c, _: (c * 2.0 + 1.0, None), x, None, length=10
    )[0]
    r = count_flops(g, jnp.ones(5))
    assert r["total"] == 100
    assert not r["unknown_primitives"]


@pytest.mark.parametrize(
    "prim, flops",
    [
        # 3 matrices of 4x4: n^3/3, n^2 per rhs column (4 columns), 9 n^3
        ("cholesky", 3 * 64 / 3),
        ("triangular_solve", 3 * 16 * 4),
        ("eigh", 3 * 9 * 64),
    ],
)
def test_count_flops_batched_linalg(prim, flops):
    a = jnp.broadcast_to(jnp.eye(4) * 2.0, (3, 4, 4))
    fn = {
        "cholesky": jax.lax.linalg.cholesky,
        "triangular_solve": lambda m: jax.lax.linalg.triangular_solve(
            m, m, left_side=True, lower=True
        ),
        "eigh": jax.lax.linalg.eigh,
    }[prim]
    r = count_flops(fn, a)
    assert not r["unknown_primitives"]
    assert r["breakdown"]["linalg[float64]"] == flops


def test_count_flops_enters_filter_step():
    """The full filter on the default ``refined`` engine traces with no
    unknown primitives and a plausible per-trial count (the engine's
    f32 eigh seed and f64 polish both show in the per-dtype split)."""
    from mfs_tpu.models import benes_bernoulli
    from mfs_tpu.one_dim.filtering import moment_filter_cms
    from mfs_tpu.sde import sde_cond_moments_tme_normal

    N, B, T = 4, 8, 3
    model = benes_bernoulli(N=N)
    trans = sde_cond_moments_tme_normal(
        model.drift, model.dispersion, model.dt, 2, N
    )
    ic = model.init_cond
    fn = lambda c0, m0, y: moment_filter_cms(
        trans.cms, trans.mean, model.measurement_cond_pdf, c0, m0, y,
        eigh_impl="refined",
    )
    r = count_flops(
        fn,
        jnp.broadcast_to(ic.cms, (B, 2 * N)),
        ic.mean * jnp.ones(B),
        jnp.zeros((T, B)),
    )
    assert not r["unknown_primitives"]
    assert r["f32"] > 0 and r["f64"] > 0
    # scan multiplies: doubling T doubles the total
    r2 = count_flops(
        fn,
        jnp.broadcast_to(ic.cms, (B, 2 * N)),
        ic.mean * jnp.ones(B),
        jnp.zeros((2 * T, B)),
    )
    np.testing.assert_allclose(r2["total"], 2 * r["total"], rtol=1e-6)


def test_bootstrap_remat_chunk_unchanged_forward():
    """remat_chunk must not change the filter's outputs (same keys,
    same scan semantics, only the autodiff residual layout differs)."""
    from mfs_tpu.filters.resampling import stratified
    from mfs_tpu.filters.smc import bootstrap_filter

    B, n, T = 3, 64, 20
    key = jax.random.PRNGKey(0)
    ys = jax.random.normal(jax.random.PRNGKey(1), (T, B))

    trans = lambda x, k: 0.9 * x + 0.3 * jax.random.normal(k, x.shape)
    pdf = lambda y, x: jnp.exp(-0.5 * (y - x) ** 2) / np.sqrt(2 * np.pi)
    init = lambda k, ns: jax.random.normal(k, (B, ns))

    s1, nell1 = bootstrap_filter(trans, pdf, ys, init, key, n, stratified)
    s2, nell2 = bootstrap_filter(
        trans, pdf, ys, init, key, n, stratified, remat_chunk=5
    )
    np.testing.assert_allclose(np.asarray(nell1), np.asarray(nell2), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-12)

    # gradient flows through the remat path (continuous resampling)
    def nell_of(theta):
        tr = lambda x, k: theta * x + 0.3 * jax.random.normal(k, x.shape)
        _, nell = bootstrap_filter(
            tr, pdf, ys, init, key, n, None,
            conti_resampling=True, remat_chunk=5,
        )
        return jnp.sum(nell)

    g = jax.grad(nell_of)(jnp.asarray(0.9))
    assert np.isfinite(float(g))


def test_particle_filter_out_fn_reduction():
    from mfs_tpu.filters.resampling import stratified
    from mfs_tpu.filters.smc import particle_filter

    B, n, T = 2, 32, 10
    key = jax.random.PRNGKey(0)
    ys = jax.random.normal(jax.random.PRNGKey(1), (T, B))
    prop = lambda anc, y, k: 0.8 * anc + 0.2 * y + 0.3 * jax.random.normal(
        k, anc.shape
    )
    dens = lambda x, anc, y: jnp.exp(-0.5 * ((x - 0.8 * anc - 0.2 * y) / 0.3) ** 2)
    tdens = lambda x, anc: jnp.exp(-0.5 * ((x - 0.8 * anc) / 0.3) ** 2)
    pdf = lambda y, x: jnp.exp(-0.5 * (y - x) ** 2)
    init = lambda k, ns: jax.random.normal(k, (B, ns))

    full = particle_filter(prop, dens, tdens, pdf, ys, init, key, n, stratified)
    red = particle_filter(
        prop, dens, tdens, pdf, ys, init, key, n, stratified,
        out_fn=lambda s: (jnp.mean(s, axis=-1), jnp.var(s, axis=-1)),
    )
    np.testing.assert_allclose(
        np.asarray(red[0]), np.asarray(jnp.mean(full, axis=-1)), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(red[1]), np.asarray(jnp.var(full, axis=-1)), rtol=1e-10
    )
