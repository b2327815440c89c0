"""On-GPU checks of the engines and filters against the CPU (marker: gpu).

Run on a machine with a GPU with

    MFS_TESTS_GPU=1 python -m pytest tests/test_gpu_hardware.py -m gpu

Elsewhere every test skips: the fixture below looks for a GPU when a
test runs (the CPU suite forces the cpu backend in conftest unless
MFS_TESTS_GPU=1).  ``chip_smoke.py`` covers the same ground at the
flagship sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mfs_tpu.models import benes_bernoulli
from mfs_tpu.one_dim.filtering import moment_filter_cms
from mfs_tpu.one_dim.quadrature import moment_quadrature
from mfs_tpu.ops.eigh import ENGINES
from mfs_tpu.sde import sde_cond_moments_tme_normal
from mfs_tpu.utils.gaussian import normal_raw_moments_all

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"no GPU visible (JAX platform {device.platform!r})")
    return device


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def _on(device, fn, *args):
    args = [jax.device_put(np.asarray(a), device) for a in args]
    with jax.default_device(device):
        return jax.block_until_ready(jax.jit(fn)(*args))


def _benes(N, B, T, seed=0):
    model = benes_bernoulli(N=N)
    trans = sde_cond_moments_tme_normal(
        model.drift, model.dispersion, model.dt, 2, N
    )
    xs = model.simulate(jax.random.PRNGKey(seed), B)[:, :T]
    ys = jax.random.bernoulli(
        jax.random.PRNGKey(seed + 1), model.emission(xs)
    ).astype(xs.dtype).T
    ic = model.init_cond
    return model, trans, jnp.broadcast_to(ic.cms, (B, 2 * N)), ic.mean * jnp.ones(B), ys


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_on_gpu_matches_cpu_lapack(engine, gpu, cpu):
    """N=15, B=1024 mixture moments: each engine on the GPU against
    LAPACK f64 on the CPU.  At N=15 the Hankel matrices' condition
    (~1e13) lets two f64 Cholesky factorisations differ in the ninth
    digit: the worst node difference measured on an H100 was 1.6e-9,
    so the bound is 1e-8."""
    N, B = 15, 1024
    rng = np.random.RandomState(0)
    mu = rng.randn(B) * 0.3
    var = 0.5 + rng.rand(B)
    ms = 0.6 * normal_raw_moments_all(mu, var, 2 * N) + 0.4 * normal_raw_moments_all(
        mu + 0.3, var * 0.8, 2 * N
    )
    w, x = _on(gpu, lambda m: moment_quadrature(m, sort_nodes=True, eigh_impl=engine), ms)
    w_r, x_r = _on(cpu, lambda m: moment_quadrature(m, sort_nodes=True, eigh_impl="xla"), ms)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_r), rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_r), rtol=0, atol=1e-8)


def test_filter_on_gpu_matches_cpu_reference(gpu, cpu):
    model, trans, cms0, mean0, ys = _benes(N=8, B=128, T=100)

    def run(c, m, y, **kw):
        return moment_filter_cms(
            trans.cms, trans.mean, model.measurement_cond_pdf, c, m, y,
            stable=True, **kw,
        )[2]

    nell = np.asarray(_on(gpu, run, cms0, mean0, ys))
    ref = np.asarray(_on(cpu, lambda c, m, y: run(c, m, y, eigh_impl="xla"), cms0, mean0, ys))
    assert np.isfinite(nell).all() and np.isfinite(ref).all()
    assert np.max(np.abs(nell - ref) / np.abs(ref)) < 1e-9


def test_gradient_on_gpu_vs_finite_difference(gpu):
    """Gradient of the summed nell in the drift parameter at N=8, where
    the nell is smooth, against an f64 central difference."""
    model, _, cms0, mean0, ys = _benes(N=8, B=64, T=30)

    def nell_of(theta):
        trans = sde_cond_moments_tme_normal(
            lambda u: theta * jnp.tanh(u), model.dispersion, model.dt, 2, 8
        )
        _, _, nell = moment_filter_cms(
            trans.cms, trans.mean, model.measurement_cond_pdf, cms0, mean0, ys,
            stable=True,
        )
        return jnp.sum(nell)

    with jax.default_device(gpu):
        g = float(jax.jit(jax.grad(nell_of))(jnp.asarray(1.0)))
        f = jax.jit(nell_of)
        eps = 1e-5
        fd = (float(f(jnp.asarray(1.0 + eps))) - float(f(jnp.asarray(1.0 - eps)))) / (2 * eps)
    assert abs(g - fd) / abs(fd) < 1e-5, (g, fd)


def test_2d_filter_on_gpu_matches_cpu_reference(gpu, cpu):
    from mfs_tpu.models import prey_predator
    from mfs_tpu.multi_dims import (
        generate_graded_lexico_multi_indices,
        gram_and_hankel_indices_graded_lexico,
        moment_filter_nd_cms,
        poly_tme_nd,
    )

    N, B, T = 3, 64, 30
    mis = generate_graded_lexico_multi_indices(2, 2 * N - 1)
    inds = gram_and_hankel_indices_graded_lexico(N, 2)
    model = prey_predator(mis)
    poly = poly_tme_nd(
        model.drift, model.dispersion, model.dt, 2, mis,
        drift_deg=2, dispersion_deg=1,
    )
    _, _, yss = model.simulate(jax.random.PRNGKey(2), B)
    ic = model.init_cond
    cms0 = jnp.broadcast_to(ic.cms, (B,) + ic.cms.shape)
    mean0 = jnp.broadcast_to(ic.mean, (B, 2))

    def run(c, m, y, **kw):
        return moment_filter_nd_cms(
            poly.cms, poly.mean, model.measurement_cond_pdf, y, (mis, inds),
            c, m, predict_fn=poly.predict_cms, **kw,
        )[2]

    nell = np.asarray(_on(gpu, run, cms0, mean0, yss[:T]))
    ref = np.asarray(_on(
        cpu, lambda c, m, y: run(c, m, y, stable=True, eigh_impl="xla"),
        cms0, mean0, yss[:T],
    ))
    assert np.isfinite(nell).all() and np.isfinite(ref).all()
    assert np.max(np.abs(nell - ref) / np.abs(ref)) < 1e-8


def test_rescue_round_trip_gpu_to_cpu(gpu, cpu):
    """Trials the unstabilised GPU pass loses at N=13 are re-run on the
    CPU reference and spliced back; the rescue never loses a trial."""
    from mfs_tpu.parallel.ensemble import rescue_diverged

    model, trans, _, _, ys = _benes(N=13, B=128, T=60, seed=3)
    ic = model.init_cond

    def make_run(device, **kw):
        def run(y):
            n = y.shape[1]
            cmss, means, nell = _on(
                device,
                lambda c, m, yy: moment_filter_cms(
                    trans.cms, trans.mean, model.measurement_cond_pdf,
                    c, m, yy, **kw,
                ),
                jnp.broadcast_to(ic.cms, (n, 2 * 13)), ic.mean * jnp.ones(n), y,
            )
            return dict(moments=cmss, means=means, nell=nell)
        return run

    def finite_fn(out):
        return np.isfinite(np.asarray(out["moments"])).all(axis=(0, 2))

    fast = make_run(gpu)
    merged, finite, rescued = rescue_diverged(
        fast, make_run(cpu, stable=True, eigh_impl="xla"), ys, finite_fn,
        {"moments": 1, "means": 1, "nell": 0},
    )
    raw = finite_fn(fast(ys))
    assert finite.sum() >= raw.sum()
    assert rescued == int(finite.sum() - raw.sum())
    assert np.isfinite(merged["nell"][finite]).all()
