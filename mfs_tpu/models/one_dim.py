"""Canonical 1D test models (counterpart of reference ``mfs/one_dim/ss_models.py``).

Batch-first: the returned simulators generate whole Monte-Carlo
ensembles in one call — the batched replacement for the reference's
one-process-per-trial Slurm protocol
(reference: ``dardel/run_benes_bernoulli_mf.sh:26-31``).
"""
from functools import partial
from typing import NamedTuple, Callable

import jax
import jax.numpy as jnp

from mfs_tpu.sde import tme
from mfs_tpu.typings import Array
from mfs_tpu.utils.gaussian import GaussianSum1D
from mfs_tpu.utils.sdes import simulate_sde


class Model1D(NamedTuple):
    """A continuous-discrete 1D test model."""

    dt: float
    T: int
    ts: Array
    init_cond: GaussianSum1D
    drift: Callable
    dispersion: Callable
    emission: Callable
    measurement_cond_pdf: Callable
    simulate: Callable  # (key, nsamples) -> xss (n, T)
    simulate_trials: Callable = None  # (base_key, trial_ids) -> xss


def benes_bernoulli(N: int = 2) -> Model1D:
    """Beneš SDE with Bernoulli measurements — the paper's flagship model.

        dX = tanh(X) dt + dW,   Y_k ~ Bernoulli(logistic(X_k^3 / 5)).

    Reference: ``mfs/one_dim/ss_models.py:25-56``.
    """
    dt = 1e-2
    T = 100
    ts = jnp.linspace(dt, dt * T, T)

    init_cond = GaussianSum1D.new(
        means=jnp.array([-0.5, 0.5]),
        variances=jnp.array([0.05, 0.05]),
        weights=jnp.array([0.5, 0.5]),
        N=N,
    )

    def drift(x):
        return jnp.tanh(x)

    def dispersion(x):
        return jnp.ones_like(x) if hasattr(x, "shape") else 1.0

    def emission(x):
        return 1.0 / (1.0 + jnp.exp(-(x**3) / 5.0))

    def measurement_cond_pdf(y, x):
        p = emission(x)
        return jnp.where(y == 1, p, 1.0 - p)

    def m_and_cov(x, _dt):
        m, v = tme.mean_and_var_1d(x[0], _dt, drift, dispersion, order=3)
        return m[None], v[None, None]

    @partial(jax.jit, static_argnums=(1, 2))
    def simulate(key: Array, nsamples: int = 1, integration_steps: int = 100):
        """Simulate an ensemble of trajectories; returns (nsamples, T)."""
        key_x0, key_path = jax.random.split(key)
        x0s = init_cond.sampler(key_x0, nsamples)
        keys = jax.random.split(key_path, nsamples)
        sim = lambda x0, k: simulate_sde(
            m_and_cov, x0, dt, T, k, integration_steps=integration_steps
        )[:, 0]
        return jax.vmap(sim)(x0s, keys)

    @partial(jax.jit, static_argnums=(2,))
    def simulate_trials(base_key: Array, trial_ids: Array, integration_steps: int = 100):
        """Per-trial-id reproducible ensemble: trial i depends only on
        (base_key, i), so chunked sweeps produce identical trajectories
        for any chunk size — the batch-first analogue of the reference's
        shared ``rng_keys.npy`` protocol (``dardel/generate_rng_key.py``)."""

        def one(i):
            k = jax.random.fold_in(base_key, i)
            kx, kp = jax.random.split(k)
            x0 = init_cond.sampler(kx, 1)[0]
            return simulate_sde(
                m_and_cov, x0, dt, T, kp, integration_steps=integration_steps
            )[:, 0]

        return jax.vmap(one)(trial_ids)

    return Model1D(
        dt=dt,
        T=T,
        ts=ts,
        init_cond=init_cond,
        drift=drift,
        dispersion=dispersion,
        emission=emission,
        measurement_cond_pdf=measurement_cond_pdf,
        simulate=simulate,
        simulate_trials=simulate_trials,
    )


def well_poisson(true_p1: float, N: int = 2):
    """Double-well SDE with softplus-Poisson emissions — the
    parameter-estimation model (reference: ``mfs/one_dim/ss_models.py:59-93``).

        dX = X (1 - p1 X^2) dt + dW,   Y_k ~ Poisson(log(1 + e^{p2 X_k})).

    Returns the model pieces parameterised by (p1, p2) plus an ensemble
    simulator at the true parameters.
    """
    dt = 1e-2
    T = 1000
    ts = jnp.linspace(dt, dt * T, T)

    init_cond = GaussianSum1D.new(
        means=jnp.array([-0.5, 0.5]),
        variances=jnp.array([0.05, 0.05]),
        weights=jnp.array([0.5, 0.5]),
        N=N,
    )

    def drift(x, p1):
        return x * (1.0 - p1 * x**2)

    def dispersion(x):
        return jnp.ones_like(x) if hasattr(x, "shape") else 1.0

    def emission(x, p2):
        return jnp.logaddexp(0.0, p2 * x)  # softplus, overflow-safe

    def measurement_cond_pmf(y, x, p2):
        rate = emission(x, p2)
        return jnp.exp(y * jnp.log(rate) - rate - jax.lax.lgamma(y + 1.0))

    def m_and_cov(x, _dt):
        m, v = tme.mean_and_var_1d(
            x[0], _dt, lambda u: drift(u, true_p1), dispersion, order=3
        )
        return m[None], v[None, None]

    @partial(jax.jit, static_argnums=(1, 2))
    def simulate(key: Array, nsamples: int = 1, integration_steps: int = 100):
        key_x0, key_path = jax.random.split(key)
        x0s = init_cond.sampler(key_x0, nsamples)
        keys = jax.random.split(key_path, nsamples)
        sim = lambda x0, k: simulate_sde(
            m_and_cov, x0, dt, T, k, integration_steps=integration_steps
        )[:, 0]
        return jax.vmap(sim)(x0s, keys)

    return dt, T, ts, init_cond, drift, dispersion, emission, measurement_cond_pmf, simulate
