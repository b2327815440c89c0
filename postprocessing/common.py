"""Shared post-processing utilities (counterpart of the ad-hoc helpers
in reference ``reproduce_paper_plots/*.py``).

All figure scripts run headless (Agg), read the ``.npz`` artifacts the
``experiments/`` scripts write, and save PNGs under
``postprocessing/figures/`` (or ``$MFS_FIGURES_DIR`` when set).
"""
import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
RESULTS_DIR = os.path.join(os.path.dirname(HERE), "experiments", "results")
FIGURES_DIR = os.environ.get("MFS_FIGURES_DIR", os.path.join(HERE, "figures"))


def setup_jax():
    """Honor MFS_PLATFORM=cpu|gpu before any JAX computation (the
    config route, applied before first use)."""
    plat = os.environ.get("MFS_PLATFORM")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)


def load(experiment: str, name: str):
    """Load one experiment artifact; raises with a run hint if absent."""
    path = os.path.join(RESULTS_DIR, experiment, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — run the matching script in experiments/ "
            f"first (see postprocessing/README.md)"
        )
    return np.load(path)


def maybe_load(experiment: str, name: str):
    try:
        return load(experiment, name)
    except FileNotFoundError:
        return None


def rm_divergent(arr: np.ndarray):
    """Mask trials containing non-finite entries; return (kept, n_divergent).

    The reference counts and removes divergent Monte-Carlo runs in
    post-processing rather than hiding them (reference:
    ``reproduce_paper_plots/plot_benes_bernoulli_errs_and_times.py:11-35``).
    """
    arr = np.asarray(arr)
    mask = ~np.isfinite(arr).all(axis=tuple(range(1, arr.ndim)))
    return arr[~mask], int(mask.sum())


def savefig(fig, name: str) -> str:
    os.makedirs(FIGURES_DIR, exist_ok=True)
    path = os.path.join(FIGURES_DIR, f"{name}.png")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    print(f"saved {path}")
    return path
