"""Headless figure-regeneration smoke tests.

A fresh clone must be able to render the paper figures without first
re-running the experiments: the plot scripts fall back to a per-N
summary (``--summary``) where no npz artifact exists.  These tests
write a synthetic summary and run two representative scripts end to
end under the Agg backend.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, figures_dir, *args):
    env = dict(os.environ, MFS_FIGURES_DIR=str(figures_dir))
    env.setdefault("MPLBACKEND", "Agg")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "postprocessing", script), *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=900,
    )


def _write(path, rows):
    path.write_text(json.dumps({"rows": rows}))
    return str(path)


@pytest.mark.slow
def test_benes_errs_plot_renders_from_summary(tmp_path):
    Ns = (3, 5, 8, 11, 15)
    summary = _write(tmp_path / "benes.json", [
        dict(N=N, trials=1000, divergent=int(N == 15), trials_per_sec=1e4 / N,
             cf_sup=10.0 ** -N, cf_l1=2 * 10.0 ** -N, cf_l2=10.0 ** -N,
             mean_abs_err=10.0 ** (-N / 2))
        for N in Ns
    ])
    r = _run(
        "plot_benes_bernoulli_errs_and_times.py", tmp_path,
        "--Ns", *map(str, Ns), "--summary", summary,
        "--impl-suffix", "_synthetic",  # no npz artifact has this name
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "saved" in r.stdout
    assert (tmp_path / "benes_bernoulli_errs_and_times_raw.png").exists()


@pytest.mark.slow
def test_convergence_plot_renders_from_summary(tmp_path):
    Ns = (2, 3, 4, 6, 8, 10)
    summary = _write(tmp_path / "convergence.json", [
        dict(N=N, mode="central", divergent=0, abs_mean_err=10.0 ** -N,
             abs_var_err=10.0 ** -N, gauss_kl=10.0 ** (-2 * N))
        for N in Ns
    ] + [dict(nparticles=1000, abs_mean_err=1e-2, gauss_kl=1e-3)])
    r = _run("plot_convergence.py", tmp_path, "--summary", summary, "--seed", "12345",
             "--pf-particles", "1000")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "saved" in r.stdout
    assert (tmp_path / "convergence.png").exists()
