"""Global configuration: the persistent compile cache's directory."""
import os

import jax
import pytest

from mfs_tpu.config import DEFAULT_COMPILE_CACHE_DIR, enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_environment(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert DEFAULT_COMPILE_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert enable_compile_cache() == DEFAULT_COMPILE_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == DEFAULT_COMPILE_CACHE_DIR
    assert enable_compile_cache() == DEFAULT_COMPILE_CACHE_DIR  # stable
