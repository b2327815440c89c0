"""Test configuration: CPU backend with 8 virtual devices, f64.

The numerical tests validate the moment core against closed-form
oracles in double precision (the reference's test discipline:
``tests/*.py`` all set jax_enable_x64).  Sharding tests use the 8
virtual CPU devices as a stand-in for a multi-device mesh.

Set ``MFS_TESTS_GPU=1`` to keep the GPU visible — used to run
``tests/test_gpu_hardware.py`` (marker ``gpu``) on a machine with a
GPU:

    MFS_TESTS_GPU=1 python -m pytest tests/test_gpu_hardware.py -m gpu
"""
import os

_ON_GPU = os.environ.get("MFS_TESTS_GPU") == "1"

if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
