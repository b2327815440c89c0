"""Device-mesh utilities for trial-level data parallelism.

The workload is embarrassingly parallel across Monte-Carlo trials
(each trial's time-scan is independent), so the parallel design is a
1-D mesh over the trial axis: shard the batch, run the same program
everywhere, no collectives in the hot loop, reduce only at the end
(e.g. a mean of per-trial nell for parameter estimation — one psum
inserted by XLA).  The mesh needs no topology: on cards joined all to
all (NVLink) every device order is as good as any other.

This replaces the reference's OS-process / Slurm-array trial farming
(reference: ``dardel/run_benes_bernoulli_mf.sh:26-31``,
``dardel/run_prey_predator_mf_gpu.sh:33-40``).
"""
from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TRIAL_AXIS = "trials"


def trial_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the trial axis.

    Parameters
    ----------
    n_devices : int, optional
        Number of devices to use (default: all available).
    devices : sequence of jax devices, optional
        Explicit device list (overrides n_devices).
    """
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), (TRIAL_AXIS,))


def shard_trials(tree: Any, mesh: Mesh, axis: int = 0) -> Any:
    """Place every array in ``tree`` with its trial axis sharded."""

    def _put(x):
        spec = [None] * x.ndim
        spec[axis] = TRIAL_AXIS
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    return jax.tree_util.tree_map(_put, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate every array in ``tree`` across the mesh."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree
    )
