"""mfs-tpu: batched moment-representation stochastic filtering in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference library zgbkdlm/mfs ("Stochastic filtering with moment
representation", Zhao & Sarmavuori): filters that propagate the first
2N moments of the filtering distribution through moment-matched Gauss
quadrature, with differentiable likelihoods for parameter estimation,
classical baselines, multi-dimensional support, and density recovery
from moments.  It runs on a GPU in f64 (and on the CPU for tests).

Architecture:

- batch-first APIs — every filter runs thousands of Monte-Carlo trials
  in one ``lax.scan``, replacing per-process trial farming;
- batched eigensolver engines with custom JVPs
  (``mfs_tpu.ops.eigh``) for the per-step quadrature eigenproblems;
- all-orders-at-once moment recurrences and vector-valued TME
  expansions — flat compile time and runtime in the moment order;
- mesh sharding utilities (``mfs_tpu.parallel``) that split the trial
  axis over several devices with zero hot-loop collectives.
"""
from mfs_tpu import config
from mfs_tpu.config import enable_compile_cache, enable_x64

__version__ = "0.1.0"
