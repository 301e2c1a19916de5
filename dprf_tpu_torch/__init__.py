"""dprf_tpu_torch: the PyTorch/CUDA port of dprf-tpu.

The same HashEngine plugins, mask generator, Dispatcher/WorkUnit
keyspace splitter and coordinator as the JAX package, with the hot path
(index -> candidate -> digest -> compare -> hit compaction) on torch
tensors.  On an NVIDIA card the whole chain runs inside one
hand-written CUDA kernel per batch (ops/cuda_mask.py); on CPU tensors
the same step runs its plain PyTorch version.

This package imports torch, numpy and the standard library only: it
never imports jax or anything of ``dprf_tpu``.
"""

__version__ = "0.1.0"

from dprf_tpu_torch.engines import engine_names, get_engine  # noqa: F401
