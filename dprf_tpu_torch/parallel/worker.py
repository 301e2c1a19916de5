"""The sharded mask worker: drives the sharded runtime
(parallel/sharded.py) over WorkUnits -- the counterpart of the
reference's parallel/worker.py ``ShardedMaskWorker`` in its kernel mode.

It shares target setup and hit decoding with runtime.worker's
MaskWorkerBase; each dispatch covers ``n_dev * batch_per_device`` lanes
(its stride) and its hit buffers come back per shard.  A unit goes
out as sharded windows of up to SUPER_CAP strides: one digit list, the
strides' launches on every shard and one collective round a window.
The reference's ahead-of-time compile has no counterpart: the kernel
builds once, at construction.
"""

from __future__ import annotations

from typing import Optional, Sequence

from dprf_tpu_torch.engines.base import HashEngine, Target
from dprf_tpu_torch.runtime.worker import Hit, MaskWorkerBase
from dprf_tpu_torch.runtime.workunit import WorkUnit


class ShardedMaskWorker(MaskWorkerBase):
    """A mask job of a core engine over a mesh of devices, the mask
    kernel each shard's compute: the exact compare for one target, the
    blocked probe with the verify on the card for 2..MAX_TARGETS
    (ops/cuda_mask.make_shard_mask_compute).  On a card the kernel
    builds at construction; on CPU devices each shard runs the kernel's
    plain version.  A shard that fails to launch raises."""

    def __init__(self, engine, gen, targets: Sequence[Target], mesh: list,
                 batch_per_device: int = 1 << 24, hit_capacity: int = 64,
                 oracle: Optional[HashEngine] = None):
        from dprf_tpu_torch.ops import cuda_mask
        from dprf_tpu_torch.ops.superstep import max_inner
        from dprf_tpu_torch.parallel.sharded import (
            make_sharded_kernel_mask_step)

        tgt = self._setup_targets(engine, gen, targets, hit_capacity,
                                  oracle)
        self.mesh = list(mesh)
        if any(d.type == "cuda" for d in self.mesh):
            cuda_mask.load_kernel()
        self.batch = batch_per_device
        self.step = make_sharded_kernel_mask_step(
            engine.name, gen, tgt, self.mesh, batch_per_device,
            hit_capacity)
        self.stride = self.step.super_span
        self.window_batches = max_inner(self.stride, self.SUPER_CAP)

    def _window(self, base_digits, n_valid: int):
        self.windows += 1
        return self.step(base_digits, n_valid)

    def _maybes_of(self, result):
        return result[4]

    def _batch_hits(self, window, result, unit: WorkUnit) -> list[Hit]:
        bstart, span = window
        total, counts, lanes, tpos = result[:4]
        if int(total.item()) == 0:
            return []
        # every shard is checked before any is decoded: an overflowed
        # shard's buffer is truncated, and mixing a redrive with the
        # other shards' decoded hits would report those twice
        if bool((counts > lanes.shape[-1]).any()):
            if span > self.stride:
                return self._redrive(bstart, span, unit)
            return self._rescan(bstart, unit)
        lanes_np, tpos_np = lanes.cpu().numpy(), tpos.cpu().numpy()
        hits: list[Hit] = []
        for d in range(lanes_np.shape[0]):
            hits.extend(self._decode_lanes(bstart, lanes_np[d], tpos_np[d]))
        return sorted(hits, key=lambda h: (h.cand_index, h.target_index))
