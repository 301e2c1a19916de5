"""The sharded runtime: one step over a mesh (parallel/mesh.py), each
shard a keyspace slice -- the counterpart of the reference's
parallel/sharded.py (``_append_hits``, ``make_sharded_step``,
``make_sharded_kernel_mask_step``) for the mask kernel.

A shard's compute is the mask kernel's step on its own device
(ops/cuda_mask.make_shard_mask_compute): compute(base_digits, n_valid,
offset=, out=) runs the window lanes [offset, n_valid) and appends its
hits, as window lanes, to the shard's buffers ``out``.  One round of
the shards covers ``n_dev * span_per_shard`` lanes (``step.super_span``);
a call of the step covers a window of as many rounds as its n_valid
needs.  Shard d of round i runs at offset ``i * super_span + d *
span_per_shard``, from the window's base digits, so the host ships one
digit list a window.  Every shard's launches are enqueued before any
readback, each on its device's current stream, so the cards run at once
and nothing waits on the host inside a window.

The collective round is the shards' counts and fixed-size buffers
gathered onto ``mesh[0]``: the step returns (total int32[1], counts
int32[n_dev], lanes int32[n_dev, cap], tpos int32[n_dev, cap]), as the
reference's ``psum`` and ``all_gather`` do, and n_maybe int32[1], the
prefilter's survivors summed, for a list.  A shard whose window
collects more hits than ``hit_capacity`` keeps the true count (the
buffer truncates, the count does not), and the worker redrives the
window batch by batch.
"""

from __future__ import annotations

import contextlib

import torch

from dprf_tpu_torch.ops import cuda_mask


def _on(device):
    """The device's context for a launch: a card's makes it the current
    device for the C entry and restores the caller's afterwards."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _gather(outs: list, multi: bool, device):
    """The collective round: every shard's buffers onto ``device``."""
    counts = torch.cat([o[0].to(device, non_blocking=True) for o in outs])
    lanes = torch.stack([o[1].to(device, non_blocking=True) for o in outs])
    tpos = torch.stack([o[2].to(device, non_blocking=True) for o in outs])
    result = (counts.sum(dtype=torch.int32).reshape(1), counts, lanes, tpos)
    if multi:
        result += (torch.cat([o[3].to(device, non_blocking=True)
                              for o in outs]).sum(dtype=torch.int32)
                   .reshape(1),)
    return result


def make_sharded_step(computes: list, mesh: list, span_per_shard: int,
                      hit_capacity: int, multi: bool):
    """The sharded step over ``mesh`` from one compute per shard
    (``computes[d]`` on ``mesh[d]``, each covering ``span_per_shard``
    lanes a launch): step(base_digits, n_valid) over the window lanes
    [0, n_valid), ``ceil(n_valid / super_span)`` rounds of launches and
    one collective round.  Attribute ``super_span``, the lanes of one
    round."""
    if len(computes) != len(mesh):
        raise ValueError(f"{len(computes)} computes for a mesh of "
                         f"{len(mesh)}")
    n_dev = len(mesh)
    span_step = n_dev * span_per_shard

    def step(base_digits, n_valid: int):
        outs = [cuda_mask.hit_buffers(multi, hit_capacity, dev)
                for dev in mesh]
        for start in range(0, n_valid, span_step):
            for d, (compute, dev) in enumerate(zip(computes, mesh)):
                offset = start + d * span_per_shard
                with _on(dev):
                    compute(base_digits,
                            max(0, min(n_valid, offset + span_per_shard)),
                            offset=offset, out=outs[d])
        return _gather(outs, multi, mesh[0])

    step.super_span = span_step
    return step


def make_sharded_kernel_mask_step(engine_name: str, gen, target, mesh: list,
                                  batch_per_device: int,
                                  hit_capacity: int = 64):
    """A mask job with the mask kernel as every shard's compute
    (ops/cuda_mask.make_shard_mask_compute on ``mesh[d]``): one target's
    uint32 digest words (the exact compare) or the sorted
    ``TargetTable`` of a list (the blocked probe, verified on the card;
    tpos indexes the sorted table)."""
    computes = [cuda_mask.make_shard_mask_compute(
        engine_name, gen, target, batch_per_device, hit_capacity,
        device=dev) for dev in mesh]
    multi = isinstance(target, cuda_mask.cmp_ops.TargetTable)
    return make_sharded_step(computes, mesh, batch_per_device, hit_capacity,
                             multi)
