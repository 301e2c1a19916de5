"""WPA2-PMKID on the card: the iterated-KDF path (benchmark config 5).

PMKID digests depend on per-target parameters (the ESSID salts the
PBKDF2, the AP/STA MACs make the PMKID message), and the PMK depends
only on (passphrase, ESSID).  So targets are grouped by ESSID and each
group is one launch series of the PMKID kernel (ops/cuda_pbkdf2.py):
per candidate the 4096-iteration PBKDF2 runs once, and each target of
the group costs one more HMAC and a 4-word compare.  A typical job has
one ESSID and a handful of targets: ~16.4 k SHA-1 compressions per
candidate.

The reference routes a job between its Pallas kernel (which recomputes
the PMK per target) and an XLA step (which shares it per ESSID); the
grouped kernel computes what both compute, so there is one path.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.base import Target
from dprf_tpu_torch.engines.cpu.engines import Pmkid2Engine
from dprf_tpu_torch.ops import cuda_pbkdf2
from dprf_tpu_torch.runtime.worker import GroupedSweepWorker

#: candidates per launch.  A candidate at 4096 iterations is 16,390
#: SHA-1 compressions; the kernel runs 1.99 M candidates/s on an H100
#: 80GB HBM3 at 700 W (chip_smoke.py, PERF.md), so a launch of 2^19
#: takes 0.26 s: long enough that the host's work per launch is noise,
#: short enough for prompt progress and hits.  (The reference caps its
#: TPU batch at 2^15.)
BATCH = 1 << 19


@register("wpa2-pmkid", device="cuda")
@register("pmkid", device="cuda")
class TorchPmkidEngine(Pmkid2Engine):
    """The device PMKID engine: the oracle's target parsing (hashcat
    16800 lines), ``hash_batch`` and ``iterations`` (one definition, so
    the oracle and the kernel cannot diverge), plus the kernel's mask
    worker.  torch_device: "cuda" (the default) or "cpu", where the
    worker runs the kernel's plain version."""

    def __init__(self, torch_device="cuda"):
        self.torch_device = torch.device(torch_device)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The PMKID kernel's worker; a job the kernel does not take is
        refused, never moved to another path."""
        lens = [len(t.params["essid"]) for t in targets]
        if not cuda_pbkdf2.pmkid_kernel_eligible(gen, lens):
            raise ValueError(
                f"{self.name}: no PMKID kernel for this job (it takes masks "
                f"of 1..{cuda_pbkdf2.MAX_LENGTH} positions and ESSIDs of "
                f"1..{cuda_pbkdf2.MAX_ESSID} bytes); use --device cpu")
        return CudaPmkidWorker(self, gen, targets, batch=min(batch, BATCH),
                               hit_capacity=hit_capacity, oracle=oracle,
                               device=self.torch_device)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        raise ValueError(f"{self.name}: the PMKID kernel takes mask jobs "
                         "only; use --device cpu for a wordlist")


def _group_targets(targets: Sequence[Target]) -> dict:
    """ESSID -> the indices of its targets, in job order."""
    by_essid: dict[bytes, list[int]] = {}
    for i, t in enumerate(targets):
        by_essid.setdefault(t.params["essid"], []).append(i)
    return by_essid


class CudaPmkidWorker(GroupedSweepWorker):
    """Mask worker over the PMKID kernel: one launch per (ESSID group,
    batch), queued asynchronously (runtime/worker.GroupedSweepWorker);
    every (lane, target) hit decodes to a Hit, so a lane that matches two
    targets gives two hits, and an overflowing batch is rescanned for
    its whole group.  On a card the kernel builds at construction, so a
    build failure raises here; with ``device="cpu"`` each batch runs the
    kernel's plain version."""

    def __init__(self, engine, gen, targets: Sequence[Target],
                 batch: int = BATCH, hit_capacity: int = 64, oracle=None,
                 device="cuda"):
        super().__init__(engine, gen, targets, batch, hit_capacity, oracle)
        device = torch.device(device)
        if device.type == "cuda":
            cuda_pbkdf2.load_kernel()
        self.groups = [
            (tidx, cuda_pbkdf2.make_pmkid_step(
                gen, essid, [self.targets[i] for i in tidx],
                engine.iterations, batch, hit_capacity, device=device))
            for essid, tidx in _group_targets(self.targets).items()]
