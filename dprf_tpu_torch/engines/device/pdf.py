"""PDF RC4 on the card (hashcat 10400 / 10500): the counterpart of the
JAX package's engines/device/pdf.py.

Algorithm 2's MD5 runs over pad32(password) || O || P || ID [|| -1]:
only the first 32 bytes depend on the candidate and O fills the rest of
block 1, so block 2 (P, ID, the R4 metadata flag, MD5's padding) is a
document constant built on the host (``ops/cuda_pdf.block2_words``).
The kernel (ops/cuda_pdf.py) runs the rest per candidate: the two
blocks, the 50-fold stretch for R3+, then RC4 -- R2 compares one
keystream word against U[0:4] ^ PAD[0:4], R3+ runs the 20-pass cascade
and compares all 16 bytes.

A mask job runs one launch per (document, batch); a hashlist may mix
revisions and key widths, each document on its kind's instantiation.
An R2 hit covers 32 of U's 256 bits, so the worker confirms every hit
with the oracle (``maybes=`` counts the ones it rejects); an R3+ hit is
exact.  Wordlist jobs are refused, naming ``--device cpu``.
"""

from __future__ import annotations

import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.cpu.pdf import PdfEngine
from dprf_tpu_torch.runtime.worker import (GroupedSweepWorker,
                                           singleton_groups)


class PdfMaskWorker(GroupedSweepWorker):
    """Mask worker over the pdf kernel, the counterpart of the
    reference's PdfMaskWorker: each document a group of one, one launch
    per (document, batch) on its kind's instantiation, every hit
    confirmed by the oracle (the engine itself when no oracle is given:
    it subclasses the oracle)."""

    confirm = True

    def __init__(self, engine, gen, targets, batch: int = 1 << 24,
                 hit_capacity: int = 64, oracle=None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_pdf
        super().__init__(engine, gen, targets, batch, hit_capacity,
                         oracle or engine)
        device = torch.device(device)
        if device.type == "cuda":
            cuda_pdf.load_kernel()
        self.groups = singleton_groups(cuda_pdf.make_pdf_steps(
            gen, [cuda_pdf.target_kernel_args(t) for t in self.targets],
            batch, hit_capacity, device=device))


@register("pdf", device="cuda")
class TorchPdfEngine(PdfEngine):
    """The device PDF engine: the oracle's parsing and ``hash_batch``
    (one definition, so the oracle and the card cannot diverge), plus
    the kernel's mask worker.  torch_device: "cuda" (the default) or
    "cpu", where the worker runs the kernel's plain version."""

    def __init__(self, torch_device="cuda"):
        self.torch_device = torch.device(torch_device)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The pdf kernel's worker; a job or a document the kernel does
        not take is refused, never moved to another path."""
        from dprf_tpu_torch.engines.base import TargetRefused
        from dprf_tpu_torch.ops import cuda_pdf
        from dprf_tpu_torch.ops.cuda_mask import mask_fits
        if not mask_fits(gen, cuda_pdf.MAX_LENGTH):
            raise ValueError(
                f"{self.name}: no pdf kernel for this job (it takes masks "
                f"of 1..{cuda_pdf.MAX_LENGTH} positions, got "
                f"{getattr(gen, 'length', None)}); use --device cpu")
        for i, t in enumerate(targets):
            try:
                cuda_pdf.block2_words(t.params)
            except ValueError as e:
                raise TargetRefused(i, f"{self.name}: {e}; use --device "
                                    "cpu") from None
        return PdfMaskWorker(self, gen, targets, batch=batch,
                             hit_capacity=hit_capacity, oracle=oracle,
                             device=self.torch_device)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        raise ValueError(f"{self.name}: the pdf kernel takes mask jobs "
                         "only; use --device cpu for a wordlist")
