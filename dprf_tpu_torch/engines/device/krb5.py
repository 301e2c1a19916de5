"""Kerberos etype-23 engines on the card: krb5tgs (hashcat 13100) and
krb5asrep (18200), the counterpart of the JAX package's
engines/device/krb5.py.

RFC 4757 checks a candidate by RC4 over the whole multi-kilobyte ticket
and an HMAC-MD5 over the plaintext.  The card's path does neither: the
plaintext is an 8-byte random confounder and then the DER ticket, whose
header at plaintext bytes [8, 12) follows from len(edata2) alone
(``der_filter_words``), so the kernel (ops/cuda_krb5.py) computes NT ->
K1 -> K3 -> 12 RC4 keystream bytes and compares one masked 32-bit word.
A survivor is a *maybe*: a wrong candidate passes with odds of 2^-32
per ticket (2^-30 for AS-REP's relaxed tag byte).  The worker confirms
each with the oracle's full RFC 4757 check before it reports a hit, and
counts the rejected ones (``maybes=`` in the CLI's summary), so a false
maybe never sends a unit to the coordinator's rescan of the whole unit
on the CPU.

A mask job runs one kernel launch per (group, batch): a group is up to
128 tickets of one msg_type (``cuda_krb5.krb5_groups``), and each
launch computes a candidate's NT hash and K1 once for the whole group;
one build serves both engines and every ticket.  A non-DER (BER
long-form) encoder would defeat the header prediction: MIT krb5 and
Windows KDCs emit DER, and ``--device cpu`` runs the full check for
anything else.  A wordlist+rules job runs the rules kernel's Kerberos
tail (ops/cuda_rules.py, csrc/rules_group.cu) over the same groups, one
launch per (group, word window), each rule output's NT hash and K1 once
for the group (``CudaKrb5WordlistWorker``); its words cap at 27
characters, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.cpu.krb5 import (TGS_MSG_TYPE, Krb5AsRepEngine,
                                             Krb5TgsEngine)
from dprf_tpu_torch.ops.cuda_krb5 import CONF
from dprf_tpu_torch.runtime.worker import (GroupedSweepWorker,
                                           GroupedWordlistWorker)


def der_header(blob_len: int, tag: int, tag_mask: int, inner: int,
               short_mask: int) -> tuple[int, int]:
    """(expected, mask), little-endian words over the first four bytes of
    a DER blob of ``blob_len`` bytes: the tag (matched under
    ``tag_mask``), the outer length of C content bytes in DER's minimal
    definite form, then the content's first bytes, whose first is
    ``inner``:

      C < 0x80:        [tag,   C, inner, C-2]   (the last byte under
                                                 ``short_mask``)
      C <= 0xFF:       [tag, 0x81,   C, inner]
      C <= 0xFFFF:     [tag, 0x82, C>>8, C&0xFF]
      C <= 0xFFFFFF:   [tag, 0x83, C>>16, (C>>8)&0xFF]"""
    L = blob_len
    if L - 2 < 0x80:
        exp = [tag, L - 2, inner, (L - 4) & 0xFF]
        msk = [tag_mask, 0xFF, 0xFF, short_mask]
    else:
        msk = [tag_mask, 0xFF, 0xFF, 0xFF]
        if L - 3 <= 0xFF:
            exp = [tag, 0x81, L - 3, inner]
        elif L - 4 <= 0xFFFF:
            C = L - 4
            exp = [tag, 0x82, (C >> 8) & 0xFF, C & 0xFF]
        elif L - 5 <= 0xFFFFFF:
            C = L - 5
            exp = [tag, 0x83, (C >> 16) & 0xFF, (C >> 8) & 0xFF]
        else:
            # a silent filter miss would be a false negative: refuse
            raise ValueError(f"DER blob of {L} bytes (edata2 minus the "
                             "confounder) exceeds the header forms the "
                             "card's filter predicts; use --device cpu")

    def pack(bs):
        return sum(b << (8 * t) for t, b in enumerate(bs))

    return pack(exp) & pack(msk), pack(msk)


def der_filter_words(edata_len: int, msg_type: int) -> tuple[int, int]:
    """(expected, mask), little-endian words over plaintext bytes [8, 12):
    the DER header right after the confounder (``der_header``).

    The decrypted ticket is an [APPLICATION n] tag and its length, then
    the inner SEQUENCE (0x30) and its length, all 32 bits compared.  A
    TGS ticket is EncTicketPart [APPLICATION 3] = 0x63 (exact); an
    AS-REP is EncASRepPart [APPLICATION 25] = 0x79, but some KDCs tag it
    EncTGSRepPart 0x7A, so its tag byte matches 0x78-0x7B (mask 0xFC)."""
    if msg_type == TGS_MSG_TYPE:
        tag, tag_mask = 0x63, 0xFF
    else:
        tag, tag_mask = 0x78, 0xFC
    return der_header(edata_len - CONF, tag, tag_mask, 0x30, 0xFF)


class CudaKrb5MaskWorker(GroupedSweepWorker):
    """Mask worker over the krb5 kernel, the counterpart of the
    reference's PallasKrb5MaskWorker: one launch per (group of tickets
    of one msg_type, batch) (runtime/worker.GroupedSweepWorker), every
    survivor confirmed by the oracle (the engine itself when no oracle
    is given: it subclasses the oracle), its hit buffer ``hit_capacity``
    a ticket of the group.  A single ticket is a group of one."""

    confirm = True

    def __init__(self, engine, gen, targets, batch: int = 1 << 24,
                 hit_capacity: int = 64, oracle=None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_krb5
        super().__init__(engine, gen, targets, batch, hit_capacity,
                         oracle or engine)
        device = torch.device(device)
        if device.type == "cuda":
            cuda_krb5.load_kernel()
        tgts = [cuda_krb5.target_kernel_args(t) for t in self.targets]
        self.groups = [
            (idx, cuda_krb5.make_krb5_step(gen, [tgts[i] for i in idx],
                                           batch, hit_capacity * len(idx),
                                           device=device))
            for idx in cuda_krb5.krb5_groups(tgts)]


class CudaKrb5WordlistWorker(GroupedWordlistWorker):
    """Wordlist+rules worker over the rules kernel's Kerberos tail, the
    counterpart of the reference's Krb5WordlistWorker: the job's words
    and rules go to the device once; one launch per (group of tickets of
    one msg_type, word window) (runtime/worker.GroupedWordlistWorker),
    every survivor confirmed by the oracle, its hit buffer
    ``hit_capacity`` a ticket of the group."""

    confirm = True

    def __init__(self, engine, gen, targets, batch: int = 1 << 24,
                 hit_capacity: int = 64, oracle=None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_krb5, cuda_rules
        super().__init__(engine, gen, targets, batch, hit_capacity,
                         oracle or engine)
        device = torch.device(device)
        if device.type == "cuda":
            cuda_rules.load_kernel("rules_group")
        tables = cuda_rules.job_tables(gen, device)
        tgts = [cuda_krb5.target_kernel_args(t) for t in self.targets]
        self.groups = []
        for idx in cuda_krb5.krb5_groups(tgts):
            group = [tgts[i] for i in idx]
            rows = torch.as_tensor(cuda_krb5.ticket_rows(group).view(np.int32),
                                   device=device)
            self.groups.append((idx, cuda_rules.make_rules_group_step(
                cuda_rules.KRB5, tables, gen.max_len, rows, self.word_batch,
                hit_capacity * len(idx), msg_type=group[0].msg_type)))


class _TorchKrb5Mixin:
    """The device engine: the oracle's parsing and ``hash_batch`` (one
    definition, so the oracle and the card cannot diverge), plus the
    kernel's mask worker.  torch_device: "cuda" (the default) or "cpu",
    where the worker runs the kernel's plain version."""

    def __init__(self, torch_device="cuda"):
        self.torch_device = torch.device(torch_device)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The krb5 kernel's worker; a job the kernel does not take is
        refused, never moved to another path."""
        from dprf_tpu_torch.ops import cuda_krb5
        from dprf_tpu_torch.ops.cuda_mask import mask_fits
        if not mask_fits(gen, cuda_krb5.MAX_LENGTH):
            raise ValueError(
                f"{self.name}: no krb5 kernel for this job (it takes masks "
                f"of 1..{cuda_krb5.MAX_LENGTH} positions, got "
                f"{getattr(gen, 'length', None)}); use --device cpu")
        self._check_tickets(targets)
        return CudaKrb5MaskWorker(self, gen, targets, batch=batch,
                                  hit_capacity=hit_capacity, oracle=oracle,
                                  device=self.torch_device)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        """The rules kernel's Kerberos worker; a job it does not take is
        refused, never moved to another path."""
        from dprf_tpu_torch.ops import cuda_krb5, cuda_rules
        if gen.max_len > cuda_krb5.MAX_LENGTH:
            raise ValueError("krb5 etype-23 passwords cap at 27 chars; use "
                             "--device cpu")
        if not cuda_rules.rules_supported(gen.rules):
            raise ValueError(
                f"{self.name}: no rules kernel for this job (it takes rules "
                f"of at most {cuda_rules.MAX_STEPS} ops without @, E or e); "
                "use --device cpu")
        self._check_tickets(targets)
        return CudaKrb5WordlistWorker(self, gen, targets, batch=batch,
                                      hit_capacity=hit_capacity,
                                      oracle=oracle, device=self.torch_device)

    def _check_tickets(self, targets) -> None:
        """A ticket whose DER header the filter cannot predict is refused
        with its position."""
        from dprf_tpu_torch.engines.base import TargetRefused
        for i, t in enumerate(targets):
            try:
                der_filter_words(len(t.params["edata"]), t.params["msg_type"])
            except ValueError as e:
                raise TargetRefused(i, f"{self.name}: {e}") from None


@register("krb5tgs", device="cuda")
class TorchKrb5TgsEngine(_TorchKrb5Mixin, Krb5TgsEngine):
    pass


@register("krb5asrep", device="cuda")
class TorchKrb5AsRepEngine(_TorchKrb5Mixin, Krb5AsRepEngine):
    pass
