"""Kerberos AES etype-17/18 engines on the card (hashcat 19600/19700
krb5tgs, 19800/19900 krb5pa, 32100 krb5asrep): the counterpart of the
JAX package's engines/device/krb5aes.py.

The RFC 3962 check (engines/cpu/krb5aes.py) on the card:

- **PBKDF2-HMAC-SHA1**, 4,096 iterations, one block for AES-128 and two
  for AES-256: nearly all of the work, on the KDF kernel of
  csrc/pbkdf2.cu (``ops/cuda_pbkdf2.kdf``), one launch per (ticket,
  batch), the ticket's salt (realm || principal) a launch parameter;
- **the verdict**, in torch on the card after the kernel, as the
  reference runs it in XLA after its kernel: the two RFC 3961 DK
  derivations (string-to-key's "kerberos", then the usage || 0xAA
  encryption subkey), 1-2 AES encryptions each with per-candidate keys,
  and one AES decryption of ciphertext block 1, xored with block 0
  (plain CBC: a ticket of at least 64 bytes keeps block 1 out of the
  CTS-stolen pair);
- **the prefilter**: plaintext bytes [16, 20), right after the 16-byte
  confounder, against the predicted DER header
  (``der_filter_words_aes``).  A survivor is a *maybe*: the window is 32
  bits for a long-form length but 24 for a short one (odds of 2^-24 per
  candidate and ticket).  The worker confirms each with the oracle's
  full CTS + HMAC-SHA1-96 check, and counts the ones it rejects.

A ticket outside the card's envelope (edata2 under 64 bytes, a salt over
51 bytes) is refused, naming its line and ``--device cpu``: most
``krb5pa`` lines, whose PA-ENC-TIMESTAMP is 40-60 bytes, are such.
Wordlist jobs are refused the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from dprf_tpu_torch.engines import register
from dprf_tpu_torch.engines.cpu.krb5aes import (USAGE_AS_REP,
                                                USAGE_PA_TIMESTAMP,
                                                USAGE_TGS_REP_TICKET,
                                                Krb5AsRepAesEngine,
                                                Krb5PaAesEngine,
                                                Krb5TgsAesEngine, nfold)
from dprf_tpu_torch.engines.device.krb5 import der_header
from dprf_tpu_torch.ops.aes import aes_decrypt_blocks, aes_encrypt_block_batch
from dprf_tpu_torch.ops.pack import words_to_bytes_be
from dprf_tpu_torch.runtime.worker import (GroupedSweepWorker,
                                           singleton_groups)

#: the confounder before the DER plaintext: one AES block
CONF = 16

#: the smallest edata2 the card's prefilter covers: the DER window's
#: block (index 1) stays outside the CTS-stolen pair in every layout
MIN_DEVICE_EDATA = 64

#: the largest salt (realm || principal) the KDF kernel packs: salt ||
#: INT32BE(i), the 0x80 marker and the 8-byte bit length fill one block
MAX_DEVICE_SALT = 51


def der_filter_words_aes(edata_len: int, usage: int) -> tuple[int, int]:
    """(expected, mask), little-endian words over plaintext bytes
    [16, 20): the DER header right after the confounder, the etype-23
    filter's ``der_header`` with the AES confounder's width and a tag per
    usage: a TGS-REP ticket is EncTicketPart 0x63 (exact); an AS-REP
    EncASRepPart 0x79, or 0x7A from some KDCs (0x78-0x7B, mask 0xFC); a
    Pre-Auth timestamp a bare SEQUENCE 0x30.  The first content byte is
    the inner SEQUENCE 0x30, or the [0] context tag 0xA0 of a
    PA-ENC-TS-ENC; in the short form the window's last byte varies, so 24
    bits are compared."""
    if usage == USAGE_TGS_REP_TICKET:
        tag, tag_mask = 0x63, 0xFF
    elif usage == USAGE_AS_REP:
        tag, tag_mask = 0x78, 0xFC
    else:
        tag, tag_mask = 0x30, 0xFF
    inner = 0xA0 if usage == USAGE_PA_TIMESTAMP else 0x30
    # the DER blob: CTS has no padding
    return der_header(edata_len - CONF, tag, tag_mask, inner, 0x00)


def _dk_batch(base: torch.Tensor, constant: bytes) -> torch.Tensor:
    """RFC 3961 DK under per-candidate keys uint8[B, 16|32]: ECB
    encryptions of the n-folded constant, chained until key-length bytes
    exist (one block for AES-128, two for AES-256)."""
    B, kl = base.shape
    nf = nfold(constant, 16) if len(constant) != 16 else constant
    block = torch.as_tensor(np.frombuffer(nf, np.uint8).copy(),
                            device=base.device).expand(B, 16)
    out = aes_encrypt_block_batch(base, block)
    if kl == 16:
        return out
    return torch.cat([out, aes_encrypt_block_batch(base, out)], dim=1)


def make_krb5aes_check(params: dict):
    """check(base uint8[B, key_len], the PBKDF2 output) -> int32[B, 1],
    the MASKED DER window: the DK derivations and the one-block CBC
    decryption, the cheap tail of the check."""
    usage, edata = params["usage"], params["edata"]
    _, mask_w = der_filter_words_aes(len(edata), usage)
    c1 = np.frombuffer(edata[:16], np.uint8)
    c2 = np.frombuffer(edata[16:32], np.uint8).reshape(1, 16)
    usage_const = usage.to_bytes(4, "big") + b"\xaa"
    mask = int(np.array([mask_w], np.uint32).view(np.int32)[0])

    def check(base: torch.Tensor) -> torch.Tensor:
        kkey = _dk_batch(base, b"kerberos")
        ke = _dk_batch(kkey, usage_const)
        p2 = aes_decrypt_blocks(ke, c2)[:, 0] ^ torch.as_tensor(
            c1.copy(), device=base.device)
        w = p2[:, :4].to(torch.int32)
        word = w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)
        return (word & mask)[:, None]

    return check


def make_krb5aes_filter(params: dict, iterations: int = 4096):
    """fb(cand uint8[B, L], lens int32[B]) -> int32[B, 1], the masked DER
    window in plain torch (PBKDF2 on ops/hmac_sha1.py, then the check):
    the reference filter's counterpart, for candidates of any length up
    to 64 bytes."""
    from dprf_tpu_torch.ops import hmac_sha1
    from dprf_tpu_torch.ops.pack import pack_raw

    salt, key_len = params["salt"], params["key_len"]
    check = make_krb5aes_check(params)

    def fb(cand: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(cand.shape[1], device=cand.device)[None, :]
        key = pack_raw(torch.where(pos < lens[:, None], cand, 0)
                       .to(torch.uint8))
        istate, ostate = hmac_sha1.hmac_key_states(key)
        words = [hmac_sha1.pbkdf2_sha1_block(istate, ostate, salt, i,
                                             iterations)
                 for i in range(1, 1 + (key_len > 20) + 1)]
        base = words_to_bytes_be(torch.cat(words, dim=1))[:, :key_len]
        return check(base)

    return fb


def expected_word(params: dict) -> int:
    """The target's masked DER expectation as an int32 bit pattern."""
    exp_w, _ = der_filter_words_aes(len(params["edata"]), params["usage"])
    return int(np.array([exp_w], np.uint32).view(np.int32)[0])


def make_kdf_step(gen, batch: int, params: dict, hit_capacity: int,
                  iterations: int = 4096, device="cuda"):
    """One ticket's step: the KDF kernel (its plain version on CPU
    tensors), then the verdict in torch on the same device and the
    masked compare.  step(base_digits, n_valid) -> (count int32[1],
    lanes int32[cap], None); lanes ascending, -1 past the hits.  Nothing
    in it waits on the card, so a unit's launches queue back to back."""
    from dprf_tpu_torch.ops import cuda_pbkdf2

    salt, key_len = params["salt"], params["key_len"]
    check = make_krb5aes_check(params)
    expected = expected_word(params)
    lut = gen.charset_lut(torch.device(device))
    radices = gen.radices

    def step(base_digits, n_valid: int):
        words = cuda_pbkdf2.kdf(lut, radices, base_digits, n_valid, salt,
                                iterations, key_len // 4, batch)
        found = check(words_to_bytes_be(words))[:, 0] == expected
        count = found.sum(dtype=torch.int32).reshape(1)
        # the first hits: each lane's index, or n_valid where it missed
        idx = torch.where(found, torch.arange(n_valid, dtype=torch.int32,
                                              device=found.device), n_valid)
        first = torch.topk(idx, min(hit_capacity, n_valid),
                           largest=False).values
        lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                           device=found.device)
        lanes[:first.shape[0]] = torch.where(first < n_valid, first, -1)
        return count, lanes, None

    return step


class Krb5AesMaskWorker(GroupedSweepWorker):
    """Mask worker over the KDF kernel and the torch verdict, the
    counterpart of the reference's Krb5AesMaskWorker: each ticket has
    its own step (its salt, key length and ciphertext), a group of one,
    one launch per (ticket, batch); every survivor is confirmed by the
    oracle (the engine itself when no oracle is given: it subclasses the
    oracle)."""

    confirm = True

    def __init__(self, engine, gen, targets, batch: int = 1 << 19,
                 hit_capacity: int = 64, oracle=None, device="cuda"):
        from dprf_tpu_torch.ops import cuda_pbkdf2
        super().__init__(engine, gen, targets, batch, hit_capacity,
                         oracle or engine)
        device = torch.device(device)
        if device.type == "cuda":
            cuda_pbkdf2.load_kernel()
        self.groups = singleton_groups(
            [make_kdf_step(gen, batch, t.params, hit_capacity,
                           engine.iterations, device)
             for t in self.targets])


#: candidates per launch on the card.  A candidate at 4,096 iterations is
#: 8,194 SHA-1 compressions for etype 17 and 16,388 for etype 18, the
#: PMKID kernel's load (engines/device/pmkid.BATCH), so a launch of 2^19
#: takes a few tenths of a second.
BATCH = 1 << 19


def target_device_ok(t) -> bool:
    """Whether one ticket is inside the card's envelope: edata2 at or
    above the CTS-safe floor and a salt that fits the KDF's one block."""
    return (len(t.params["edata"]) >= MIN_DEVICE_EDATA
            and len(t.params["salt"]) <= MAX_DEVICE_SALT)


class _TorchKrb5AesMixin:
    """The device engine: the oracle's parsing, ``hash_batch`` and
    ``iterations`` (one definition, so the oracle and the card cannot
    diverge), plus the KDF kernel's mask worker.  torch_device: "cuda"
    (the default) or "cpu", where the worker runs the kernel's plain
    version."""

    def __init__(self, torch_device="cuda"):
        self.torch_device = torch.device(torch_device)

    def make_mask_worker(self, gen, targets, batch: int, hit_capacity: int,
                         oracle=None):
        """The KDF kernel's worker; a job or a ticket the card does not
        take is refused, never moved to another path."""
        from dprf_tpu_torch.engines.base import TargetRefused
        from dprf_tpu_torch.ops import cuda_pbkdf2
        from dprf_tpu_torch.ops.cuda_mask import mask_fits
        if not mask_fits(gen, cuda_pbkdf2.MAX_LENGTH):
            raise ValueError(
                f"{self.name}: no KDF kernel for this job (it takes masks "
                f"of 1..{cuda_pbkdf2.MAX_LENGTH} positions, got "
                f"{getattr(gen, 'length', None)}); use --device cpu")
        for i, t in enumerate(targets):
            if not target_device_ok(t):
                raise TargetRefused(
                    i, f"{self.name}: the ticket is outside the card's "
                    f"envelope (edata2 of {len(t.params['edata'])} bytes, "
                    f"at least {MIN_DEVICE_EDATA}; salt of "
                    f"{len(t.params['salt'])} bytes, at most "
                    f"{MAX_DEVICE_SALT}); use --device cpu")
        return Krb5AesMaskWorker(self, gen, targets, batch=min(batch, BATCH),
                                 hit_capacity=hit_capacity, oracle=oracle,
                                 device=self.torch_device)

    def make_wordlist_worker(self, gen, targets, batch: int,
                             hit_capacity: int, oracle=None):
        raise ValueError(f"{self.name}: the KDF kernel takes mask jobs "
                         "only; use --device cpu for a wordlist")


@register("krb5tgs17", device="cuda")
@register("krb5tgs18", device="cuda")
@register("krb5tgs-aes", device="cuda")
class TorchKrb5TgsAesEngine(_TorchKrb5AesMixin, Krb5TgsAesEngine):
    pass


@register("krb5pa17", device="cuda")
@register("krb5pa18", device="cuda")
@register("krb5pa", device="cuda")
class TorchKrb5PaAesEngine(_TorchKrb5AesMixin, Krb5PaAesEngine):
    pass


@register("krb5asrep17", device="cuda")
@register("krb5asrep18", device="cuda")
@register("krb5asrep-aes", device="cuda")
class TorchKrb5AsRepAesEngine(_TorchKrb5AesMixin, Krb5AsRepAesEngine):
    pass
