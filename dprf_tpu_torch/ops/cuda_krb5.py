"""The Kerberos etype-23 prefilter kernel: the counterpart of the JAX
package's ops/pallas_krb5.py (``make_krb5_pallas_fn``,
``make_krb5_crack_step``, ``target_scalars``).

Per candidate the kernel (csrc/krb5.cu) decodes the mask index,
computes the NT hash, K1 = HMAC-MD5(NT, msg_type) and K1's HMAC key
states once; then per ticket of its group K3 = HMAC-MD5(K1, checksum),
the RC4 key schedule under K3 and 12 keystream bytes, and tests
(keystream[8:12] ^ edata2[8:12]) & mask == expected, the ticket's
predicted DER header (engines/device/krb5.der_filter_words).  One launch
serves a group of up to ``GROUP`` tickets of one msg_type
(``krb5_groups``): the msg_type is a launch parameter, each ticket a row
of ``ticket_rows``.

Outputs: ``count int32[1]``, the exact number of surviving (lane,
ticket) pairs; ``lanes`` and ``tpos``, int32[hit_capacity], the first
``hit_capacity`` of them in no fixed order, -1 where unused; ``tcount
int32[T]``, each ticket's own count.  An overflowing batch goes to the
worker's exact oracle rescan, for the tickets whose count its recorded
pairs do not cover.  A survivor is a *maybe*: the worker confirms it
with the oracle.

Three functions carry it: the kernel's wrapper ``krb5_kernel`` (CUDA
tensors only, launches on the current stream without synchronising,
counts its launches in ``launches``), the same function in plain
PyTorch ``krb5_plain`` (the NT hash and K1 once, then per ticket
``krb5_ticket_word`` and the masked compare; pairs in lane then ticket
order), and the dispatcher ``krb5_crack``: the kernel for CUDA tensors,
the plain version for CPU tensors.  ``make_krb5_step`` builds a group's
step on the dispatcher.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from dprf_tpu_torch.generators.mask import decode_lut
from dprf_tpu_torch.ops.compare import compact_group_hits
from dprf_tpu_torch.ops.cuda_mask import (check_decode, decode_reciprocals,
                                          mask_fits, message_block, wave_grid)
from dprf_tpu_torch.ops.hmac_md5 import hmac_md5_const_msg, hmac_msg_blocks
from dprf_tpu_torch.ops.md4 import md4_digest_words
from dprf_tpu_torch.ops.pack import pack_varlen
from dprf_tpu_torch.ops.rc4 import rc4_keystream_words

#: longest candidate: NTLM's single-block UTF-16LE limit
MAX_LENGTH = 27
#: threads per block (kThreads in the source)
THREADS = 256
#: the most tickets a launch takes (DPRF_KRB5_GROUP), and the words of a
#: ticket's row (DPRF_KRB5_ROW)
GROUP = 128
ROW = 8
#: RFC 4757 puts 8 random confounder bytes before the DER ticket: the
#: predictable header, the compared keystream word, is bytes [8, 12)
CONF = 8

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_krb5.py:260"
SOURCE = "dprf_tpu_torch/csrc/krb5.cu"
KERNEL = "krb5_group"

#: launches of the kernel in this process (tests and chip_smoke.py reset
#: and read it)
launches = {KERNEL: 0}


def reset_launches() -> None:
    launches[KERNEL] = 0


@dataclasses.dataclass(frozen=True)
class Krb5Target:
    """One ticket's launch parameters: msg_type, the 16-byte checksum,
    edata2[8:12] as a little-endian word, and the DER mask and masked
    expectation over plaintext bytes [8, 12)."""

    msg_type: int
    checksum: bytes
    cipher: int
    mask: int
    expected: int


def target_kernel_args(target) -> Krb5Target:
    """Target -> its launch parameters."""
    from dprf_tpu_torch.engines.device.krb5 import der_filter_words
    p = target.params
    expected, mask = der_filter_words(len(p["edata"]), p["msg_type"])
    return Krb5Target(p["msg_type"], p["checksum"],
                      int.from_bytes(p["edata"][CONF:CONF + 4], "little"),
                      mask, expected)


def krb5_groups(tgts: Sequence[Krb5Target]) -> list:
    """The launch groups of a job's tickets (their ``Krb5Target``s, in
    job order): lists of ticket indices of one msg_type, at most GROUP
    each, by msg_type."""
    by_type: dict = {}
    for i, t in enumerate(tgts):
        by_type.setdefault(t.msg_type, []).append(i)
    return [idx[k:k + GROUP] for _, idx in sorted(by_type.items())
            for k in range(0, len(idx), GROUP)]


def ticket_rows(tgts: Sequence[Krb5Target]) -> np.ndarray:
    """A group's rows, uint32[T, ROW]: per ticket its checksum as four
    little-endian words, edata2[8:12], the mask, the masked expectation
    and 0.  The tickets share one msg_type."""
    if not 1 <= len(tgts) <= GROUP:
        raise ValueError(f"a krb5 group takes 1..{GROUP} tickets, got "
                         f"{len(tgts)}")
    if len({t.msg_type for t in tgts}) != 1:
        raise ValueError("a krb5 group's tickets share one msg_type")
    rows = np.zeros((len(tgts), ROW), np.uint32)
    for row, t in zip(rows, tgts):
        if len(t.checksum) != 16:
            raise ValueError("the checksum must be 16 bytes")
        row[:4] = np.frombuffer(t.checksum, "<u4")
        row[4:7] = [t.cipher, t.mask, t.expected]
    return rows


def _check_job(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, rows: torch.Tensor,
               hit_capacity: int, batch: int) -> None:
    check_decode(lut, radices, base_digits, n_valid, batch, MAX_LENGTH)
    if rows.dtype != torch.int32 or rows.dim() != 2 or \
            not 1 <= rows.shape[0] <= GROUP or rows.shape[1] != ROW:
        raise ValueError(f"ticket rows must be int32[1..{GROUP}, {ROW}], "
                         f"got {rows.dtype}{list(rows.shape)}")
    if rows.device != lut.device or not rows.is_contiguous():
        raise ValueError(f"ticket rows must be contiguous on {lut.device}")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


class _Args(ctypes.Structure):
    """``struct Krb5Args`` of csrc/krb5.cu."""
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * MAX_LENGTH),
                ("base", ctypes.c_int32 * MAX_LENGTH),
                ("rcp", ctypes.c_uint32 * MAX_LENGTH),
                ("rsh", ctypes.c_int32 * MAX_LENGTH),
                ("block", ctypes.c_uint32 * 16),
                ("msg_type", ctypes.c_uint32),
                ("n_targets", ctypes.c_int32)]


def kernel_args(radices: Sequence[int], base_digits: Sequence[int],
                msg_type: int, n_targets: int) -> _Args:
    """The launch's parameters: the decode's radices, base digits and
    reciprocals, the widened candidate's fixed block words, the group's
    msg_type and ticket count."""
    length = len(radices)
    rcp, rsh = decode_reciprocals(radices)
    n = MAX_LENGTH
    return _Args(length, (ctypes.c_int32 * n)(*radices),
                 (ctypes.c_int32 * n)(*base_digits),
                 (ctypes.c_uint32 * n)(*rcp), (ctypes.c_int32 * n)(*rsh),
                 (ctypes.c_uint32 * 16)(*message_block("ntlm", length)),
                 msg_type, n_targets)


@functools.cache
def _library():
    """The C entry points, built from csrc/krb5.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("krb5")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_krb5_launch.argtypes = [
        i32, ptr, ctypes.POINTER(_Args), ptr, ctypes.c_uint32, ptr, ptr, ptr,
        ptr, i32, i32, i32, ptr]
    lib.dprf_krb5_launch.restype = i32
    lib.dprf_krb5_blocks_per_sm.argtypes = [i32, ctypes.POINTER(i32)]
    lib.dprf_krb5_blocks_per_sm.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernel now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


def shared_bytes(length: int, n_targets: int = 1) -> int:
    """Dynamic shared memory of one block: 256 bytes of RC4 state per
    thread, the group's rows, then the charset tables."""
    return 256 * THREADS + 4 * ROW * n_targets + 256 * length


@functools.cache
def blocks_per_sm(smem: int) -> int:
    """Resident blocks per SM at ``smem`` bytes, from the CUDA occupancy
    calculator (the RC4 states in shared memory limit this kernel)."""
    blocks = ctypes.c_int(0)
    rc = _library().dprf_krb5_blocks_per_sm(smem, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


def krb5_kernel(lut: torch.Tensor, radices: Sequence[int],
                base_digits: Sequence[int], n_valid: int, msg_type: int,
                rows: torch.Tensor, hit_capacity: int, batch: int):
    """Launch the kernel over lanes [0, n_valid) of a ``batch``-lane
    step for a group of tickets of one ``msg_type``: lut uint8[L, 256]
    (``MaskGenerator.charset_lut``) and the rows int32[T, ROW]
    (``ticket_rows``) on the card, the radices and the base digits of
    the batch's first candidate as ints.  Returns (count int32[1], lanes
    int32[cap], tpos int32[cap], tcount int32[T]) on the card, still
    being computed."""
    if lut.device.type != "cuda":
        raise ValueError(f"the CUDA krb5 kernel takes CUDA tensors, got a "
                         f"lut on {lut.device}")
    _check_job(lut, radices, base_digits, n_valid, rows, hit_capacity, batch)
    if not lut.is_contiguous():
        raise ValueError("lut must be contiguous")
    device = lut.device
    n_targets = rows.shape[0]
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    tpos = torch.full_like(lanes, -1)
    tcount = torch.zeros((n_targets,), dtype=torch.int32, device=device)
    smem = shared_bytes(lut.shape[0], n_targets)
    args = kernel_args(radices, base_digits, msg_type, n_targets)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().dprf_krb5_launch(
        device.index, lut.data_ptr(), ctypes.byref(args), rows.data_ptr(),
        n_valid, count.data_ptr(), lanes.data_ptr(), tpos.data_ptr(),
        tcount.data_ptr(), hit_capacity,
        wave_grid(blocks_per_sm(smem), n_valid, device), THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {rc}")
    launches[KERNEL] += 1
    return count, lanes, tpos, tcount


def krb5_key1(cand: torch.Tensor, lens: torch.Tensor, type_blocks,
              type_n: int) -> torch.Tensor:
    """Candidates uint8[B, L] of lengths int32[B] -> K1 int32[B, 4]: the
    NT hash, then HMAC-MD5 over the msg_type's message pre-padded by
    ``hmac_msg_blocks``."""
    nt = md4_digest_words(pack_varlen(cand, lens, big_endian=False,
                                      widen=True))
    return hmac_md5_const_msg(nt, type_blocks, type_n)


def krb5_ticket_word(k1: torch.Tensor, chk_blocks, chk_n: int, cipher4: int,
                     mask: int) -> torch.Tensor:
    """K1 int32[B, 4] -> one ticket's masked plaintext word over bytes
    [8, 12), int32[B]: K3 = HMAC-MD5(K1, checksum) over its pre-padded
    blocks, RC4, the xor with edata2[8:12] (``cipher4``) and ``mask``."""
    k3 = hmac_md5_const_msg(k1, chk_blocks, chk_n)
    ks = rc4_keystream_words(k3, (CONF + 4) // 4)[:, CONF // 4]
    as_i32 = np.array([cipher4, mask], np.uint32).view(np.int32)
    return (ks ^ int(as_i32[0])) & int(as_i32[1])


def krb5_filter_batch(cand: torch.Tensor, lens: torch.Tensor, type_blocks,
                      type_n: int, chk_blocks, chk_n: int, cipher4: int,
                      mask: int) -> torch.Tensor:
    """Candidates uint8[B, L] of lengths int32[B] -> the masked plaintext
    word over bytes [8, 12) of one ticket, int32[B, 1]: ``krb5_key1``,
    then ``krb5_ticket_word``."""
    k1 = krb5_key1(cand, lens, type_blocks, type_n)
    return krb5_ticket_word(k1, chk_blocks, chk_n, cipher4, mask)[:, None]


def krb5_plain(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, msg_type: int,
               rows: torch.Tensor, hit_capacity: int, batch: int):
    """``krb5_kernel``'s function in plain PyTorch on the lut's device;
    the (lane, ticket) pairs come back in lane then ticket order."""
    _check_job(lut, radices, base_digits, n_valid, rows, hit_capacity, batch)
    device = lut.device
    cand = decode_lut(lut, radices, base_digits, batch)
    lens = torch.full((batch,), lut.shape[0], dtype=torch.int32,
                      device=device)
    lane = torch.arange(batch, device=device)
    found = tickets_found(cand, lens, msg_type, rows)
    return compact_group_hits(found & (lane < n_valid)[:, None],
                              hit_capacity)


def tickets_found(cand: torch.Tensor, lens: torch.Tensor, msg_type: int,
                  rows: torch.Tensor) -> torch.Tensor:
    """Candidates uint8[B, L] of lengths int32[B] against each ticket of
    ``rows`` (``ticket_rows``, one msg_type) in plain PyTorch: the NT
    hash and K1 once, then per ticket ``krb5_ticket_word`` and the masked
    compare; found bool[B, T]."""
    k1 = krb5_key1(cand, lens, *hmac_msg_blocks(msg_type.to_bytes(4, "little"),
                                                1, "msg_type"))
    found = []
    for row in rows.cpu().numpy().view(np.uint32):
        chk, chk_n = hmac_msg_blocks(row[:4].astype("<u4").tobytes(), 1,
                                     "checksum")
        word = krb5_ticket_word(k1, chk, chk_n, int(row[4]), int(row[5]))
        found.append(word == int(row[6:7].view(np.int32)[0]))
    return torch.stack(found, dim=1)


def krb5_crack(lut: torch.Tensor, *args):
    """The kernel on CUDA tensors, its plain version on CPU tensors
    (arguments as ``krb5_kernel``)."""
    if lut.device.type == "cuda":
        return krb5_kernel(lut, *args)
    if lut.device.type == "cpu":
        return krb5_plain(lut, *args)
    raise ValueError(f"no krb5 kernel for device {lut.device}")


def make_krb5_step(gen, tgts: Sequence[Krb5Target], batch: int,
                   hit_capacity: int = 64, device="cuda"):
    """A group's step: step(base_digits, n_valid) -> (count int32[1],
    lanes int32[cap], tpos int32[cap], tcount int32[T]) for the tickets
    ``tgts`` (``Krb5Target``s of one msg_type, ``krb5_groups``).  The
    charset tables and the rows go to ``device`` once, here."""
    if not mask_fits(gen, MAX_LENGTH):
        raise ValueError(
            f"krb5 job not eligible for the kernel: masks of 1.."
            f"{MAX_LENGTH} positions, got {getattr(gen, 'length', None)}")
    device = torch.device(device)
    lut = gen.charset_lut(device)
    radices = gen.radices
    rows = torch.as_tensor(ticket_rows(tgts).view(np.int32), device=device)
    msg_type = tgts[0].msg_type

    def step(base_digits: Sequence[int], n_valid: int):
        return krb5_crack(lut, radices, base_digits, n_valid, msg_type, rows,
                          hit_capacity, batch)

    return step
