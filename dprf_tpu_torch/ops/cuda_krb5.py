"""The Kerberos etype-23 prefilter kernel: the counterpart of the JAX
package's ops/pallas_krb5.py (``make_krb5_pallas_fn``,
``make_krb5_crack_step``, ``target_scalars``).

Per candidate the kernel (csrc/krb5.cu) decodes the mask index,
computes the NT hash, K1 = HMAC-MD5(NT, msg_type), K3 = HMAC-MD5(K1,
checksum), the RC4 key schedule under K3 and 12 keystream bytes, and
tests (keystream[8:12] ^ edata2[8:12]) & mask == expected, the ticket's
predicted DER header (engines/device/krb5.der_filter_words).  One
launch serves one target; its fields are launch parameters.

Outputs: ``count int32[1]``, the exact number of surviving lanes, and
``lanes int32[hit_capacity]``, the first ``hit_capacity`` of them in no
fixed order, -1 where unused.  ``count > hit_capacity`` sends the batch
to the worker's exact oracle rescan.  A survivor is a *maybe*: the
worker confirms it with the oracle.

Three functions carry it: the kernel's wrapper ``krb5_kernel`` (CUDA
tensors only, launches on the current stream without synchronising,
counts its launches in ``launches``), the same function in plain
PyTorch ``krb5_plain`` (``krb5_filter_batch`` and the masked compare;
lanes ascending), and the dispatcher ``krb5_crack``: the kernel for
CUDA tensors, the plain version for CPU tensors.  ``make_krb5_step``
builds the worker's step on the dispatcher.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from dprf_tpu_torch.generators.mask import decode_lut
from dprf_tpu_torch.ops.cuda_mask import mask_fits, message_block, wave_grid
from dprf_tpu_torch.ops.hmac_md5 import hmac_md5_const_msg, hmac_msg_blocks
from dprf_tpu_torch.ops.md4 import md4_digest_words
from dprf_tpu_torch.ops.pack import pack_varlen
from dprf_tpu_torch.ops.rc4 import rc4_keystream_words

#: longest candidate: NTLM's single-block UTF-16LE limit
MAX_LENGTH = 27
#: threads per block (kThreads in the source)
THREADS = 256
#: RFC 4757 puts 8 random confounder bytes before the DER ticket: the
#: predictable header, the compared keystream word, is bytes [8, 12)
CONF = 8

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_krb5.py:260"
SOURCE = "dprf_tpu_torch/csrc/krb5.cu"
KERNEL = "krb5"

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


def _check_job(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, tgt: Krb5Target,
               hit_capacity: int, batch: int) -> None:
    if lut.dtype != torch.uint8 or lut.dim() != 2 or lut.shape[1] != 256:
        raise ValueError(f"lut must be uint8[length, 256], got "
                         f"{lut.dtype}{list(lut.shape)}")
    length = lut.shape[0]
    if not 1 <= length <= MAX_LENGTH:
        raise ValueError(f"mask length {length} outside 1..{MAX_LENGTH}")
    if len(radices) != length or len(base_digits) != length:
        raise ValueError("radices and base digits need one entry per "
                         "mask position")
    if not all(1 <= r <= 256 for r in radices) or \
            not all(0 <= d < r for d, r in zip(base_digits, radices)):
        raise ValueError("radices must be 1..256 and base digits below them")
    if len(tgt.checksum) != 16:
        raise ValueError("the checksum must be 16 bytes")
    if not 1 <= batch <= (1 << 31) - 256:
        raise ValueError(f"batch {batch} outside 1..2**31-256")
    if not 0 <= n_valid <= batch:
        raise ValueError(f"n_valid {n_valid} outside 0..{batch}")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


class _Args(ctypes.Structure):
    """``struct Krb5Args`` of csrc/krb5.cu."""
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * MAX_LENGTH),
                ("base", ctypes.c_int32 * MAX_LENGTH),
                ("block", ctypes.c_uint32 * 16),
                ("msg_type", ctypes.c_uint32),
                ("checksum", ctypes.c_uint32 * 4),
                ("cipher", ctypes.c_uint32), ("mask", ctypes.c_uint32),
                ("expected", ctypes.c_uint32)]


def kernel_args(radices: Sequence[int], base_digits: Sequence[int],
                tgt: Krb5Target) -> _Args:
    """The launch's parameters: the decode's radices and base digits,
    the widened candidate's fixed block words, the ticket's fields."""
    length = len(radices)
    return _Args(length, (ctypes.c_int32 * MAX_LENGTH)(*radices),
                 (ctypes.c_int32 * MAX_LENGTH)(*base_digits),
                 (ctypes.c_uint32 * 16)(*message_block("ntlm", length)),
                 tgt.msg_type,
                 (ctypes.c_uint32 * 4)(*np.frombuffer(tgt.checksum, "<u4")
                                       .tolist()),
                 tgt.cipher, tgt.mask, tgt.expected)


@functools.cache
def _library():
    """The C entry points, built from csrc/krb5.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("krb5")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_krb5_launch.argtypes = [
        i32, ptr, ctypes.POINTER(_Args), ctypes.c_uint32, ptr, ptr, i32,
        i32, i32, ptr]
    lib.dprf_krb5_launch.restype = i32
    lib.dprf_krb5_blocks_per_sm.argtypes = [i32, ctypes.POINTER(i32)]
    lib.dprf_krb5_blocks_per_sm.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernel now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


def shared_bytes(length: int) -> int:
    """Dynamic shared memory of one block: 256 bytes of RC4 state per
    thread, then the charset tables."""
    return 256 * THREADS + 256 * length


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
                base_digits: Sequence[int], n_valid: int, tgt: Krb5Target,
                hit_capacity: int, batch: int):
    """Launch the kernel over lanes [0, n_valid) of a ``batch``-lane
    step for one ticket: lut uint8[L, 256] (``MaskGenerator.charset_lut``)
    on the card, the radices and the base digits of the batch's first
    candidate as ints.  Returns (count int32[1], lanes int32[cap]) on the
    card, still being computed."""
    if lut.device.type != "cuda":
        raise ValueError(f"the CUDA krb5 kernel takes CUDA tensors, got a "
                         f"lut on {lut.device}")
    _check_job(lut, radices, base_digits, n_valid, tgt, hit_capacity, batch)
    if not lut.is_contiguous():
        raise ValueError("lut must be contiguous")
    device = lut.device
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    smem = shared_bytes(lut.shape[0])
    args = kernel_args(radices, base_digits, tgt)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().dprf_krb5_launch(
        device.index, lut.data_ptr(), ctypes.byref(args), n_valid,
        count.data_ptr(), lanes.data_ptr(), hit_capacity,
        wave_grid(blocks_per_sm(smem), n_valid, device), THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {rc}")
    launches[KERNEL] += 1
    return count, lanes


def krb5_filter_batch(cand: torch.Tensor, lens: torch.Tensor, type_blocks,
                      type_n: int, chk_blocks, chk_n: int, cipher4: int,
                      mask: int) -> torch.Tensor:
    """Candidates uint8[B, L] of lengths int32[B] -> the masked plaintext
    word over bytes [8, 12), int32[B, 1]: NT hash, the two HMACs over
    messages pre-padded by ``hmac_msg_blocks``, RC4, the xor with
    edata2[8:12] (``cipher4``) and ``mask``."""
    nt = md4_digest_words(pack_varlen(cand, lens, big_endian=False,
                                      widen=True))
    k1 = hmac_md5_const_msg(nt, type_blocks, type_n)
    k3 = hmac_md5_const_msg(k1, chk_blocks, chk_n)
    ks = rc4_keystream_words(k3, (CONF + 4) // 4)[:, CONF // 4]
    as_i32 = np.array([cipher4, mask], np.uint32).view(np.int32)
    return ((ks ^ int(as_i32[0])) & int(as_i32[1]))[:, None]


def krb5_plain(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, tgt: Krb5Target,
               hit_capacity: int, batch: int):
    """``krb5_kernel``'s function in plain PyTorch on the lut's device;
    lanes come back in ascending order."""
    _check_job(lut, radices, base_digits, n_valid, tgt, hit_capacity, batch)
    device = lut.device
    cand = decode_lut(lut, radices, base_digits, batch)
    lens = torch.full((batch,), lut.shape[0], dtype=torch.int32,
                      device=device)
    tb, tn = hmac_msg_blocks(tgt.msg_type.to_bytes(4, "little"), 1,
                             "msg_type")
    cb, cn = hmac_msg_blocks(tgt.checksum, 1, "checksum")
    word = krb5_filter_batch(cand, lens, tb, tn, cb, cn, tgt.cipher,
                             tgt.mask)[:, 0]
    expected = int(np.array([tgt.expected], np.uint32).view(np.int32)[0])
    found = (word == expected) & \
        (torch.arange(batch, device=device) < n_valid)
    hits = found.nonzero().flatten().to(torch.int32)
    count = torch.tensor([hits.shape[0]], dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    n = min(hit_capacity, hits.shape[0])
    lanes[:n] = hits[:n]
    return count, lanes


def krb5_crack(lut: torch.Tensor, *args):
    """The kernel on CUDA tensors, its plain version on CPU tensors
    (arguments as ``krb5_kernel``)."""
    if lut.device.type == "cuda":
        return krb5_kernel(lut, *args)
    if lut.device.type == "cpu":
        return krb5_plain(lut, *args)
    raise ValueError(f"no krb5 kernel for device {lut.device}")


def make_krb5_step(gen, batch: int, hit_capacity: int = 64, device="cuda"):
    """The worker's step: step(base_digits, n_valid, tgt) -> (count
    int32[1], lanes int32[cap], None) for one ticket's ``Krb5Target``.
    The charset tables go to ``device`` once, here."""
    if not mask_fits(gen, MAX_LENGTH):
        raise ValueError(
            f"krb5 job not eligible for the kernel: masks of 1.."
            f"{MAX_LENGTH} positions, got {getattr(gen, 'length', None)}")
    lut = gen.charset_lut(torch.device(device))
    radices = gen.radices

    def step(base_digits: Sequence[int], n_valid: int, tgt: Krb5Target):
        return (*krb5_crack(lut, radices, base_digits, n_valid, tgt,
                            hit_capacity, batch), None)

    return step
