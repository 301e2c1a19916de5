"""The PDF RC4 user-password kernel: the counterpart of the JAX
package's ops/pallas_pdf.py (``make_pdf_pallas_fn``,
``make_pdf_crack_step``, ``target_scalars``).

Per candidate the kernel (csrc/pdf.cu) decodes the mask index, runs
Algorithm 2's MD5 over pad32(password) || O and the document's second
block, for R3+ the 50-fold stretch, then RC4: R2 one key schedule and 4
keystream bytes against U[0:4] ^ PAD[0:4]; R3+ the 20-pass cascade over
MD5(PAD || ID) against U[0:16].  One launch serves one document, its
words launch parameters; the kind (revision 2 or 3+, key length 5 or
16) picks one of three instantiations (``KINDS``).

Outputs: ``count int32[1]``, the exact number of matching lanes, and
``lanes int32[hit_capacity]``, the first ``hit_capacity`` of them in no
fixed order, -1 where unused.  ``count > hit_capacity`` sends the batch
to the worker's exact oracle rescan.  An R2 match covers 32 bits of U,
so the worker confirms it with the oracle.

Three functions carry it: the kernel's wrapper ``pdf_kernel`` (CUDA
tensors only, launches on the current stream without synchronising,
counts its launches in ``launches``), the same function in plain
PyTorch ``pdf_plain`` (ops/md5.py, ops/rc4.py; lanes ascending), and the
dispatcher ``pdf_crack``: the kernel for CUDA tensors, the plain version
for CPU tensors.  ``make_pdf_steps`` builds the worker's steps on the
dispatcher.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import struct
from typing import Sequence

import numpy as np
import torch

from dprf_tpu_torch.engines.cpu.pdf import PAD
from dprf_tpu_torch.generators.mask import decode_lut
from dprf_tpu_torch.ops.compare import compact_hits
from dprf_tpu_torch.ops.cuda_mask import check_decode, mask_fits, wave_grid
from dprf_tpu_torch.ops.md5 import md5_compress, md5_digest_words
from dprf_tpu_torch.ops.rc4 import rc4_keystream_bytes, words_to_bytes

#: longest password: Algorithm 2 pads or cuts it to 32 bytes
MAX_LENGTH = 32
#: threads per block (kThreads in the source)
THREADS = 256

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_pdf.py:280"
SOURCE = "dprf_tpu_torch/csrc/pdf.cu"
KERNEL = "pdf"
#: (revision class, key bytes) -> (the source's kind id, the
#: instantiation's name); R4 is R3's kind
KINDS = {(2, 5): (0, "pdf_r2_40"), (3, 5): (1, "pdf_r3_40"),
         (3, 16): (2, "pdf_r3_128")}

#: launches of each instantiation in this process (tests and
#: chip_smoke.py reset and read them)
launches = {name: 0 for _, name in KINDS.values()}

#: PAD[0:4] as a little-endian word: R2's U[0:4] ^ it is the keystream
PAD_W0 = int.from_bytes(PAD[:4], "little")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def block2_words(params: dict) -> np.ndarray:
    """The document-constant second MD5 block of Algorithm 2: P, ID, the
    R4 metadata flag, MD5's padding and bit length (uint32[16])."""
    tail = struct.pack("<i", params["p"]) + params["id"]
    if params["rev"] >= 4 and not params["enc_metadata"]:
        tail += b"\xff\xff\xff\xff"
    if len(tail) > 55:
        raise ValueError(f"$pdf$ ID of {len(params['id'])} bytes: "
                         "Algorithm 2's message passes two blocks")
    total = 64 + len(tail)
    padded = tail + b"\x80" + bytes(55 - len(tail)) + \
        struct.pack("<Q", total * 8)
    return np.frombuffer(padded, "<u4").astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class PdfTarget:
    """One document's launch words (uint32 ints): O, the second block,
    x0 = MD5(PAD || ID) (R3+; zeros for R2) and the compared U words (R2:
    U[0:4] ^ PAD[0:4], then zeros)."""

    o: tuple
    block2: tuple
    x0: tuple
    u: tuple


def target_kernel_args(target) -> tuple:
    """Target -> (kind, PdfTarget), the reference kernel's
    ``target_scalars`` as uint32 ints."""
    p = target.params
    o = tuple(int(w) for w in np.frombuffer(p["o"], "<u4"))
    b2 = tuple(int(w) for w in block2_words(p))
    if p["rev"] == 2:
        x0 = (0, 0, 0, 0)
        u = (int.from_bytes(p["u"][:4], "little") ^ PAD_W0, 0, 0, 0)
    else:
        x0 = tuple(int(w) for w in np.frombuffer(
            hashlib.md5(PAD + p["id"]).digest(), "<u4"))
        u = tuple(int(w) for w in np.frombuffer(p["u"][:16], "<u4"))
    # the kind: revision 2, or 3 for R3 and R4; key bytes
    return (2 if p["rev"] == 2 else 3, p["key_len"]), PdfTarget(o, b2, x0, u)


def pad_fill(length: int) -> tuple:
    """Words 0-7 of Algorithm 2's first block for an all-zero candidate
    of ``length`` bytes: the spec's PAD from byte ``length`` on."""
    fill = bytes(length) + PAD[:32 - length]
    return tuple(int(w) for w in np.frombuffer(fill, "<u4"))


def _check_job(kind: tuple, lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, tgt: PdfTarget,
               hit_capacity: int, batch: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"no pdf kernel for kind {kind} (revision class, "
                         f"key bytes): {sorted(KINDS)}")
    check_decode(lut, radices, base_digits, n_valid, batch, MAX_LENGTH)
    if (len(tgt.o), len(tgt.block2), len(tgt.x0), len(tgt.u)) != \
            (8, 16, 4, 4):
        raise ValueError("a pdf target holds 8 O, 16 block, 4 x0 and 4 U "
                         "words")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


class _Args(ctypes.Structure):
    """``struct PdfArgs`` of csrc/pdf.cu."""
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * MAX_LENGTH),
                ("base", ctypes.c_int32 * MAX_LENGTH),
                ("block1", ctypes.c_uint32 * 16),
                ("block2", ctypes.c_uint32 * 16),
                ("x0", ctypes.c_uint32 * 4), ("u", ctypes.c_uint32 * 4)]


def kernel_args(radices: Sequence[int], base_digits: Sequence[int],
                tgt: PdfTarget) -> _Args:
    """The launch's parameters: the decode's radices and base digits,
    the first block's fixed words (PAD fill, O), the document's words."""
    length = len(radices)
    return _Args(length, (ctypes.c_int32 * MAX_LENGTH)(*radices),
                 (ctypes.c_int32 * MAX_LENGTH)(*base_digits),
                 (ctypes.c_uint32 * 16)(*pad_fill(length), *tgt.o),
                 (ctypes.c_uint32 * 16)(*tgt.block2),
                 (ctypes.c_uint32 * 4)(*tgt.x0),
                 (ctypes.c_uint32 * 4)(*tgt.u))


@functools.cache
def _library():
    """The C entry points, built from csrc/pdf.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("pdf")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_pdf_launch.argtypes = [
        i32, i32, ptr, ctypes.POINTER(_Args), ctypes.c_uint32, ptr, ptr,
        i32, i32, i32, ptr]
    lib.dprf_pdf_launch.restype = i32
    lib.dprf_pdf_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.dprf_pdf_blocks_per_sm.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernels now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


def shared_bytes(length: int) -> int:
    """Dynamic shared memory of one block: 256 bytes of RC4 state per
    thread, then the charset tables."""
    return 256 * THREADS + 256 * length


@functools.cache
def blocks_per_sm(kind: tuple, smem: int) -> int:
    """Resident blocks per SM of ``kind``'s instantiation at ``smem``
    bytes, from the CUDA occupancy calculator (the RC4 states in shared
    memory limit it)."""
    blocks = ctypes.c_int(0)
    rc = _library().dprf_pdf_blocks_per_sm(KINDS[kind][0], smem,
                                           ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


def pdf_kernel(kind: tuple, lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, tgt: PdfTarget,
               hit_capacity: int, batch: int):
    """Launch ``kind``'s instantiation over lanes [0, n_valid) of a
    ``batch``-lane step for one document: lut uint8[L, 256] on the card,
    the radices and the base digits of the batch's first candidate as
    ints.  Returns (count int32[1], lanes int32[cap]) on the card, still
    being computed."""
    if lut.device.type != "cuda":
        raise ValueError(f"the CUDA pdf kernel takes CUDA tensors, got a "
                         f"lut on {lut.device}")
    _check_job(kind, lut, radices, base_digits, n_valid, tgt, hit_capacity,
               batch)
    if not lut.is_contiguous():
        raise ValueError("lut must be contiguous")
    device = lut.device
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    smem = shared_bytes(lut.shape[0])
    args = kernel_args(radices, base_digits, tgt)
    kid, name = KINDS[kind]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().dprf_pdf_launch(
        kid, device.index, lut.data_ptr(), ctypes.byref(args), n_valid,
        count.data_ptr(), lanes.data_ptr(), hit_capacity,
        wave_grid(blocks_per_sm(kind, smem), n_valid, device), THREADS,
        stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    return count, lanes


def _i32(words) -> torch.Tensor:
    return torch.as_tensor(np.array(words, np.uint32).view(np.int32))


def pdf_u_words(kind: tuple, cand: torch.Tensor, tgt: PdfTarget):
    """Candidates uint8[B, L] -> the words the kernel compares,
    int32[B, 4] (R2: the first keystream word, then zeros), in plain
    torch: Algorithm 2, the stretch, RC4 (ops/md5.py, ops/rc4.py)."""
    rev, key_len = kind
    B, length = cand.shape
    device = cand.device
    msg = torch.zeros((B, 64), dtype=torch.int32, device=device)
    msg[:, :32] = torch.as_tensor(np.frombuffer(
        (bytes(length) + PAD)[:32], np.uint8).astype(np.int32),
        device=device)
    msg[:, :length] = cand.to(torch.int32)
    msg[:, 32:] = torch.as_tensor(np.frombuffer(
        np.array(tgt.o, np.uint32).astype("<u4").tobytes(), np.uint8)
        .astype(np.int32), device=device)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=device)
    block1 = (msg.reshape(B, 16, 4) << shifts).sum(dim=2, dtype=torch.int32)
    digest = md5_compress(md5_digest_words(block1),
                          _i32(tgt.block2).to(device).expand(B, 16))
    if rev >= 3:
        nw, rem = divmod(key_len, 4)
        for _ in range(50):
            w = torch.zeros((B, 16), dtype=torch.int32, device=device)
            w[:, :nw] = digest[:, :nw]
            if rem:
                w[:, nw] = (digest[:, nw] & ((1 << 8 * rem) - 1)) | \
                    (0x80 << 8 * rem)
            else:
                w[:, nw] = 0x80
            w[:, 14] = 8 * key_len
            digest = md5_digest_words(w)
    key = words_to_bytes(digest)[:, :key_len]
    if rev == 2:
        out = torch.zeros((B, 4), dtype=torch.int32, device=device)
        out[:, 0] = rc4_keystream_bytes(key, 1)[:, 0]
        return out
    x = _i32(tgt.x0).to(device).expand(B, 4)
    for p in range(20):
        x = x ^ rc4_keystream_bytes(key ^ p, 4)
    return x


def pdf_plain(kind: tuple, lut: torch.Tensor, radices: Sequence[int],
              base_digits: Sequence[int], n_valid: int, tgt: PdfTarget,
              hit_capacity: int, batch: int):
    """``pdf_kernel``'s function in plain PyTorch on the lut's device;
    lanes come back in ascending order."""
    _check_job(kind, lut, radices, base_digits, n_valid, tgt, hit_capacity,
               batch)
    device = lut.device
    cand = decode_lut(lut, radices, base_digits, n_valid)
    words = pdf_u_words(kind, cand, tgt)
    found = (words == _i32(tgt.u).to(device)).all(dim=1)
    count, lanes, _ = compact_hits(found, torch.zeros_like(
        found, dtype=torch.int32), hit_capacity)
    return count, lanes


def pdf_crack(kind: tuple, lut: torch.Tensor, *args):
    """The kernel on CUDA tensors, its plain version on CPU tensors
    (arguments as ``pdf_kernel``)."""
    if lut.device.type == "cuda":
        return pdf_kernel(kind, lut, *args)
    if lut.device.type == "cpu":
        return pdf_plain(kind, lut, *args)
    raise ValueError(f"no pdf kernel for device {lut.device}")


def make_pdf_steps(gen, docs: Sequence[tuple], batch: int,
                   hit_capacity: int = 64, device="cuda") -> list:
    """The worker's steps, one a document of ``docs`` ((kind, tgt) each,
    ``target_kernel_args``): step(base_digits, n_valid) -> (count
    int32[1], lanes int32[cap], None).  The charset tables go to
    ``device`` once, here."""
    if not mask_fits(gen, MAX_LENGTH):
        raise ValueError(
            f"pdf job not eligible for the kernel: masks of 1.."
            f"{MAX_LENGTH} positions, got {getattr(gen, 'length', None)}")
    lut = gen.charset_lut(torch.device(device))
    radices = gen.radices

    def step(kind: tuple, tgt: PdfTarget, base_digits: Sequence[int],
             n_valid: int):
        return (*pdf_crack(kind, lut, radices, base_digits, n_valid, tgt,
                           hit_capacity, batch), None)

    return [functools.partial(step, kind, tgt) for kind, tgt in docs]
