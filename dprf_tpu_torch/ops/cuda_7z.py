"""The 7-Zip KDF kernel: the counterpart of the JAX package's
ops/pallas_7z.py (``make_7z_kdf_pallas_fn``, ``_kdf_lanes``,
``sevenzip_kernel_eligible``).

Per candidate the kernel (csrc/sevenzip.cu) decodes the mask index,
hashes the 2^cycles-unit stream salt || UTF-16LE(password) || LE64(i)
with SHA-256 and writes the 8 state words: ``int32[n_valid, 8]`` (the
uint32 words' bit patterns), candidate-major.  The salt (at most 16
bytes), its length, the mask length and cycles are launch parameters,
so one build serves every job.  The verdict (AES-256-CBC, CRC32) runs
after it in torch (engines/device/sevenzip.py).

Three functions carry it: the kernel's wrapper ``sevenzip_kdf_kernel``
(CUDA tensors only, launches on the current stream without
synchronising, counts its launches in ``launches``), the same function
in plain PyTorch ``sevenzip_kdf_plain`` (int32 words on ops/sha256.py),
and the dispatcher ``sevenzip_kdf``: the kernel for CUDA tensors, the
plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch

from dprf_tpu_torch.generators.mask import decode_lut
from dprf_tpu_torch.ops.cuda_mask import check_decode, wave_grid
from dprf_tpu_torch.ops.int32 import as_i32
from dprf_tpu_torch.ops.sha256 import INIT, sha256_compress

#: longest password (hashcat's 7-Zip limit; 54 UTF-16LE bytes)
MAX_LENGTH = 27
#: longest salt the kernel's launch parameters hold
MAX_SALT = 16
#: the largest cycles power: the counter stays below 2^24, three bytes
MAX_CYCLES = 24
#: threads per block (kThreads in the source)
THREADS = 256
#: bytes of one thread's stream window in shared memory (kWindowBytes)
WINDOW_BYTES = 4 * (((MAX_SALT + 2 * MAX_LENGTH + 8 - 1) >> 2) + 17)

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_7z.py:134"
SOURCE = "dprf_tpu_torch/csrc/sevenzip.cu"
KERNEL = "sevenzip_kdf"

#: launches of the kernel in this process (tests and chip_smoke.py reset
#: and read it)
launches = {KERNEL: 0}


def reset_launches() -> None:
    launches[KERNEL] = 0


def unit_bytes(length: int, salt_len: int) -> int:
    """One counter unit: salt, the UTF-16LE password, the LE64 counter."""
    return salt_len + 2 * length + 8


def stream_refusal(length: int, salt_len: int, cycles: int) -> Optional[str]:
    """Why the kernel does not take this stream, or None: cycles in
    1..24, a salt of at most 16 bytes, and 2^cycles units that tile
    whole 64-byte blocks (the reference's ``sevenzip_kernel_eligible``;
    true for every mask at cycles >= 6)."""
    if not 0 < cycles <= MAX_CYCLES:
        return f"a cycles power of {cycles} (the kernel takes 1..{MAX_CYCLES})"
    if salt_len > MAX_SALT:
        return f"a salt of {salt_len} bytes (the kernel takes at most " \
               f"{MAX_SALT})"
    unit = unit_bytes(length, salt_len)
    per_group = 64 // math.gcd(64, unit)
    if (1 << cycles) % per_group:
        return (f"2^{cycles} units of {unit} bytes, which do not tile whole "
                "64-byte blocks")
    return None


def _check_job(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int, salt: bytes,
               cycles: int, batch: int) -> None:
    check_decode(lut, radices, base_digits, n_valid, batch, MAX_LENGTH)
    why = stream_refusal(lut.shape[0], len(salt), cycles)
    if why is not None:
        raise ValueError(f"no 7z KDF kernel for {why}")


class _Args(ctypes.Structure):
    """``struct SevenZipArgs`` of csrc/sevenzip.cu."""
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * MAX_LENGTH),
                ("base", ctypes.c_int32 * MAX_LENGTH),
                ("salt_len", ctypes.c_int32),
                ("salt", ctypes.c_uint8 * MAX_SALT),
                ("cycles", ctypes.c_int32)]


def kernel_args(radices: Sequence[int], base_digits: Sequence[int],
                salt: bytes, cycles: int) -> _Args:
    """The launch's parameters: the decode's radices and base digits,
    the salt and cycles."""
    return _Args(len(radices), (ctypes.c_int32 * MAX_LENGTH)(*radices),
                 (ctypes.c_int32 * MAX_LENGTH)(*base_digits), len(salt),
                 (ctypes.c_uint8 * MAX_SALT)(*salt), int(cycles))


@functools.cache
def _library():
    """The C entry points, built from csrc/sevenzip.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("sevenzip")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_7z_launch.argtypes = [
        i32, ptr, ctypes.POINTER(_Args), ctypes.c_uint32, ptr, i32, i32, ptr]
    lib.dprf_7z_launch.restype = i32
    lib.dprf_7z_blocks_per_sm.argtypes = [i32, ctypes.POINTER(i32)]
    lib.dprf_7z_blocks_per_sm.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernel now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


def shared_bytes(length: int) -> int:
    """Dynamic shared memory of one block: each thread's stream window,
    the salt, then the charset tables."""
    return WINDOW_BYTES * THREADS + MAX_SALT + 256 * length


@functools.cache
def blocks_per_sm(smem: int) -> int:
    """Resident blocks per SM at ``smem`` bytes, from the CUDA occupancy
    calculator."""
    blocks = ctypes.c_int(0)
    rc = _library().dprf_7z_blocks_per_sm(smem, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


def resident_lanes(length: int, device) -> int:
    """Candidates one resident wave of the grid holds on ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * blocks_per_sm(shared_bytes(length)) * THREADS


def sevenzip_kdf_kernel(lut: torch.Tensor, radices: Sequence[int],
                        base_digits: Sequence[int], n_valid: int,
                        salt: bytes, cycles: int,
                        batch: int) -> torch.Tensor:
    """Launch the kernel over lanes [0, n_valid) of a ``batch``-lane
    step: lut uint8[L, 256] on the card, the radices and the base digits
    of the batch's first candidate as ints.  Returns int32[n_valid, 8]
    on the card, still being computed."""
    if lut.device.type != "cuda":
        raise ValueError(f"the CUDA 7z KDF kernel takes CUDA tensors, got "
                         f"a lut on {lut.device}")
    _check_job(lut, radices, base_digits, n_valid, salt, cycles, batch)
    if not lut.is_contiguous():
        raise ValueError("lut must be contiguous")
    device = lut.device
    out = torch.empty((n_valid, 8), dtype=torch.int32, device=device)
    if n_valid == 0:
        return out
    args = kernel_args(radices, base_digits, salt, cycles)
    smem = shared_bytes(lut.shape[0])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library().dprf_7z_launch(
        device.index, lut.data_ptr(), ctypes.byref(args), n_valid,
        out.data_ptr(), wave_grid(blocks_per_sm(smem), n_valid, device),
        THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} kernel launch failed: CUDA error {rc}")
    launches[KERNEL] += 1
    return out


def _counter_words(n_blocks: int, unit: int, ctr: int) -> np.ndarray:
    """uint32[n_blocks, 16]: each block's counter bytes alone, as
    big-endian message words (the same for every lane)."""
    pos = np.arange(64 * n_blocks, dtype=np.int64)
    u, off = np.divmod(pos, unit)
    k = off - ctr                        # the counter's byte index, or < 0
    byte = np.where(k >= 0, (u >> (8 * np.clip(k, 0, 7))) & 0xFF, 0)
    byte = byte.reshape(n_blocks, 16, 4).astype(np.uint32)
    return (byte[..., 0] << 24) | (byte[..., 1] << 16) | \
        (byte[..., 2] << 8) | byte[..., 3]


def sevenzip_kdf_plain(lut: torch.Tensor, radices: Sequence[int],
                       base_digits: Sequence[int], n_valid: int, salt: bytes,
                       cycles: int, batch: int) -> torch.Tensor:
    """``sevenzip_kdf_kernel``'s function in plain PyTorch on the lut's
    device: the stream's blocks repeat their image columns every
    lcm(64, unit) bytes, so each block is one of those column sets
    packed once, or'ed with its counter bytes."""
    _check_job(lut, radices, base_digits, n_valid, salt, cycles, batch)
    device = lut.device
    cand = decode_lut(lut, radices, base_digits, n_valid).to(torch.int32)
    length = lut.shape[0]
    ctr = len(salt) + 2 * length
    unit = ctr + 8
    image = torch.zeros((n_valid, unit), dtype=torch.int32, device=device)
    image[:, :len(salt)] = torch.as_tensor(
        np.frombuffer(salt, np.uint8).astype(np.int32), device=device)
    image[:, len(salt):ctr:2] = cand
    n_blocks = (unit << cycles) // 64
    per_group = unit // math.gcd(64, unit)       # distinct column sets
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int32, device=device)
    columns = []
    for b in range(min(per_group, n_blocks)):
        idx = torch.as_tensor((64 * b + np.arange(64)) % unit, device=device)
        col = image[:, idx].reshape(n_valid, 16, 4) << shifts
        columns.append(col[..., 0] | col[..., 1] | col[..., 2] | col[..., 3])
    counters = torch.as_tensor(
        _counter_words(n_blocks, unit, ctr).view(np.int32), device=device)
    state = torch.tensor(as_i32(INIT), dtype=torch.int32,
                         device=device).expand(n_valid, 8)
    for b in range(n_blocks):
        state = sha256_compress(state, columns[b % per_group] | counters[b])
    bits = (unit << cycles) * 8
    pad = np.zeros(16, np.uint32)
    pad[0], pad[14], pad[15] = 0x80000000, bits >> 32, bits & 0xFFFFFFFF
    pad = torch.as_tensor(pad.view(np.int32), device=device)
    return sha256_compress(state, pad.expand(n_valid, 16)).contiguous()


def sevenzip_kdf(lut: torch.Tensor, *args) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors
    (arguments as ``sevenzip_kdf_kernel``)."""
    if lut.device.type == "cuda":
        return sevenzip_kdf_kernel(lut, *args)
    if lut.device.type == "cpu":
        return sevenzip_kdf_plain(lut, *args)
    raise ValueError(f"no 7z KDF kernel for device {lut.device}")
