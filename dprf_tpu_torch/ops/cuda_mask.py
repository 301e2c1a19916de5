"""The fused mask -> MD5 -> compare kernel: the counterpart of the JAX
package's ops/pallas_mask.py for the md5 core with one target.

Per candidate the kernel (csrc/mask_md5.cu) decodes the mixed-radix
keyspace index into charset bytes, packs one padded block, runs the MD5
rounds and compares the digest with the target; only hits write
anything back.  Outputs per launch: ``count int32[1]``, the exact
number of hits, and ``lanes int32[hit_capacity]``, the batch lanes of
the first ``hit_capacity`` hits in no fixed order, -1 where unused.
``count > hit_capacity`` sends the batch to the worker's exact oracle
rescan, the reference's contract.

Three functions carry it:

- ``mask_md5_kernel``: the wrapper of the CUDA kernel.  It takes CUDA
  tensors only, checks them, allocates the outputs, launches on the
  current stream without synchronising, and counts its launches in
  ``mask_md5_kernel.launches``;
- ``mask_crack_plain``: the same function in plain PyTorch;
- ``mask_md5``: the kernel for CUDA tensors, the plain version for CPU
  tensors.  ``make_cuda_mask_crack_step`` builds the worker's step on
  it, so one step serves ``--device cuda`` and ``--device torch-cpu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from dprf_tpu_torch.generators.mask import decode_lut
from dprf_tpu_torch.ops import compare as cmp_ops
from dprf_tpu_torch.ops.md5 import md5_digest_words
from dprf_tpu_torch.ops.pack import pack_fixed
from dprf_tpu_torch.ops.pipeline import target_words_from_numpy

#: longest mask a single 64-byte MD5 block holds (DPRF_MAX_LEN in the source)
MAX_LENGTH = 55
#: threads per block (the kernel's __launch_bounds__)
THREADS = 256
#: blocks per SM of the grid-stride grid: an SM holds at most 2048
#: threads, i.e. 8 blocks of 256, so the whole grid is resident at once
BLOCKS_PER_SM = 8

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_mask.py:733"
SOURCE = "dprf_tpu_torch/csrc/mask_md5.cu"


def kernel_eligible(engine_name: str, gen, n_targets: int) -> bool:
    """Whether the kernel takes this job: md5, one target, a mask of
    1..55 positions with 1..256 bytes each."""
    return (engine_name == "md5" and n_targets == 1
            and hasattr(gen, "charsets")
            and 1 <= gen.length <= MAX_LENGTH
            and all(1 <= len(cs) <= 256 for cs in gen.charsets))


def check_batch(batch: int) -> None:
    """Lane arithmetic is 32-bit: the first mixed-radix addition
    computes base_digit + lane with base_digit <= 255, so a batch needs
    256 of headroom below 2^31."""
    if not 1 <= batch <= (1 << 31) - 256:
        raise ValueError(f"batch {batch} outside 1..2**31-256")


def ops_per_candidate(length: int) -> int:
    """The least 32-bit integer instructions a candidate of a
    ``length``-position mask needs, counted from the kernel source in
    Hopper's instruction forms.  Each of the 64 MD5 steps is one LOP3
    (any round function), one IADD3 (a + f + K, with a message word
    that is the same for every candidate of the job folded into K) and
    one LEA.HI (rotate and add b) = 192.  Only the ceil(length / 4)
    words holding candidate bytes vary between candidates; each is used
    in 4 steps and costs one more add there.  The feed-forward folds
    into the target words, the compare is 4 set-predicates and the
    decode 4 per position (add, divide, multiply-subtract for the
    remainder, multiply-add into the message word, each counted as
    one)."""
    return 3 * 64 + 4 * -(-length // 4) + 4 + 4 * length


def _check_job(lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int,
               target: Sequence[int], hit_capacity: int, batch: int) -> None:
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
    if len(target) != 4:
        raise ValueError("md5 needs 4 target words")
    check_batch(batch)
    if not 0 <= n_valid <= batch:
        raise ValueError(f"n_valid {n_valid} outside 0..{batch}")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


class _MaskArgs(ctypes.Structure):
    """``struct MaskArgs`` of csrc/mask_md5.cu."""
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * MAX_LENGTH),
                ("base", ctypes.c_int32 * MAX_LENGTH)]


@functools.cache
def _launcher():
    """The C entry point, built from csrc/mask_md5.cu at first use."""
    from dprf_tpu_torch.ops import _build
    fn = _build.load("mask_md5").dprf_mask_md5_launch
    ptr, u32, i32 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    fn.argtypes = [i32, ptr, ctypes.POINTER(_MaskArgs), u32,
                   u32, u32, u32, u32, ptr, ptr, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def load_kernel() -> None:
    """Build and load the kernel now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _launcher()


def mask_md5_kernel(lut: torch.Tensor, radices: Sequence[int],
                    base_digits: Sequence[int], n_valid: int,
                    target: Sequence[int], hit_capacity: int, batch: int):
    """Launch the CUDA kernel over lanes [0, n_valid) of a ``batch``-lane
    step: lut uint8[L, 256] on the card (``MaskGenerator.charset_lut``),
    the radices and the base digits of the batch's first candidate as
    ints, the target as 4 uint32 ints.  Returns (count int32[1],
    lanes int32[hit_capacity]) on the card, still being computed."""
    if lut.device.type != "cuda":
        raise ValueError(f"the CUDA mask kernel takes CUDA tensors, got "
                         f"a lut on {lut.device}")
    if not lut.is_contiguous():
        raise ValueError("lut must be contiguous")
    _check_job(lut, radices, base_digits, n_valid, target, hit_capacity,
               batch)
    device = lut.device
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    length = lut.shape[0]
    args = _MaskArgs(length, (ctypes.c_int32 * MAX_LENGTH)(*radices),
                     (ctypes.c_int32 * MAX_LENGTH)(*base_digits))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = max(1, min(-(-n_valid // THREADS), sms * BLOCKS_PER_SM))
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _launcher()(device.index, lut.data_ptr(), ctypes.byref(args),
                     n_valid, *(int(w) & 0xFFFFFFFF for w in target),
                     count.data_ptr(), lanes.data_ptr(), hit_capacity,
                     grid, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"mask_md5 kernel launch failed: CUDA error {rc}")
    mask_md5_kernel.launches += 1
    return count, lanes


#: launches of the CUDA kernel in this process (tests and chip_smoke.py
#: reset it to 0 and read it back)
mask_md5_kernel.launches = 0


def mask_crack_plain(lut: torch.Tensor, radices: Sequence[int],
                     base_digits: Sequence[int], n_valid: int,
                     target: Sequence[int], hit_capacity: int, batch: int):
    """The kernel's function in plain PyTorch on the lut's device; hit
    lanes come back in ascending order."""
    _check_job(lut, radices, base_digits, n_valid, target, hit_capacity,
               batch)
    device = lut.device
    lane = torch.arange(batch, dtype=torch.int32, device=device)
    cand = decode_lut(lut, radices, base_digits, batch)
    digest = md5_digest_words(pack_fixed(cand, lut.shape[0]))
    want = target_words_from_numpy(np.asarray(target, np.uint32), device)
    found = cmp_ops.compare_single(digest, want) & (lane < n_valid)
    count, lanes, _ = cmp_ops.compact_hits(found, torch.zeros_like(lane),
                                           hit_capacity)
    return count, lanes


def mask_md5(lut: torch.Tensor, radices: Sequence[int],
             base_digits: Sequence[int], n_valid: int,
             target: Sequence[int], hit_capacity: int, batch: int):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if lut.device.type == "cuda":
        return mask_md5_kernel(lut, radices, base_digits, n_valid, target,
                               hit_capacity, batch)
    if lut.device.type == "cpu":
        return mask_crack_plain(lut, radices, base_digits, n_valid, target,
                                hit_capacity, batch)
    raise ValueError(f"no mask kernel for device {lut.device}")


def make_cuda_mask_crack_step(gen, target_words: np.ndarray, batch: int,
                              hit_capacity: int = 64, device="cuda"):
    """The worker's step over the kernel: step(base_digits, n_valid) ->
    (count int32[1], lanes int32[hit_capacity], tpos
    int32[hit_capacity]), with base_digits the host digit list of the
    batch's first candidate (``gen.digits``) and tpos all 0 (one
    target).  target_words: uint32[4], the reference's
    ``target_words``."""
    if not kernel_eligible("md5", gen, 1):
        raise ValueError("mask job not eligible for the md5 mask kernel "
                         f"(length {gen.length}, 1..{MAX_LENGTH} positions)")
    check_batch(batch)
    device = torch.device(device)
    lut = gen.charset_lut(device)
    radices = gen.radices
    target = [int(w) for w in np.asarray(target_words, np.uint32).ravel()]
    tpos = torch.zeros((hit_capacity,), dtype=torch.int32, device=device)

    def step(base_digits: Sequence[int], n_valid: int):
        count, lanes = mask_md5(lut, radices, base_digits, n_valid, target,
                                hit_capacity, batch)
        return count, lanes, tpos

    return step
