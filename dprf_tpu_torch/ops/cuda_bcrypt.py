"""The bcrypt kernels: the counterpart of the JAX package's
ops/pallas_bcrypt.py (the ChunkedEks ``advance``) and of the XLA stages
around it in ops/blowfish.py (``eks_setup_begin``,
``bcrypt_digest_words`` + ``compare_digest_words``).

A batch's state is P int32[B, 18] and S int32[B, 1024] on the card;
three kernels (csrc/bcrypt.cu) carry a candidate through bcrypt:

- ``setup``: fresh P/S, then the salted ExpandKey(key);
- ``advance``: n rounds of the cost loop {ExpandKey(key);
  ExpandKey(salt)}, in place on the card (the state is the caller's and
  is returned, updated);
- ``finish``: the 64 x 3 encryptions of the magic text, the digest
  words int32[B, 6] and the 23-byte compare with one target; hits
  append their lane, ``count > hit_capacity`` sends the batch to the
  worker's exact rescan.

For each stage three functions: the kernel's wrapper (``*_kernel``:
CUDA tensors only, launches on the current stream without
synchronising, counts its launches in ``launches``), the same function
in plain PyTorch (``*_plain``, ops/blowfish.py) and the dispatcher
(``eks_setup``, ``eks_advance``, ``eks_finish``): the kernel for CUDA
tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from dprf_tpu_torch.ops import blowfish as bf

#: the candidates each warp of a block holds (kLanes, kLanes, kLanes,
#: kLast in the source); a warp's S-boxes interleave its candidates
WARPS = (16, 16, 16, 8)
#: candidates per block (kCands in the source): their S-boxes take 224 KB
#: of shared memory, so an SM holds one block, 56 candidates
BLOCK = sum(WARPS)


def shared_word(t: int, e: int) -> int:
    """The shared-memory word of S entry e (0..1023) of the block's
    candidate t: entry e of its warp's lane at e * (the warp's
    candidates) + lane, after the regions of the warps before it (the
    kernels' word_of)."""
    w = min(t // WARPS[0], len(WARPS) - 1)
    lane = t - w * WARPS[0]
    return sum(WARPS[:w]) * 1024 + e * WARPS[w] + lane


#: the TPU kernel these replace, and their source
REPLACES = "dprf_tpu/ops/pallas_bcrypt.py:171"
SOURCE = "dprf_tpu_torch/csrc/bcrypt.cu"
#: the kernels by stage; their ids in the C interface follow this order
KERNELS = ("bcrypt_setup", "bcrypt_advance", "bcrypt_finish")

#: launches of each kernel in this process (tests and chip_smoke.py
#: reset and read them)
launches = {k: 0 for k in KERNELS}
#: cost rounds the ``advance`` launches asked for, summed (the chunking's
#: total, read beside the launch count)
advanced_rounds = 0


def reset_launches() -> None:
    global advanced_rounds
    for k in launches:
        launches[k] = 0
    advanced_rounds = 0


class _Salt4(ctypes.Structure):
    _fields_ = [("w", ctypes.c_uint32 * 4)]


class _Salt18(ctypes.Structure):
    _fields_ = [("w", ctypes.c_uint32 * 18)]


class _Target6(ctypes.Structure):
    _fields_ = [("w", ctypes.c_uint32 * 6)]


def _u32(words, n: int) -> tuple:
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    if w.shape != (n,):
        raise ValueError(f"need {n} words, got shape {w.shape}")
    return tuple(int(x) for x in w)


@functools.cache
def _library():
    """The C entry points, built from csrc/bcrypt.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("bcrypt")
    if lib.dprf_bcrypt_block() != BLOCK:
        raise RuntimeError(f"csrc/bcrypt.cu takes {lib.dprf_bcrypt_block()} "
                           f"candidates a block, the wrapper {BLOCK}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_bcrypt_setup.argtypes = [i32, ptr, ptr, ptr, ptr,
                                      ctypes.POINTER(_Salt4), i32, ptr]
    lib.dprf_bcrypt_advance.argtypes = [i32, ptr, ptr, ptr,
                                        ctypes.POINTER(_Salt18), i32, i32,
                                        ptr]
    lib.dprf_bcrypt_finish.argtypes = [i32, ptr, ptr, ptr, i32,
                                       ctypes.POINTER(_Target6), i32, ptr,
                                       ptr, ptr, i32, ptr]
    lib.dprf_bcrypt_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32),
                                              ctypes.POINTER(i32)]
    for fn in (lib.dprf_bcrypt_setup, lib.dprf_bcrypt_advance,
               lib.dprf_bcrypt_finish, lib.dprf_bcrypt_blocks_per_sm):
        fn.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernels now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


@functools.cache
def occupancy(device_index: int, kernel: str) -> tuple:
    """(resident blocks per SM, shared bytes per block) of one kernel,
    from the CUDA occupancy calculator after the shared-memory opt-in;
    a refused opt-in or no resident block raises."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _library().dprf_bcrypt_blocks_per_sm(
        device_index, KERNELS.index(kernel), ctypes.byref(blocks),
        ctypes.byref(smem))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"{kernel}: shared-memory opt-in or occupancy "
                           f"query failed: CUDA error {rc}, {blocks.value} "
                           "blocks per SM")
    return blocks.value, smem.value


def resident_batch(device) -> int:
    """Candidates one wave of the card holds: SMs x resident blocks x
    BLOCK (7,392 on a 132-SM H100 at one block per SM)."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * min(occupancy(device.index or 0, k)[0]
                     for k in KERNELS) * BLOCK


def _check_state(P: torch.Tensor, S: torch.Tensor,
                 key_words: Optional[torch.Tensor] = None) -> None:
    B = P.shape[0] if P.dim() == 2 else -1
    for name, t, w in (("P", P, 18), ("S", S, 1024), ("key words",
                                                      key_words, 18)):
        if t is None:
            continue
        if t.dtype != torch.int32 or list(t.shape) != [B, w]:
            raise ValueError(f"{name} must be int32[B, {w}] with P's B, "
                             f"got {t.dtype}{list(t.shape)}")
        if t.device != P.device:
            raise ValueError(f"{name} on {t.device}, P on {P.device}")
    if B < 1:
        raise ValueError("empty batch")


def _cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA bcrypt kernels take CUDA tensors, got "
                         f"{what} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def _init_state(device) -> torch.Tensor:
    """The initial P then S (the hex digits of pi), int32[1042], once
    per device."""
    return torch.as_tensor(np.concatenate([bf.P0, bf.S0]).view(np.int32),
                           device=device)


def _launched(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    launches[kernel] += 1


def setup_kernel(key_words: torch.Tensor, salt_words):
    """Launch ``setup`` over key_words int32[B, 18] on the card with the
    salt's 4 uint32 words.  Returns (P int32[B, 18], S int32[B, 1024]),
    still being computed."""
    _cuda(key_words, "key words")
    B, device = key_words.shape[0], key_words.device
    P = torch.empty((B, 18), dtype=torch.int32, device=device)
    S = torch.empty((B, 1024), dtype=torch.int32, device=device)
    _check_state(P, S, key_words)
    occupancy(device.index, "bcrypt_setup")
    rc = _library().dprf_bcrypt_setup(
        device.index, P.data_ptr(), S.data_ptr(), key_words.data_ptr(),
        _init_state(device).data_ptr(),
        ctypes.byref(_Salt4(_u32(salt_words, 4))), B, _stream(device))
    _launched("bcrypt_setup", rc)
    return P, S


def advance_kernel(P: torch.Tensor, S: torch.Tensor,
                   key_words: torch.Tensor, salt18, n: int):
    """Launch ``advance``: n cost rounds over the state on the card, in
    place; salt18 the 18 uint32 words of ExpandKey(salt)
    (``blowfish.salt18_words``).  Returns (P, S), still being
    computed."""
    for t, what in ((P, "P"), (S, "S"), (key_words, "key words")):
        _cuda(t, what)
    _check_state(P, S, key_words)
    if not 0 <= n < 1 << 31:
        raise ValueError(f"rounds {n} outside 0..2**31-1")
    device = P.device
    occupancy(device.index, "bcrypt_advance")
    rc = _library().dprf_bcrypt_advance(
        device.index, P.data_ptr(), S.data_ptr(), key_words.data_ptr(),
        ctypes.byref(_Salt18(_u32(salt18, 18))), int(n), P.shape[0],
        _stream(device))
    _launched("bcrypt_advance", rc)
    global advanced_rounds
    advanced_rounds += int(n)
    return P, S


def finish_kernel(P: torch.Tensor, S: torch.Tensor,
                  valid: Optional[torch.Tensor], n_valid: int, target_words,
                  hit_capacity: int):
    """Launch ``finish``: lane c counts if c < n_valid and valid[c]
    (valid bool[B] on the card, or None for all); target_words the
    target's 6 uint32 words (``blowfish.digest_to_words``).  Returns
    (count int32[1], lanes int32[cap], digest int32[B, 6]), still being
    computed."""
    for t, what in ((P, "P"), (S, "S")):
        _cuda(t, what)
    _check_state(P, S)
    B, device = P.shape[0], P.device
    _check_finish(B, valid, n_valid, hit_capacity, device)
    if valid is not None:
        _cuda(valid, "valid")
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32, device=device)
    digest = torch.empty((B, 6), dtype=torch.int32, device=device)
    occupancy(device.index, "bcrypt_finish")
    rc = _library().dprf_bcrypt_finish(
        device.index, P.data_ptr(), S.data_ptr(),
        None if valid is None else valid.data_ptr(), int(n_valid),
        ctypes.byref(_Target6(_u32(target_words, 6))), B, digest.data_ptr(),
        count.data_ptr(), lanes.data_ptr(), hit_capacity, _stream(device))
    _launched("bcrypt_finish", rc)
    return count, lanes, digest


def _check_finish(B: int, valid, n_valid: int, hit_capacity: int,
                  device) -> None:
    if valid is not None and (valid.dtype != torch.bool
                              or list(valid.shape) != [B]
                              or valid.device != device):
        raise ValueError(f"valid must be bool[{B}] on {device}")
    if not 0 <= n_valid <= B:
        raise ValueError(f"n_valid {n_valid} outside 0..{B}")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


def setup_plain(key_words: torch.Tensor, salt_words):
    """``setup_kernel``'s function in plain PyTorch."""
    return bf.eks_setup_begin(key_words, np.asarray(salt_words))


def advance_plain(P: torch.Tensor, S: torch.Tensor, key_words: torch.Tensor,
                  salt18, n: int):
    """``advance_kernel``'s function in plain PyTorch (new tensors)."""
    _check_state(P, S, key_words)
    return bf.eks_rounds(P, S, key_words, np.asarray(salt18), n)


def finish_plain(P: torch.Tensor, S: torch.Tensor,
                 valid: Optional[torch.Tensor], n_valid: int, target_words,
                 hit_capacity: int):
    """``finish_kernel``'s function in plain PyTorch; hit lanes come back
    in ascending order."""
    _check_state(P, S)
    B, device = P.shape[0], P.device
    _check_finish(B, valid, n_valid, hit_capacity, device)
    digest = bf.bcrypt_digest_words(P, S)
    target = torch.as_tensor(np.asarray(target_words, np.uint32)
                             .view(np.int32), device=device)
    found = bf.compare_digest_words(digest, target) & \
        (torch.arange(B, device=device) < n_valid)
    if valid is not None:
        found &= valid
    lanes = found.nonzero()[:, 0].to(torch.int32)
    count = torch.tensor([lanes.shape[0]], dtype=torch.int32, device=device)
    out = torch.full((hit_capacity,), -1, dtype=torch.int32, device=device)
    n = min(hit_capacity, lanes.shape[0])
    out[:n] = lanes[:n]
    return count, out, digest


def eks_setup(key_words: torch.Tensor, salt_words):
    """``setup``: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if key_words.device.type == "cuda":
        return setup_kernel(key_words, salt_words)
    return setup_plain(key_words, salt_words)


def eks_advance(P: torch.Tensor, S: torch.Tensor, key_words: torch.Tensor,
                salt18, n: int):
    """``advance`` (the ChunkedEks contract): the kernel for CUDA
    tensors, in place; the plain version for CPU tensors."""
    if P.device.type == "cuda":
        return advance_kernel(P, S, key_words, salt18, n)
    return advance_plain(P, S, key_words, salt18, n)


def eks_finish(P: torch.Tensor, S: torch.Tensor,
               valid: Optional[torch.Tensor], n_valid: int, target_words,
               hit_capacity: int):
    """``finish``: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if P.device.type == "cuda":
        return finish_kernel(P, S, valid, n_valid, target_words,
                             hit_capacity)
    return finish_plain(P, S, valid, n_valid, target_words, hit_capacity)
