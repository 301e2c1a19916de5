"""The fused mask -> Keccak -> compare kernel: the counterpart of the JAX
package's ops/pallas_keccak.py, for sha3-224/256/384/512 and the
original keccak-224/256/384/512 (engines/device/sha3.py).

csrc/keccak.cu instantiates the mask kernel template
(csrc/mask_kernel.cuh) over ``KeccakCore<rate, words>``, one per digest
width: sha3-N and keccak-N differ only in the pad byte, which sits in the
job's fixed message words, so they share an instantiation.  The
contract is ops/cuda_mask.py's: one target -> (count, lanes); a list of
up to ``bloom.MAX_TARGETS`` -> (count, lanes, tpos, n_maybe), through
the Bloom prefilter and the exact verify on the card.  (The reference's
kernel takes one target and sends lists to its XLA sorted-table
compare; the hit set is the same.)

Three functions carry each mode, as in ops/cuda_mask.py: the kernel's
wrapper (``keccak_mask_kernel``, ``keccak_mask_multi_kernel``: CUDA
tensors only, launches on the current stream without synchronising,
counts its launches in ``launches``), the same function in plain
PyTorch (``keccak_mask_plain``, ``keccak_mask_multi_plain``, on
ops/keccak.py) and the dispatcher (``keccak_crack``,
``keccak_crack_multi``).  The step factories build the mask worker's
steps on the dispatchers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from dprf_tpu_torch.engines.cpu.engines import KECCAK_SIZES
from dprf_tpu_torch.ops import bloom
from dprf_tpu_torch.ops import compare as cmp_ops
from dprf_tpu_torch.ops import cuda_mask

#: the variant id of csrc/keccak.cu's C interface, by digest bits
VARIANTS = {bits: i for i, (bits, _) in enumerate(KECCAK_SIZES)}
#: the engine names the kernel serves (aliases included)
NAMES = tuple(n for bits, _ in KECCAK_SIZES
              for n in (f"sha3-{bits}", f"keccak-{bits}", f"keccak{bits}")) \
    + ("sha3",)

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_keccak.py:167"
SOURCE = "dprf_tpu_torch/csrc/keccak.cu"


def kernel_name(bits: int, multi: bool = False) -> str:
    """The instantiation's name: ``keccak<bits>_mask`` or
    ``keccak<bits>_mask_multi`` (sha3-<bits> and keccak-<bits> share
    it)."""
    return f"keccak{bits}_mask" + ("_multi" if multi else "")


#: every instantiation: (digest bits, multi target)
INSTANCES = tuple((b, m) for b in VARIANTS for m in (False, True))

#: launches of each instantiation in this process, by ``kernel_name``
#: (tests and chip_smoke.py reset them and read them)
launches = {kernel_name(b, m): 0 for b, m in INSTANCES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def keccak_engine(name: str, device="cpu"):
    """The device engine of a sha3/keccak name (an alias included), its
    tensors on ``device``."""
    from dprf_tpu_torch.engines import get_engine
    if name.lower() not in NAMES:
        raise ValueError(f"no Keccak kernel for engine {name!r} (names: "
                         f"{', '.join(NAMES)})")
    return get_engine(name, "cuda", torch_device=device)


def bits_of(name: str) -> int:
    """The digest width of a sha3/keccak name, which picks the
    instantiation."""
    return 8 * keccak_engine(name).digest_size


def kernel_eligible(name: str, gen, n_targets: int) -> bool:
    """Whether the kernel takes this job: a sha3/keccak name,
    1..MAX_TARGETS targets, a mask of 1..rate - 1 positions of 1..256
    bytes each."""
    try:
        eng = keccak_engine(name)
    except ValueError:
        return False
    return (1 <= n_targets <= bloom.MAX_TARGETS
            and cuda_mask.mask_fits(gen, eng.max_candidate_len))


# ---- the kernels ----------------------------------------------------------

@functools.cache
def _library():
    """The C entry points, built from csrc/keccak.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("keccak")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_keccak_launch.argtypes = [
        i32, i32, i32, ptr, ptr, ctypes.POINTER(cuda_mask.MultiArgs),
        ctypes.c_uint32, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.dprf_keccak_launch.restype = i32
    lib.dprf_keccak_blocks_per_sm.argtypes = [i32, i32, i32, i32,
                                              ctypes.POINTER(i32)]
    lib.dprf_keccak_blocks_per_sm.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernels now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


@functools.cache
def blocks_per_sm(bits: int, multi: bool, smem: int) -> int:
    """Resident blocks per SM of one instantiation at ``smem`` bytes of
    dynamic shared memory, from the CUDA occupancy calculator."""
    blocks = ctypes.c_int(0)
    rc = _library().dprf_keccak_blocks_per_sm(
        VARIANTS[bits], int(multi), cuda_mask.THREADS, smem,
        ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


def _launch(name: str, multi: bool, lut: torch.Tensor,
            radices: Sequence[int], base_digits: Sequence[int],
            n_valid: int, target: Sequence[int], margs, n_sets: int,
            hit_capacity: int):
    cuda_mask.require_cuda(lut)
    bits = bits_of(name)
    smem = cuda_mask.shared_bytes(lut.shape[0], n_sets)
    out = cuda_mask.launch_template(
        _library().dprf_keccak_launch, VARIANTS[bits], multi, name, lut,
        radices, base_digits, n_valid, target, margs, hit_capacity,
        blocks_per_sm(bits, multi, smem))
    launches[kernel_name(bits, multi)] += 1
    return out


def keccak_mask_kernel(name: str, lut: torch.Tensor, radices: Sequence[int],
                       base_digits: Sequence[int], n_valid: int,
                       target: Sequence[int], hit_capacity: int, batch: int):
    """Launch the Keccak kernel of ``name`` (sha3-256, keccak-224, ...)
    with one target (its digest's big-endian uint32 words); arguments
    and results as ``cuda_mask.mask_kernel``."""
    eng = keccak_engine(name, lut.device)
    cuda_mask.check_job(eng, lut, radices, base_digits, n_valid,
                        hit_capacity, batch)
    cuda_mask.check_target(eng, target)
    count, lanes, _, _ = _launch(name, False, lut, radices, base_digits,
                                 n_valid, target, cuda_mask.MultiArgs(), 0,
                                 hit_capacity)
    return count, lanes


def keccak_mask_multi_kernel(name: str, lut: torch.Tensor,
                             radices: Sequence[int],
                             base_digits: Sequence[int], n_valid: int,
                             bloom_rows: torch.Tensor, table: torch.Tensor,
                             hit_capacity: int, batch: int):
    """Launch the Keccak kernel of ``name`` over a target list; arguments
    and results as ``cuda_mask.mask_multi_kernel``."""
    eng = keccak_engine(name, lut.device)
    cuda_mask.check_job(eng, lut, radices, base_digits, n_valid,
                        hit_capacity, batch)
    cuda_mask.check_tables(eng, bloom_rows, table, lut.device)
    n_sets = bloom_rows.shape[0] // bloom.K_PROBES
    margs = cuda_mask.MultiArgs(bloom_rows.data_ptr(), table.data_ptr(),
                                 n_sets, table.shape[0])
    return _launch(name, True, lut, radices, base_digits, n_valid, [],
                   margs, n_sets, hit_capacity)


# ---- the plain versions ---------------------------------------------------

def keccak_mask_plain(name: str, lut: torch.Tensor, *args):
    """``keccak_mask_kernel``'s function in plain PyTorch on the lut's
    device: the decode, the absorbed block (the engine's ``pack``),
    Keccak-f and the squeeze (its ``digest_packed``), the compare; hit
    lanes ascending."""
    return cuda_mask.single_plain(keccak_engine(name, lut.device), lut,
                                  *args)


def keccak_mask_multi_plain(name: str, lut: torch.Tensor, *args):
    """``keccak_mask_multi_kernel``'s function in plain PyTorch: the
    sponge, the plain Bloom prefilter and the exact table compare."""
    return cuda_mask.multi_plain(keccak_engine(name, lut.device), lut,
                                 *args)


def keccak_crack(name: str, lut: torch.Tensor, *args):
    """The Keccak kernel on CUDA tensors, its plain version on CPU
    tensors (arguments as ``keccak_mask_kernel``)."""
    return cuda_mask.dispatch(keccak_mask_kernel, keccak_mask_plain, lut,
                              (name, lut, *args))


def keccak_crack_multi(name: str, lut: torch.Tensor, *args):
    """The Keccak multi-target kernel on CUDA tensors, its plain version
    on CPU tensors (arguments as ``keccak_mask_multi_kernel``)."""
    return cuda_mask.dispatch(keccak_mask_multi_kernel,
                              keccak_mask_multi_plain, lut,
                              (name, lut, *args))


# ---- the workers' steps -----------------------------------------------------

def _check_step(name: str, gen, n_targets: int, batch: int) -> None:
    if not kernel_eligible(name, gen, n_targets):
        raise ValueError(
            f"mask job not eligible for the Keccak kernel: engine {name!r}, "
            f"{n_targets} targets (1..{bloom.MAX_TARGETS}), length "
            f"{gen.length} (1..{keccak_engine(name).max_candidate_len}); "
            "use --device cpu")
    cuda_mask.check_batch(batch)


def make_cuda_mask_crack_step(name: str, gen, target_words: np.ndarray,
                              batch: int, hit_capacity: int = 64,
                              device="cuda"):
    """The single-target step, the contract of
    ``cuda_mask.make_cuda_mask_crack_step``: step(base_digits, n_valid)
    -> (count, lanes, tpos all 0)."""
    _check_step(name, gen, 1, batch)
    return cuda_mask.single_step(keccak_crack, name, gen, target_words,
                                 batch, hit_capacity, device)


def make_cuda_multi_crack_step(name: str, gen, table: cmp_ops.TargetTable,
                               batch: int, hit_capacity: int = 64,
                               device="cuda"):
    """The multi-target step, the contract of
    ``cuda_mask.make_cuda_multi_crack_step``: step(base_digits, n_valid)
    -> (count, lanes, tpos, n_maybe)."""
    _check_step(name, gen, table.num_targets, batch)
    return cuda_mask.multi_step(keccak_crack_multi, name, gen, table, batch,
                                hit_capacity, device)
