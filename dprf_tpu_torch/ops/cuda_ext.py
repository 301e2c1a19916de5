"""The salted and nested fast-hash chains of the mask kernel: the
counterpart of the JAX package's ops/pallas_ext.py.

csrc/ext.cu instantiates the mask kernel template (csrc/mask_kernel.cuh:
decode, single or multi-target compare, hit append) over new cores:

- the nested chains ``outer(hex(inner(p)))`` of ``NESTED_COMBOS`` and
  ``mysql41`` (sha1 over the raw sha1 digest), with one target or a list
  of up to ``bloom.MAX_TARGETS`` -- the same contract as
  ops/cuda_mask.py: (count, lanes[, tpos, n_maybe]);
- the salted cores ``<algo>-ps`` ($pass.$salt) and ``<algo>-sp``
  ($salt.$pass) for the algos of ``SALTED_ALGOS``, one target a launch:
  the target's salt, padding and bit length are its fixed message words,
  its digest the compared words, and for ``sp`` the salt's length is the
  candidate's first byte, a launch parameter.  One instantiation serves
  every salt of 0..SALT_MAX bytes.

For each chain three functions carry it, as in ops/cuda_mask.py: the
kernel's wrapper (``nested_kernel``, ``nested_multi_kernel``,
``salted_kernel``: CUDA tensors only, launches on the current stream
without synchronising, counts its launches in ``launches``), the same
function in plain PyTorch (``nested_plain``, ``nested_multi_plain``,
``salted_plain``) and the dispatcher (``nested_crack``,
``nested_crack_multi``, ``salted_crack``: the kernel for CUDA tensors,
the plain version for CPU tensors).  The step factories build the
workers' steps on the dispatchers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from dprf_tpu_torch.generators.mask import decode_lut
from dprf_tpu_torch.ops import bloom
from dprf_tpu_torch.ops import compare as cmp_ops
from dprf_tpu_torch.ops import cuda_mask
from dprf_tpu_torch.ops.pack import pack_fixed, pad_const

#: the nested chains (outer, inner), in the kernel's variant order; the
#: inner hex (32 or 40 bytes) fits one outer block
NESTED_COMBOS = {
    "md5(md5)": ("md5", "md5"),          # hashcat 2600
    "sha1(sha1)": ("sha1", "sha1"),      # 4500
    "md5(sha1)": ("md5", "sha1"),        # 4400
    "sha1(md5)": ("sha1", "md5"),        # 4700
    "sha256(md5)": ("sha256", "md5"),    # 20800
    "sha256(sha1)": ("sha256", "sha1"),  # 20700
}
#: the chains of the nested kernel: the combos, then mysql41 (300)
NESTED_NAMES = (*NESTED_COMBOS, "mysql41")
#: the salted kernel's cores and orders
SALTED_ALGOS = ("md5", "sha1", "sha256")
ORDERS = ("ps", "sp")
SALTED_NAMES = tuple(f"{a}-{o}" for a in SALTED_ALGOS for o in ORDERS)
#: single-block message budget: 64 - 1 marker byte - 8 length bytes
BLOCK_LIMIT = 55
#: the longest salt a salted target line parses to
SALT_MAX = 32

#: the variant id of csrc/ext.cu's C interface, by chain name
VARIANTS = {name: i for i, name in enumerate(NESTED_NAMES + SALTED_NAMES)}

#: the TPU kernels these replace, and the source
REPLACES_NESTED = "dprf_tpu/ops/pallas_ext.py:292"
REPLACES_SALTED = "dprf_tpu/ops/pallas_ext.py:352"
SOURCE = "dprf_tpu_torch/csrc/ext.cu"


def replaces(variant: str) -> str:
    return REPLACES_SALTED if variant in SALTED_NAMES else REPLACES_NESTED


def kernel_name(variant: str, multi: bool = False) -> str:
    """The instantiation's name: ``<chain>_mask`` or
    ``<chain>_mask_multi``, as ops/cuda_mask.kernel_name."""
    return f"{variant}_mask" + ("_multi" if multi else "")


#: every instantiation: (chain, multi target)
INSTANCES = tuple([(n, m) for n in NESTED_NAMES for m in (False, True)]
                  + [(n, False) for n in SALTED_NAMES])

#: launches of each instantiation in this process, by ``kernel_name``
#: (tests and chip_smoke.py reset them and read them)
launches = {kernel_name(n, m): 0 for n, m in INSTANCES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def split_salted(variant: str) -> tuple:
    """``"sha1-sp"`` -> ``("sha1", "sp")``."""
    algo, _, order = variant.partition("-")
    if algo not in SALTED_ALGOS or order not in ORDERS:
        raise ValueError(f"no salted kernel core {variant!r} (cores: "
                         f"{', '.join(SALTED_NAMES)})")
    return algo, order


def nested_eligible(name: str, gen, n_targets: int) -> bool:
    """Whether the nested kernel takes this job: a nested chain or
    mysql41, 1..MAX_TARGETS targets, a mask of 1..55 positions of
    1..256 bytes each.  (The reference also refuses sha256 stages off a
    TPU, for XLA:CPU's compile time; the card compiles them.)"""
    return (name in NESTED_NAMES
            and 1 <= n_targets <= bloom.MAX_TARGETS
            and cuda_mask.mask_fits(gen, BLOCK_LIMIT))


def salted_eligible(algo: str, order: str, gen,
                    salt_lens: Sequence[int]) -> bool:
    """Whether the salted kernel takes this job: a core of
    SALTED_ALGOS, an order of ORDERS, salts of 0..SALT_MAX bytes (any
    number of distinct lengths: the length is a launch parameter) and a
    mask that fits one block beside the longest salt."""
    return (algo in SALTED_ALGOS and order in ORDERS and bool(salt_lens)
            and all(0 <= n <= SALT_MAX for n in salt_lens)
            and cuda_mask.mask_fits(gen, BLOCK_LIMIT - max(salt_lens)))


def variant_words(name: str) -> tuple:
    """(digest words, big_endian) of a chain's final digest."""
    if name == "mysql41":
        return 5, True
    outer = NESTED_COMBOS[name][0] if name in NESTED_COMBOS \
        else split_salted(name)[0]
    eng = cuda_mask.device_engine(outer)
    return eng.digest_words, not eng.little_endian


@functools.lru_cache(maxsize=None)
def ext_engine(name: str, device="cpu"):
    """The nested chain's device engine (engines/device/nested.py):
    packing by the inner digest's byte order, ``digest_packed`` the
    plain chain; its tensors on ``device``."""
    from dprf_tpu_torch.engines import get_engine
    if name not in NESTED_NAMES:
        raise ValueError(f"no nested kernel chain {name!r} (chains: "
                         f"{', '.join(NESTED_NAMES)})")
    return get_engine(name, "cuda", torch_device=device)


@functools.lru_cache(maxsize=None)
def nested_block(name: str, length: int) -> tuple:
    """The nested job's fixed message words: the inner block of an
    all-zero candidate, as uint32 ints."""
    zero = torch.zeros((1, length), dtype=torch.uint8)
    words = ext_engine(name).pack(zero, length).numpy()[0]
    return tuple(int(w) for w in words.view(np.uint32))


def salted_message(order: str, cand: torch.Tensor,
                   salt: bytes) -> torch.Tensor:
    """uint8[B, L] candidates -> uint8[B, L + S] messages: ``cand``
    then the salt (``ps``), or the salt then ``cand`` (``sp``)."""
    s = torch.as_tensor(np.frombuffer(salt, np.uint8).copy(),
                        device=cand.device).expand(cand.shape[0], len(salt))
    return torch.cat([cand, s] if order == "ps" else [s, cand], dim=1)


def salted_block(variant: str, length: int, salt: bytes) -> tuple:
    """One target's fixed message words: the block of an all-zero
    candidate with the target's salt (after it for ``ps``, before it for
    ``sp``), its 0x80 marker and bit length, as uint32 ints."""
    algo, order = split_salted(variant)
    big_endian = not cuda_mask.device_engine(algo).little_endian
    msg = pad_const(length + len(salt), big_endian)
    at = length if order == "ps" else 0
    msg[at:at + len(salt)] = np.frombuffer(salt, np.uint8)
    words = msg.view(">u4" if big_endian else "<u4")
    return tuple(int(w) for w in words)


def check_salt(length: int, salt: bytes) -> None:
    if not isinstance(salt, (bytes, bytearray)) or len(salt) > SALT_MAX:
        raise ValueError(f"salt must be 0..{SALT_MAX} bytes")
    if length + len(salt) > BLOCK_LIMIT:
        raise ValueError(f"candidate ({length}) + salt ({len(salt)}) "
                         f"exceeds the {BLOCK_LIMIT}-byte block")


# ---- the kernels ----------------------------------------------------------

@functools.cache
def _library():
    """The C entry points, built from csrc/ext.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("ext")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_ext_launch.argtypes = [
        i32, i32, i32, ptr, ctypes.POINTER(cuda_mask.MaskArgs),
        ctypes.POINTER(cuda_mask.MultiArgs), ctypes.c_uint32, ptr, ptr,
        ptr, ptr, i32, i32, i32, ptr]
    lib.dprf_ext_launch.restype = i32
    lib.dprf_ext_blocks_per_sm.argtypes = [i32, i32, i32, i32,
                                           ctypes.POINTER(i32)]
    lib.dprf_ext_blocks_per_sm.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernels now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


@functools.cache
def blocks_per_sm(variant: str, multi: bool, smem: int) -> int:
    """Resident blocks per SM of one instantiation at ``smem`` bytes of
    dynamic shared memory, from the CUDA occupancy calculator."""
    blocks = ctypes.c_int(0)
    rc = _library().dprf_ext_blocks_per_sm(
        VARIANTS[variant], int(multi), cuda_mask.THREADS, smem,
        ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


def _launch(variant: str, multi: bool, lut: torch.Tensor,
            radices: Sequence[int], base_digits: Sequence[int],
            n_valid: int, block: Sequence[int], target: Sequence[int],
            margs, n_sets: int, hit_capacity: int, shift: int = 0):
    cuda_mask.require_cuda(lut)
    smem = cuda_mask.shared_bytes(lut.shape[0], n_sets)
    grid = cuda_mask.wave_grid(blocks_per_sm(variant, multi, smem), n_valid,
                               lut.device)
    out = cuda_mask.launch_template(
        _library().dprf_ext_launch, VARIANTS[variant], multi, lut, radices,
        base_digits, n_valid, block, target, margs, hit_capacity, grid,
        shift)
    launches[kernel_name(variant, multi)] += 1
    return out


def nested_kernel(name: str, lut: torch.Tensor, radices: Sequence[int],
                  base_digits: Sequence[int], n_valid: int,
                  target: Sequence[int], hit_capacity: int, batch: int):
    """Launch the nested chain ``name`` with one target (its final
    digest's uint32 words); arguments and results as
    ``cuda_mask.mask_kernel``."""
    eng = ext_engine(name, lut.device)
    cuda_mask.check_job(eng, lut, radices, base_digits, n_valid,
                        hit_capacity, batch)
    cuda_mask.check_target(eng, target)
    count, lanes, _, _ = _launch(
        name, False, lut, radices, base_digits, n_valid,
        nested_block(name, lut.shape[0]), target, cuda_mask.MultiArgs(),
        0, hit_capacity)
    return count, lanes


def nested_multi_kernel(name: str, lut: torch.Tensor,
                        radices: Sequence[int], base_digits: Sequence[int],
                        n_valid: int, bloom_rows: torch.Tensor,
                        table: torch.Tensor, hit_capacity: int, batch: int):
    """Launch the nested chain ``name`` over a target list; arguments
    and results as ``cuda_mask.mask_multi_kernel``."""
    eng = ext_engine(name, lut.device)
    cuda_mask.check_job(eng, lut, radices, base_digits, n_valid,
                        hit_capacity, batch)
    cuda_mask.check_tables(eng, bloom_rows, table, lut.device)
    n_sets = bloom_rows.shape[0] // bloom.K_PROBES
    margs = cuda_mask.MultiArgs(bloom_rows.data_ptr(), table.data_ptr(),
                                 n_sets, table.shape[0])
    return _launch(name, True, lut, radices, base_digits, n_valid,
                   nested_block(name, lut.shape[0]), [], margs, n_sets,
                   hit_capacity)


def _check_salted(variant, lut, radices, base_digits, n_valid, salt,
                  target, hit_capacity, batch):
    eng = cuda_mask.device_engine(split_salted(variant)[0], lut.device)
    cuda_mask.check_job(eng, lut, radices, base_digits, n_valid,
                        hit_capacity, batch)
    check_salt(lut.shape[0], salt)
    cuda_mask.check_target(eng, target)
    return eng


def salted_kernel(variant: str, lut: torch.Tensor, radices: Sequence[int],
                  base_digits: Sequence[int], n_valid: int, salt: bytes,
                  target: Sequence[int], hit_capacity: int, batch: int):
    """Launch the salted core ``variant`` (``md5-ps`` ... ``sha256-sp``)
    for one target: its salt bytes and its digest's uint32 words.
    Returns (count int32[1], lanes int32[hit_capacity]) on the card,
    still being computed."""
    _check_salted(variant, lut, radices, base_digits, n_valid, salt, target,
                  hit_capacity, batch)
    count, lanes, _, _ = _launch(
        variant, False, lut, radices, base_digits, n_valid,
        salted_block(variant, lut.shape[0], bytes(salt)), target,
        cuda_mask.MultiArgs(), 0, hit_capacity, shift=len(salt))
    return count, lanes


# ---- the plain versions ---------------------------------------------------

def nested_plain(name: str, lut: torch.Tensor, *args):
    """``nested_kernel``'s function in plain PyTorch on the lut's device:
    the decode, the inner digest, its hex, the outer digest (the
    engine's ``digest_packed``), the compare; hit lanes ascending."""
    return cuda_mask.single_plain(ext_engine(name, lut.device), lut, *args)


def nested_multi_plain(name: str, lut: torch.Tensor, *args):
    """``nested_multi_kernel``'s function in plain PyTorch: the chain,
    the plain Bloom prefilter and the exact table compare."""
    return cuda_mask.multi_plain(ext_engine(name, lut.device), lut, *args)


def salted_plain(variant: str, lut: torch.Tensor, radices: Sequence[int],
                 base_digits: Sequence[int], n_valid: int, salt: bytes,
                 target: Sequence[int], hit_capacity: int, batch: int):
    """``salted_kernel``'s function in plain PyTorch on the lut's device:
    the decoded candidates beside the salt, one padded block of L + S
    bytes each, the core, the compare; hit lanes ascending."""
    eng = _check_salted(variant, lut, radices, base_digits, n_valid, salt,
                        target, hit_capacity, batch)
    device = lut.device
    length = lut.shape[0]
    cand = decode_lut(lut, radices, base_digits, batch)
    msg = salted_message(split_salted(variant)[1], cand, bytes(salt))
    digest = eng.digest_packed(pack_fixed(msg, length + len(salt),
                                          big_endian=not eng.little_endian))
    lane = torch.arange(batch, dtype=torch.int32, device=device)
    want = cmp_ops.target_words_from_numpy(np.asarray(target, np.uint32),
                                           device)
    found = cmp_ops.compare_single(digest, want) & (lane < n_valid)
    count, lanes, _ = cmp_ops.compact_hits(found, torch.zeros_like(lane),
                                           hit_capacity)
    return count, lanes


def nested_crack(name: str, lut: torch.Tensor, *args):
    """The nested kernel on CUDA tensors, its plain version on CPU
    tensors (arguments as ``nested_kernel``)."""
    return cuda_mask.dispatch(nested_kernel, nested_plain, lut,
                              (name, lut, *args))


def nested_crack_multi(name: str, lut: torch.Tensor, *args):
    """The nested multi-target kernel on CUDA tensors, its plain
    version on CPU tensors (arguments as ``nested_multi_kernel``)."""
    return cuda_mask.dispatch(nested_multi_kernel, nested_multi_plain, lut,
                              (name, lut, *args))


def salted_crack(variant: str, lut: torch.Tensor, *args):
    """The salted kernel on CUDA tensors, its plain version on CPU
    tensors (arguments as ``salted_kernel``)."""
    return cuda_mask.dispatch(salted_kernel, salted_plain, lut,
                              (variant, lut, *args))


# ---- the workers' steps -----------------------------------------------------

def _check_nested_step(name: str, gen, n_targets: int, batch: int) -> None:
    if not nested_eligible(name, gen, n_targets):
        raise ValueError(
            f"mask job not eligible for the nested kernel: chain {name!r}, "
            f"{n_targets} targets (1..{bloom.MAX_TARGETS}), length "
            f"{gen.length} (1..{BLOCK_LIMIT})")
    cuda_mask.check_batch(batch)


def make_cuda_mask_crack_step(name: str, gen, target_words: np.ndarray,
                              batch: int, hit_capacity: int = 64,
                              device="cuda"):
    """The nested chain's single-target step, the contract of
    ``cuda_mask.make_cuda_mask_crack_step``: step(base_digits, n_valid)
    -> (count, lanes, tpos all 0)."""
    _check_nested_step(name, gen, 1, batch)
    return cuda_mask.single_step(nested_crack, name, gen, target_words,
                                 batch, hit_capacity, device)


def make_cuda_multi_crack_step(name: str, gen, table: cmp_ops.TargetTable,
                               batch: int, hit_capacity: int = 64,
                               device="cuda"):
    """The nested chain's multi-target step, the contract of
    ``cuda_mask.make_cuda_multi_crack_step``: step(base_digits, n_valid)
    -> (count, lanes, tpos, n_maybe)."""
    _check_nested_step(name, gen, table.num_targets, batch)
    return cuda_mask.multi_step(nested_crack_multi, name, gen, table, batch,
                                hit_capacity, device)


def make_salted_crack_step(variant: str, gen, batch: int,
                           hit_capacity: int = 64, device="cuda"):
    """The salted worker's step: step(base_digits, n_valid, salt,
    target_words) -> (count int32[1], lanes int32[hit_capacity], tpos
    all 0), one target per call."""
    algo, order = split_salted(variant)
    if not salted_eligible(algo, order, gen, [0]):
        raise ValueError(f"mask job not eligible for the salted kernel "
                         f"{variant!r}: length {gen.length}")
    cuda_mask.check_batch(batch)
    device = torch.device(device)
    lut = gen.charset_lut(device)
    radices = gen.radices
    tpos = torch.zeros((hit_capacity,), dtype=torch.int32, device=device)

    def step(base_digits: Sequence[int], n_valid: int, salt: bytes,
             target_words: Sequence[int]):
        count, lanes = salted_crack(variant, lut, radices, base_digits,
                                    n_valid, salt, target_words,
                                    hit_capacity, batch)
        return count, lanes, tpos

    return step
