"""The fused mask -> hash -> compare kernel: the counterpart of the JAX
package's ops/pallas_mask.py for the md5, ntlm (md4), sha1, sha256,
sha512 and sha384 cores, with one target or a list of up to
MAX_TARGETS.

Per candidate the kernel (csrc/mask.cu) decodes the mixed-radix
keyspace index into charset bytes, packs one padded block, runs the
core's rounds and compares; only hits write anything back.

- Single target: outputs ``count int32[1]``, the exact number of hits,
  and ``lanes int32[hit_capacity]``, the batch lanes of the first
  ``hit_capacity`` hits in no fixed order, -1 where unused.
- Multi target: the reference's Bloom prefilter (ops/bloom.py), then an
  exact verify of each survivor against the sorted target table
  (ops/compare.make_target_table) on the card.  Outputs ``count``,
  ``lanes``, ``tpos int32[hit_capacity]`` (each hit's position in the
  sorted table) and ``n_maybe int32[1]``, the prefilter's survivors.

``count > hit_capacity`` sends the batch to the worker's exact oracle
rescan, the reference's contract.

For each mode three functions carry it: the kernel's wrapper
(``mask_kernel`` / ``mask_multi_kernel``: CUDA tensors only, launches on
the current stream without synchronising, counts its launches in
``launches``), the same function in plain PyTorch (``mask_plain`` /
``mask_multi_plain``, hit lanes in ascending order), and the dispatcher
(``mask_crack`` / ``mask_crack_multi``: the kernel for CUDA tensors, the
plain version for CPU tensors).  ``make_cuda_mask_crack_step`` and
``make_cuda_multi_crack_step`` build the worker's steps on the
dispatchers, so one step serves ``--device cuda`` and ``--device
torch-cpu``.
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

#: threads per block (the kernel's __launch_bounds__)
THREADS = 256

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_mask.py:733"
SOURCE = "dprf_tpu_torch/csrc/mask.cu"

#: the core id of csrc/mask.cu's C interface, by device engine name.
#: The engine class holds the rest of a core's facts: packing
#: (``little_endian``, ``widen_utf16``, ``pack``), ``digest_words``,
#: ``max_candidate_len`` and the plain ``digest_packed``.
KERNEL_CORES = {"md5": 0, "ntlm": 1, "sha1": 2, "sha256": 3, "sha512": 4,
                "sha384": 5}


@functools.lru_cache(maxsize=None)
def device_engine(engine_name: str, device="cpu"):
    """The device engine of ``engine_name`` (an alias such as ``sha-1``
    included), if the kernel has its core; its tensors on ``device``."""
    from dprf_tpu_torch.engines import engine_names, get_engine
    if engine_name.lower() in engine_names("cuda"):
        eng = get_engine(engine_name, "cuda", torch_device=device)
        if eng.name in KERNEL_CORES:
            return eng
    raise ValueError(f"no mask kernel core for engine {engine_name!r} "
                     f"(cores: {', '.join(KERNEL_CORES)})")


def kernel_name(engine_name: str, multi: bool) -> str:
    """The instantiation's name: ``<core>_mask`` or ``<core>_mask_multi``."""
    return f"{engine_name}_mask" + ("_multi" if multi else "")


#: launches of each kernel instantiation in this process, by
#: ``kernel_name`` (tests and chip_smoke.py reset them and read them)
launches = {kernel_name(n, m): 0 for n in KERNEL_CORES for m in (False, True)}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kernel_eligible(engine_name: str, gen, n_targets: int) -> bool:
    """Whether the kernel takes this job: a core engine, 1..MAX_TARGETS
    targets, a mask of 1..max_candidate_len positions, the core's one
    block less its padding (27 for ntlm, 55 for the other 64-byte
    cores, 111 for sha512 and sha384), with 1..256 bytes each."""
    try:
        eng = device_engine(engine_name)
    except ValueError:
        return False
    return (1 <= n_targets <= bloom.MAX_TARGETS
            and mask_fits(gen, eng.max_candidate_len))


def mask_fits(gen, longest: int) -> bool:
    """A mask generator of 1..longest positions of 1..256 bytes each."""
    return (hasattr(gen, "charsets") and 1 <= gen.length <= longest
            and all(1 <= len(cs) <= 256 for cs in gen.charsets))


def check_batch(batch: int) -> None:
    """Lane arithmetic is 32-bit: the first mixed-radix addition
    computes base_digit + lane with base_digit <= 255, so a batch needs
    256 of headroom below 2^31."""
    if not 1 <= batch <= (1 << 31) - 256:
        raise ValueError(f"batch {batch} outside 1..2**31-256")


@functools.lru_cache(maxsize=None)
def message_block(engine_name: str, length: int) -> tuple:
    """The job's fixed message words: the block of an all-zero candidate
    (the padding marker and the bit length; a Keccak engine's pad bytes),
    as uint32 ints, from the device engine's ``pack``."""
    from dprf_tpu_torch.engines import get_engine
    eng = get_engine(engine_name, "cuda", torch_device="cpu")
    zero = torch.zeros((1, length), dtype=torch.uint8)
    words = eng.pack(zero, length).numpy()[0]
    return tuple(int(w) for w in words.view(np.uint32))


def check_decode(lut: torch.Tensor, radices: Sequence[int],
                 base_digits: Sequence[int], n_valid: int, batch: int,
                 max_length: int) -> None:
    """The mask decode's arguments of a kernel of 1..max_length
    positions: the charset tables, the radices and base digits, the
    batch and its valid lanes."""
    if lut.dtype != torch.uint8 or lut.dim() != 2 or lut.shape[1] != 256:
        raise ValueError(f"lut must be uint8[length, 256], got "
                         f"{lut.dtype}{list(lut.shape)}")
    length = lut.shape[0]
    if not 1 <= length <= max_length:
        raise ValueError(f"mask length {length} outside 1..{max_length}")
    if len(radices) != length or len(base_digits) != length:
        raise ValueError("radices and base digits need one entry per "
                         "mask position")
    if not all(1 <= r <= 256 for r in radices) or \
            not all(0 <= d < r for d, r in zip(base_digits, radices)):
        raise ValueError("radices must be 1..256 and base digits below them")
    check_batch(batch)
    if not 0 <= n_valid <= batch:
        raise ValueError(f"n_valid {n_valid} outside 0..{batch}")


def check_job(eng, lut: torch.Tensor, radices: Sequence[int],
              base_digits: Sequence[int], n_valid: int, hit_capacity: int,
              batch: int) -> None:
    if lut.dtype != torch.uint8 or lut.dim() != 2 or lut.shape[1] != 256:
        raise ValueError(f"lut must be uint8[length, 256], got "
                         f"{lut.dtype}{list(lut.shape)}")
    length = lut.shape[0]
    if not 1 <= length <= eng.max_candidate_len:
        raise ValueError(f"{eng.name}: mask length {length} outside "
                         f"1..{eng.max_candidate_len}")
    if len(radices) != length or len(base_digits) != length:
        raise ValueError("radices and base digits need one entry per "
                         "mask position")
    if not all(1 <= r <= 256 for r in radices) or \
            not all(0 <= d < r for d, r in zip(base_digits, radices)):
        raise ValueError("radices must be 1..256 and base digits below them")
    check_batch(batch)
    if not 0 <= n_valid <= batch:
        raise ValueError(f"n_valid {n_valid} outside 0..{batch}")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


def check_target(eng, target: Sequence[int]) -> None:
    if len(target) != eng.digest_words:
        raise ValueError(f"{eng.name} needs {eng.digest_words} target "
                         f"words, got {len(target)}")


def check_tables(eng, bloom_rows: torch.Tensor,
                 table: torch.Tensor, device) -> None:
    for name, t in (("bloom rows", bloom_rows), ("target table", table)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be int32 2-D, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, lut on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = table.shape[0]
    if not 1 <= n <= bloom.MAX_TARGETS or table.shape[1] != eng.digest_words:
        raise ValueError(f"target table must be int32[1..{bloom.MAX_TARGETS},"
                         f" {eng.digest_words}], got {list(table.shape)}")
    if list(bloom_rows.shape) != [bloom.n_sets(n) * bloom.K_PROBES, 128]:
        raise ValueError(f"bloom rows {list(bloom_rows.shape)} do not fit "
                         f"{n} targets")


def _args_fields(positions: int, block_words: int, target_words: int):
    return [("length", ctypes.c_int32),
            ("radix", ctypes.c_int32 * positions),
            ("base", ctypes.c_int32 * positions),
            ("block", ctypes.c_uint32 * block_words),
            ("target", ctypes.c_uint32 * target_words),
            ("shift", ctypes.c_int32)]


class MaskArgs(ctypes.Structure):
    """``struct MaskArgs`` of csrc/mask_kernel.cuh: the 64-byte cores.
    POSITIONS is the longest mask the layout holds; each core's own
    limit is its engine's ``max_candidate_len``."""
    POSITIONS, BLOCK_WORDS, TARGET_WORDS = 55, 16, 8
    _fields_ = _args_fields(POSITIONS, BLOCK_WORDS, TARGET_WORDS)


class WideMaskArgs(ctypes.Structure):
    """``struct WideMaskArgs`` of csrc/mask_kernel.cuh: the cores of more
    than 16 message words (sha512, sha384, the Keccak rate blocks)."""
    POSITIONS, BLOCK_WORDS, TARGET_WORDS = 143, 36, 16
    _fields_ = _args_fields(POSITIONS, BLOCK_WORDS, TARGET_WORDS)


def args_layout(block_words: int):
    """The kernel parameter layout of a core of ``block_words`` message
    words."""
    return MaskArgs if block_words <= MaskArgs.BLOCK_WORDS else WideMaskArgs


class MultiArgs(ctypes.Structure):
    """``struct MultiArgs`` of csrc/mask_kernel.cuh."""
    _fields_ = [("bloom", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("n_sets", ctypes.c_int32), ("n_targets", ctypes.c_int32)]


@functools.cache
def _library():
    """The C entry points, built from csrc/mask.cu at first use."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load("mask")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.dprf_mask_launch.argtypes = [
        i32, i32, i32, ptr, ptr, ctypes.POINTER(MultiArgs), ctypes.c_uint32,
        ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.dprf_mask_launch.restype = i32
    lib.dprf_mask_blocks_per_sm.argtypes = [i32, i32, i32, i32,
                                            ctypes.POINTER(i32)]
    lib.dprf_mask_blocks_per_sm.restype = i32
    return lib


def load_kernel() -> None:
    """Build and load the kernels now, so a build failure surfaces at
    worker construction rather than at the first batch."""
    _library()


def shared_bytes(length: int, n_sets: int = 0) -> int:
    """Dynamic shared memory of one block: the charset table, then the
    Bloom rows (at most 14,080 + 32,768 bytes for a 64-byte core, under
    the 48 KiB that needs no opt-in; up to 36,608 + 32,768 for a wide
    one, which raises its limit before the launch)."""
    return length * 256 + n_sets * bloom.K_PROBES * 128 * 4


@functools.cache
def blocks_per_sm(engine_name: str, multi: bool, smem: int) -> int:
    """Resident blocks per SM for one instantiation at ``smem`` bytes,
    from the CUDA occupancy calculator: the Bloom rows of a long list
    leave room for fewer blocks than the 8 of 256 threads an SM holds."""
    blocks = ctypes.c_int(0)
    rc = _library().dprf_mask_blocks_per_sm(
        KERNEL_CORES[engine_name], int(multi), THREADS, smem,
        ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


def grid_size(engine_name: str, multi: bool, n_valid: int, smem: int,
              device) -> int:
    """Blocks of the grid-stride grid: one resident wave, or fewer for
    a short batch."""
    return wave_grid(blocks_per_sm(engine_name, multi, smem), n_valid,
                     device)


def wave_grid(blocks_per_sm: int, n_valid: int, device) -> int:
    """One resident wave of ``blocks_per_sm`` blocks on every SM, or
    fewer blocks for a short batch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n_valid // THREADS), sms * blocks_per_sm))


def require_cuda(lut: torch.Tensor) -> None:
    """The kernels take a contiguous lut on a card, nothing else."""
    if lut.device.type != "cuda":
        raise ValueError(f"the CUDA mask kernels take CUDA tensors, got "
                         f"a lut on {lut.device}")
    if not lut.is_contiguous():
        raise ValueError("lut must be contiguous")


def launch_template(entry, kid: int, multi: bool, lut: torch.Tensor,
                    radices: Sequence[int], base_digits: Sequence[int],
                    n_valid: int, block: Sequence[int],
                    target: Sequence[int], margs: MultiArgs,
                    hit_capacity: int, grid: int, shift: int = 0):
    """Launch one instantiation of the mask kernel template
    (csrc/mask_kernel.cuh) through a source's C entry ``entry`` (its
    instantiation id ``kid``): the job's fixed message words ``block``,
    the single target's words ``target``, the multi-target state
    ``margs`` and, for a shifted core, the candidate's first byte
    ``shift``.  Allocates and returns (count, lanes, tpos, n_maybe) on
    the lut's card (tpos and n_maybe None for one target), still being
    computed; raises if the launch is refused."""
    require_cuda(lut)
    device = lut.device
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    tpos = torch.full((hit_capacity,), -1, dtype=torch.int32,
                      device=device) if multi else None
    n_maybe = torch.zeros((1,), dtype=torch.int32, device=device) \
        if multi else None
    layout = args_layout(len(block))
    args = layout(lut.shape[0],
                  (ctypes.c_int32 * layout.POSITIONS)(*radices),
                  (ctypes.c_int32 * layout.POSITIONS)(*base_digits),
                  (ctypes.c_uint32 * layout.BLOCK_WORDS)(*block),
                  (ctypes.c_uint32 * layout.TARGET_WORDS)(
                      *(int(w) & 0xFFFFFFFF for w in target)),
                  shift)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = entry(kid, int(multi), device.index, lut.data_ptr(),
               ctypes.byref(args), ctypes.byref(margs), n_valid,
               count.data_ptr(), lanes.data_ptr(),
               tpos.data_ptr() if multi else None,
               n_maybe.data_ptr() if multi else None,
               hit_capacity, grid, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"mask kernel launch failed: CUDA error {rc}")
    return count, lanes, tpos, n_maybe


def _launch(eng, multi: bool, lut: torch.Tensor,
            radices: Sequence[int], base_digits: Sequence[int],
            n_valid: int, target: Sequence[int], margs: MultiArgs,
            n_sets: int, hit_capacity: int):
    require_cuda(lut)
    grid = grid_size(eng.name, multi, n_valid,
                     shared_bytes(lut.shape[0], n_sets), lut.device)
    out = launch_template(_library().dprf_mask_launch,
                          KERNEL_CORES[eng.name], multi, lut, radices,
                          base_digits, n_valid,
                          message_block(eng.name, lut.shape[0]), target,
                          margs, hit_capacity, grid)
    launches[kernel_name(eng.name, multi)] += 1
    return out


def mask_kernel(engine: str, lut: torch.Tensor, radices: Sequence[int],
                base_digits: Sequence[int], n_valid: int,
                target: Sequence[int], hit_capacity: int, batch: int):
    """Launch the single-target kernel over lanes [0, n_valid) of a
    ``batch``-lane step: lut uint8[L, 256] on the card
    (``MaskGenerator.charset_lut``), the radices and the base digits of
    the batch's first candidate as ints, the target as the core's
    uint32 digest words.  Returns (count int32[1], lanes
    int32[hit_capacity]) on the card, still being computed."""
    eng = device_engine(engine, lut.device)
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch)
    check_target(eng, target)
    count, lanes, _, _ = _launch(eng, False, lut, radices, base_digits,
                                 n_valid, target, MultiArgs(), 0,
                                 hit_capacity)
    return count, lanes


def mask_multi_kernel(engine: str, lut: torch.Tensor, radices: Sequence[int],
                      base_digits: Sequence[int], n_valid: int,
                      bloom_rows: torch.Tensor, table: torch.Tensor,
                      hit_capacity: int, batch: int):
    """Launch the multi-target kernel: bloom_rows int32[n_sets * 8, 128]
    (``bloom.bloom_tables``) and table int32[T, W] (the sorted
    ``TargetTable``) on the card.  Returns (count int32[1], lanes
    int32[cap], tpos int32[cap], n_maybe int32[1]), still being
    computed."""
    eng = device_engine(engine, lut.device)
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch)
    check_tables(eng, bloom_rows, table, lut.device)
    n_sets = bloom_rows.shape[0] // bloom.K_PROBES
    margs = MultiArgs(bloom_rows.data_ptr(), table.data_ptr(), n_sets,
                      table.shape[0])
    return _launch(eng, True, lut, radices, base_digits, n_valid, [],
                   margs, n_sets, hit_capacity)


def _digest_plain(eng, lut, radices, base_digits, batch):
    cand = decode_lut(lut, radices, base_digits, batch)
    return eng.digest_packed(eng.pack(cand, lut.shape[0]))


def single_plain(eng, lut: torch.Tensor, radices: Sequence[int],
                 base_digits: Sequence[int], n_valid: int,
                 target: Sequence[int], hit_capacity: int, batch: int):
    """The single-target kernel's function in plain PyTorch for the
    device engine ``eng`` (its ``pack`` and ``digest_packed``), on the
    lut's device; hit lanes come back in ascending order."""
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch)
    check_target(eng, target)
    device = lut.device
    lane = torch.arange(batch, dtype=torch.int32, device=device)
    digest = _digest_plain(eng, lut, radices, base_digits, batch)
    want = cmp_ops.target_words_from_numpy(np.asarray(target, np.uint32),
                                           device)
    found = cmp_ops.compare_single(digest, want) & (lane < n_valid)
    count, lanes, _ = cmp_ops.compact_hits(found, torch.zeros_like(lane),
                                           hit_capacity)
    return count, lanes


def multi_plain(eng, lut: torch.Tensor, radices: Sequence[int],
                base_digits: Sequence[int], n_valid: int,
                bloom_rows: torch.Tensor, table: torch.Tensor,
                hit_capacity: int, batch: int):
    """The multi-target kernel's function in plain PyTorch for the
    device engine ``eng``: the plain ``bloom_found``, then
    ``compare_multi`` on the survivors; hit lanes come back in
    ascending order."""
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch)
    check_tables(eng, bloom_rows, table, lut.device)
    lane = torch.arange(batch, dtype=torch.int32, device=lut.device)
    digest = _digest_plain(eng, lut, radices, base_digits, batch)
    maybe = bloom.bloom_found(digest, bloom_rows, lane < n_valid)
    found, tpos = cmp_ops.compare_multi(digest, table)
    count, lanes, tpos = cmp_ops.compact_hits(found & maybe, tpos,
                                              hit_capacity)
    return count, lanes, tpos, maybe.sum(dtype=torch.int32).reshape(1)


def mask_plain(engine: str, lut: torch.Tensor, *args):
    """``mask_kernel``'s function in plain PyTorch on the lut's device;
    hit lanes come back in ascending order."""
    return single_plain(device_engine(engine, lut.device), lut, *args)


def mask_multi_plain(engine: str, lut: torch.Tensor, *args):
    """``mask_multi_kernel``'s function in plain PyTorch on the lut's
    device (arguments as ``mask_multi_kernel``)."""
    return multi_plain(device_engine(engine, lut.device), lut, *args)


def dispatch(kernel, plain, lut, args):
    """``kernel(*args)`` for a lut on a card, ``plain(*args)`` for one
    on the CPU, and nothing else."""
    if lut.device.type == "cuda":
        return kernel(*args)
    if lut.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"no mask kernel for device {lut.device}")


def mask_crack(engine: str, lut: torch.Tensor, *args):
    """The single-target kernel on CUDA tensors, its plain version on
    CPU tensors (arguments as ``mask_kernel``)."""
    return dispatch(mask_kernel, mask_plain, lut, (engine, lut, *args))


def mask_crack_multi(engine: str, lut: torch.Tensor, *args):
    """The multi-target kernel on CUDA tensors, its plain version on CPU
    tensors (arguments as ``mask_multi_kernel``)."""
    return dispatch(mask_multi_kernel, mask_multi_plain, lut,
                     (engine, lut, *args))


def _check_step(engine: str, gen, n_targets: int, batch: int) -> None:
    if not kernel_eligible(engine, gen, n_targets):
        limit = device_engine(engine).max_candidate_len
        raise ValueError(
            f"mask job not eligible for the mask kernel: engine {engine!r}, "
            f"{n_targets} targets (1..{bloom.MAX_TARGETS}), length "
            f"{gen.length} (1..{limit}); use --device cpu")
    check_batch(batch)


def single_step(crack, engine: str, gen, target_words: np.ndarray,
                batch: int, hit_capacity: int, device):
    """A single-target step over the dispatcher ``crack`` (arguments as
    ``mask_crack``): step(base_digits, n_valid) -> (count, lanes, tpos
    all 0); the lut goes to ``device`` once, here."""
    device = torch.device(device)
    lut = gen.charset_lut(device)
    radices = gen.radices
    target = [int(w) for w in np.asarray(target_words, np.uint32).ravel()]
    tpos = torch.zeros((hit_capacity,), dtype=torch.int32, device=device)

    def step(base_digits: Sequence[int], n_valid: int):
        count, lanes = crack(engine, lut, radices, base_digits, n_valid,
                             target, hit_capacity, batch)
        return count, lanes, tpos

    return step


def multi_step(crack_multi, engine: str, gen, table: cmp_ops.TargetTable,
               batch: int, hit_capacity: int, device):
    """A multi-target step over the dispatcher ``crack_multi``
    (arguments as ``mask_crack_multi``): step(base_digits, n_valid) ->
    (count, lanes, tpos, n_maybe); the lut, the Bloom rows and the
    sorted table go to ``device`` once, here."""
    device = torch.device(device)
    lut = gen.charset_lut(device)
    radices = gen.radices
    # the sets hold the targets in the job's order, as the reference's
    rows = torch.as_tensor(
        bloom.bloom_tables(table.original_words()).view(np.int32),
        device=device)
    words = table.tensor(device)

    def step(base_digits: Sequence[int], n_valid: int):
        return crack_multi(engine, lut, radices, base_digits, n_valid, rows,
                           words, hit_capacity, batch)

    return step


def make_cuda_mask_crack_step(engine: str, gen, target_words: np.ndarray,
                              batch: int, hit_capacity: int = 64,
                              device="cuda"):
    """The worker's single-target step: step(base_digits, n_valid) ->
    (count int32[1], lanes int32[hit_capacity], tpos
    int32[hit_capacity]), with base_digits the host digit list of the
    batch's first candidate (``gen.digits``) and tpos all 0.
    target_words: the core's uint32 digest words."""
    _check_step(engine, gen, 1, batch)
    return single_step(mask_crack, engine, gen, target_words, batch,
                       hit_capacity, device)


def make_cuda_multi_crack_step(engine: str, gen,
                               table: cmp_ops.TargetTable, batch: int,
                               hit_capacity: int = 64, device="cuda"):
    """The worker's multi-target step: step(base_digits, n_valid) ->
    (count int32[1], lanes int32[cap], tpos int32[cap], n_maybe
    int32[1]); tpos indexes the sorted table (map it through
    ``table.order``)."""
    _check_step(engine, gen, table.num_targets, batch)
    return multi_step(mask_crack_multi, engine, gen, table, batch,
                      hit_capacity, device)
