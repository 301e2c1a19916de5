"""The fused mask -> hash -> compare kernel: the counterpart of the JAX
package's ops/pallas_mask.py for the md5, ntlm (md4), sha1, sha256,
sha512 and sha384 cores, with one target or a list of any length, and
the window offset; and the sha224 and mysql323 cores, which the
reference runs on XLA only.

Per candidate the kernel (csrc/mask.cu) decodes the mixed-radix
keyspace index into charset bytes, packs one padded block, runs the
core's rounds and compares; only hits write anything back.  A thread
takes a run of consecutive lanes inside one period of the last (least
significant) position: it decodes the other positions once a run and
steps the last one a lane (``RUN``, ``run_count``, ``run_lanes``).

- Single target: outputs ``count int32[1]``, the exact number of hits,
  and ``lanes int32[hit_capacity]``, the batch lanes of the first
  ``hit_capacity`` hits in no fixed order, -1 where unused.
- Multi target: a prefilter, the reference's per-set Bloom filter
  (ops/bloom.py; mode SETS, the single-card worker's) or its blocked
  probe (targets/probe.py; mode PROBE, the sharded runtime's), then an
  exact verify of each survivor against the sorted target table
  (ops/compare.make_target_table) on the card.  Outputs ``count``,
  ``lanes``, ``tpos int32[hit_capacity]`` (each hit's position in the
  sorted table) and ``n_maybe int32[1]``, the prefilter's survivors.
  A core of fewer than 3 digest words (mysql323) has no Bloom sets
  (their 8 probes read words 0-2): its lists run the probe on one card
  too.
- Bulk list (more than ``N_BULK`` targets, any number; one card): the
  blocked probe over a bitmap in global memory sized for the reference's
  false-positive budget (targets/probe.build_probe_table; mode BULK),
  then the same exact verify.  In the probe table's host-verify layout
  (the sorted table did not fit the card's byte budget) every survivor
  is reported with table position -1 and the worker confirms it with
  the oracle (the reference's ``probe_hits`` contract).

The window offset: a launch covers the window lanes [offset, n_valid)
of a ``batch``-lane step (n_valid <= offset + batch), decodes each from
the base digits plus its window lane and reports window lanes; given
``out``, the buffers of a window (``hit_buffers``), it appends to them
instead of allocating its own, so the launches of one window sum into
one count and one set of lanes on the device (ops/superstep.py).

``count > hit_capacity`` sends the batch to the worker's exact oracle
rescan, the reference's contract.

For each mode three functions carry it: the kernel's wrapper
(``mask_kernel`` / ``mask_multi_kernel`` / ``mask_probe_kernel`` /
``mask_bulk_kernel``: CUDA tensors only, launches on the current stream
without synchronising, counts its launches in ``launches``), the same
function in plain PyTorch (``mask_plain`` / ``mask_multi_plain`` /
``mask_probe_plain`` / ``mask_bulk_plain``, hit lanes in ascending
order), and the dispatcher (``mask_crack`` / ``mask_crack_multi`` /
``mask_crack_probe`` / ``mask_crack_bulk``: the kernel for CUDA
tensors, the plain version for CPU tensors).
``make_cuda_mask_crack_step``, ``make_cuda_multi_crack_step`` and
``make_shard_mask_compute`` build the workers' steps on the
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
from dprf_tpu_torch.targets import probe

#: threads per block (the kernel's __launch_bounds__)
THREADS = 256

#: the most lanes of a thread's run (DPRF_RUN in csrc/mask_kernel.cuh)
RUN = 32

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_mask.py:733"
SOURCE = "dprf_tpu_torch/csrc/mask.cu"

#: the core id of csrc/mask.cu's C interface, by the device engine's
#: ``core`` (its name, or the core a line format rides on: ``ldap-sha``
#: on sha1).  The engine class holds the rest of a core's facts: packing
#: (``little_endian``, ``widen_utf16``, ``pack``), ``digest_words``,
#: ``max_candidate_len`` and the plain ``digest_packed``.
KERNEL_CORES = {"md5": 0, "ntlm": 1, "sha1": 2, "sha256": 3, "sha512": 4,
                "sha384": 5, "sha224": 6, "mysql323": 7}

#: the compare modes of csrc/mask.cu's C interface (csrc/compare.cuh
#: ``Compare``): one target, the per-set Bloom prefilter, the blocked
#: probe in shared memory, the bulk probe in global memory; and each
#: one's suffix of the instantiation's name
SINGLE, SETS, PROBE, BULK = 0, 1, 2, 3
MODES = {SINGLE: "", SETS: "_multi", PROBE: "_probe", BULK: "_bulk"}

#: lists of more than N_BULK targets run the bulk probe (one card); 2..
#: N_BULK keep the Bloom sets (one card; mysql323 the probe) or the
#: probe (a mesh).  The crossover of the sets and the bulk probe of the
#: md5 and ntlm cores on an H100, where the compare weighs most (PERF.md,
#: slice M: even at 2,048 targets, the sets 7-20 % slower at 3,072 and
#: faster below; sha1 and sha256 cross near 1,024); the hit set does not
#: depend on it
N_BULK = 2048
#: the bulk bitmap's most blocks, 2^27 of 64 bytes (8 GiB): block * 16
#: + 15 stays in the kernel's 32-bit word index
BULK_MAX_BLOCK_BITS = 27


def core_modes(core: str) -> tuple:
    """The compare modes a core is instantiated in: all four, but no
    Bloom sets for mysql323, whose 2 digest words the sets' 8 probes of
    12 bits (words 0-2) would read past."""
    return (SINGLE, PROBE, BULK) if core == "mysql323" else tuple(MODES)

#: the blocked probe's false-positive budget a candidate and its cap in
#: groups of 128 blocks (the reference's DPRF_PALLAS_PROBE_FP default
#: and KERNEL_PROBE_GROUPS): 64 KiB of bitmap at most, 1,024 blocks
PROBE_FP = 1e-7
PROBE_GROUPS = 8
PROBE_MAX_BLOCK_BITS = (PROBE_GROUPS * 128).bit_length() - 1


@functools.lru_cache(maxsize=None)
def device_engine(engine_name: str, device="cpu"):
    """The device engine of ``engine_name`` (an alias such as ``sha-1``
    included), if the kernel has its core (``eng.core``); its tensors on
    ``device``."""
    from dprf_tpu_torch.engines import engine_names, get_engine
    if engine_name.lower() in engine_names("cuda"):
        eng = get_engine(engine_name, "cuda", torch_device=device)
        if getattr(eng, "core", None) in KERNEL_CORES:
            return eng
    raise ValueError(f"no mask kernel core for engine {engine_name!r} "
                     f"(cores: {', '.join(KERNEL_CORES)})")


def kernel_name(core: str, mode: int) -> str:
    """The instantiation's name: ``<core>_mask``, ``<core>_mask_multi``,
    ``<core>_mask_probe`` or ``<core>_mask_bulk`` for mode SINGLE, SETS,
    PROBE or BULK (False and True name the first two)."""
    return f"{core}_mask" + MODES[int(mode)]


#: launches of each kernel instantiation in this process, by
#: ``kernel_name`` (tests and chip_smoke.py reset them and read them)
launches = {kernel_name(n, m): 0 for n in KERNEL_CORES
            for m in core_modes(n)}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kernel_eligible(engine_name: str, gen, n_targets: int) -> bool:
    """Whether the kernel takes this job: a core engine, one target or a
    list of any length (past N_BULK the bulk probe), a mask of
    1..max_candidate_len positions, the core's one block less its
    padding (27 for ntlm, 55 for the other 64-byte cores, 111 for sha512
    and sha384), with 1..256 bytes each."""
    try:
        eng = device_engine(engine_name)
    except ValueError:
        return False
    return n_targets >= 1 and mask_fits(gen, eng.max_candidate_len)


def mask_fits(gen, longest: int) -> bool:
    """A mask generator of 1..longest positions of 1..256 bytes each."""
    return (hasattr(gen, "charsets") and 1 <= gen.length <= longest
            and all(1 <= len(cs) <= 256 for cs in gen.charsets))


def check_batch(batch: int, offset: int = 0) -> None:
    """Lane arithmetic is 32-bit: the first mixed-radix addition
    computes base_digit + lane with base_digit <= 255, so the last lane
    of a batch at a window offset needs 256 of headroom below 2^31."""
    if not 1 <= batch <= (1 << 31) - 256:
        raise ValueError(f"batch {batch} outside 1..2**31-256")
    if not 0 <= offset <= (1 << 31) - 256 - batch:
        raise ValueError(f"offset {offset} + batch {batch} outside "
                         "0..2**31-256")


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


@functools.lru_cache(maxsize=None)
def byte_mask(engine_name: str, length: int) -> tuple:
    """The message words' mask of the last position's byte (0xff bits
    where the engine's ``pack`` puts it, zero elsewhere), as uint32
    ints: the kernel's ``sel``."""
    from dprf_tpu_torch.engines import get_engine
    eng = get_engine(engine_name, "cuda", torch_device="cpu")
    zero = torch.zeros((1, length), dtype=torch.uint8)
    one = zero.clone()
    one[0, -1] = 0xFF
    words = (eng.pack(zero, length).numpy()[0].view(np.uint32)
             ^ eng.pack(one, length).numpy()[0].view(np.uint32))
    return tuple(int(w) for w in words)


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


def decode_reciprocals(radices: Sequence[int]) -> tuple:
    """The reciprocal decode's per-position constants (csrc/decode.cuh,
    DPRF_DECODE_RCP): for a radix r of 1..256, sh = ceil(log2 r) and
    rcp = ceil(2^(31 + sh) / r), so that s // r == umulhi(2 s, rcp) >> sh
    for every s < 2^31.  Returns (rcp, sh), lists of ints."""
    sh = [(int(r) - 1).bit_length() for r in radices]
    rcp = [-(-(1 << (31 + k)) // int(r)) for r, k in zip(radices, sh)]
    return rcp, sh


def run_shape(radix: int) -> tuple:
    """(chunks, run): a period of a last position of ``radix`` digits
    is cut into ``chunks`` runs of at most ``run`` lanes, run <= RUN."""
    chunks = -(-int(radix) // RUN)
    return chunks, -(-int(radix) // chunks)


def mean_run(radix: int) -> float:
    """Lanes a run of a whole period holds on average: radix / chunks
    (``ops/opcount.decode_work``'s run)."""
    return radix / run_shape(radix)[0]


def lanes_a_run(engine_name: str, radices: Sequence[int]) -> float:
    """Lanes a thread's run holds on average in ``engine_name``'s
    instantiation: ``mean_run`` of the last radix for a 64-byte core, 1
    for a wide one, which takes one lane a thread (``WideMaskArgs``)."""
    block = message_block(engine_name, len(radices))
    return mean_run(radices[-1]) if args_layout(len(block)).RUNS else 1.0


def run_count(radix: int, base_digit: int, offset: int,
              n_valid: int) -> int:
    """The runs of a launch over the window lanes [offset, n_valid):
    every period of the last position those lanes touch, ``chunks``
    runs each (the kernel's ``n_runs``).  ``radix`` and ``base_digit``
    are the last position's."""
    s0, s1 = base_digit + offset, base_digit + n_valid
    if s1 <= s0:
        return 0
    return ((s1 - 1) // radix - s0 // radix + 1) * run_shape(radix)[0]


def run_lanes(radix: int, base_digit: int, offset: int, n_valid: int,
              g: int) -> tuple:
    """Run ``g``'s window lanes [lo, hi) (empty where the window clips
    it away) and its carry into the position before the last, which
    decides every other digit of its lanes: the kernel's loop body."""
    chunks, run = run_shape(radix)
    s0, s1 = base_digit + offset, base_digit + n_valid
    jj, c = divmod(g, chunks)
    carry = s0 // radix + jj
    period = carry * radix
    first = period + c * run
    lo, hi = max(first, s0), min(first + run, period + radix, s1)
    return lo - base_digit, hi - base_digit, carry


def run_grid(blocks_per_sm: int, n_runs: int, device) -> int:
    """Blocks of the grid-stride grid over ``n_runs`` runs: as few
    passes as one resident wave of ``blocks_per_sm`` blocks on every SM
    needs, and as many threads as give every thread that many runs, so
    the last pass is as full as the first."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    passes = max(1, -(-n_runs // (sms * blocks_per_sm * THREADS)))
    return max(1, -(-n_runs // (passes * THREADS)))


def check_job(eng, lut: torch.Tensor, radices: Sequence[int],
              base_digits: Sequence[int], n_valid: int, hit_capacity: int,
              batch: int, offset: int = 0) -> None:
    """A launch's arguments: the mask decode's, the hit capacity, and
    the window lanes [offset, n_valid) of a ``batch``-lane step."""
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
    check_batch(batch, offset)
    if not 0 <= n_valid <= offset + batch:
        raise ValueError(f"n_valid {n_valid} outside 0..{offset + batch}")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


def check_target(eng, target: Sequence[int]) -> None:
    if len(target) != eng.digest_words:
        raise ValueError(f"{eng.name} needs {eng.digest_words} target "
                         f"words, got {len(target)}")


def _check_tensor(name: str, t: torch.Tensor, dim: int, device) -> None:
    if t.dtype != torch.int32 or t.dim() != dim:
        raise ValueError(f"{name} must be int32 {dim}-D, got "
                         f"{t.dtype}{list(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, lut on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tables(eng, bloom_rows: torch.Tensor,
                 table: torch.Tensor, device) -> None:
    """The per-set Bloom rows and the sorted target table, for a core
    instantiated with the sets."""
    if SETS not in core_modes(eng.core):
        raise ValueError(f"{eng.name}: no Bloom sets for {eng.digest_words}"
                         " digest words; its lists run the probe")
    _check_tensor("bloom rows", bloom_rows, 2, device)
    check_table(eng, table, device)
    n = table.shape[0]
    if list(bloom_rows.shape) != [bloom.n_sets(n) * bloom.K_PROBES, 128]:
        raise ValueError(f"bloom rows {list(bloom_rows.shape)} do not fit "
                         f"{n} targets")


def check_table(eng, table: torch.Tensor, device, bulk: bool = False) -> None:
    """The sorted target table of a list: int32[1..MAX_TARGETS, W], or
    of a bulk list any number of rows whose words index in int32."""
    _check_tensor("target table", table, 2, device)
    n, w = table.shape
    most = ((1 << 31) - 1) // max(1, w) if bulk else bloom.MAX_TARGETS
    if not 1 <= n <= most or w != eng.digest_words:
        raise ValueError(f"target table must be int32[1..{most}, "
                         f"{eng.digest_words}], got {list(table.shape)}")


def check_probe(words: torch.Tensor, block_bits: int, k: int,
                device, most: int = PROBE_MAX_BLOCK_BITS) -> None:
    """The probe bitmap: int32[16 << block_bits] for 0..``most`` block
    bits (10 for the shared-memory probe, BULK_MAX_BLOCK_BITS for the
    bulk one), and 1..8 bits a candidate."""
    _check_tensor("probe bitmap", words, 1, device)
    if not 0 <= block_bits <= most or \
            words.shape[0] != probe.BLOCK_WORDS << block_bits:
        raise ValueError(f"probe bitmap of {words.shape[0]} words does not "
                         f"fit {block_bits} block bits (0..{most})")
    if not 1 <= k <= probe.MAX_K:
        raise ValueError(f"probe k {k} outside 1..{probe.MAX_K}")


def probe_rows(twords: np.ndarray):
    """Target digest words uint32[N, W] -> (rows uint32[16 <<
    block_bits], block_bits, k): targets/probe.bloom_fill's bitmap,
    block-major as the kernel reads it (word w of block b at b * 16 +
    w), sized for the false-positive budget PROBE_FP and capped at
    PROBE_GROUPS groups of 128 blocks.  The reference's lane-major
    transpose serves Mosaic's gathers and is not carried over."""
    m_bits, k, _ = probe.kernel_bloom_geometry(
        int(twords.shape[0]), PROBE_FP,
        PROBE_GROUPS * 128 * probe.BLOCK_BITS)
    rows = probe.bloom_fill(np.ascontiguousarray(twords), m_bits, k)
    return rows, (m_bits // probe.BLOCK_BITS).bit_length() - 1, k


class MaskArgs(ctypes.Structure):
    """``struct MaskArgs`` of csrc/mask_kernel.cuh: the 64-byte cores,
    which take runs of lanes (``RUNS``): the decode's reciprocals and
    the last position's byte mask.  POSITIONS is the longest mask the
    layout holds; each core's own limit is its engine's
    ``max_candidate_len``."""
    POSITIONS, BLOCK_WORDS, TARGET_WORDS = 55, 16, 8
    RUNS = True
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * POSITIONS),
                ("base", ctypes.c_int32 * POSITIONS),
                ("rcp", ctypes.c_uint32 * POSITIONS),
                ("rsh", ctypes.c_int32 * POSITIONS),
                ("block", ctypes.c_uint32 * BLOCK_WORDS),
                ("sel", ctypes.c_uint32 * BLOCK_WORDS),
                ("target", ctypes.c_uint32 * TARGET_WORDS),
                ("offset", ctypes.c_uint32)]


class WideMaskArgs(ctypes.Structure):
    """``struct WideMaskArgs`` of csrc/mask_kernel.cuh: the cores of more
    than 16 message words (sha512, sha384, the Keccak rate blocks),
    which take one lane a thread, decoded in full."""
    POSITIONS, BLOCK_WORDS, TARGET_WORDS = 143, 36, 16
    RUNS = False
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * POSITIONS),
                ("base", ctypes.c_int32 * POSITIONS),
                ("block", ctypes.c_uint32 * BLOCK_WORDS),
                ("target", ctypes.c_uint32 * TARGET_WORDS),
                ("offset", ctypes.c_uint32)]


def args_layout(block_words: int):
    """The kernel parameter layout of a core of ``block_words`` message
    words."""
    return MaskArgs if block_words <= MaskArgs.BLOCK_WORDS else WideMaskArgs


class MultiArgs(ctypes.Structure):
    """``struct MultiArgs`` of csrc/compare.cuh: ``bloom`` points to the
    Bloom rows (mode SETS) or the probe bitmap (modes PROBE and BULK);
    ``table`` is null for a bulk list in the host-verify layout."""
    _fields_ = [("bloom", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("n_sets", ctypes.c_int32), ("n_targets", ctypes.c_int32),
                ("block_bits", ctypes.c_int32), ("k", ctypes.c_int32)]


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


def shared_bytes(length: int, n_sets: int = 0,
                 probe_blocks: int = 0) -> int:
    """Dynamic shared memory of one block: the charset table, then the
    Bloom rows of ``n_sets`` sets or the probe bitmap of
    ``probe_blocks`` blocks (at most 14,080 + 32,768 bytes with the
    rows for a 64-byte core, under the 48 KiB that needs no opt-in; up
    to 36,608 + 32,768 for a wide one, and up to 65,536 bytes of
    bitmap, which raise their limit before the launch)."""
    return (length * 256 + n_sets * bloom.K_PROBES * 128 * 4
            + probe_blocks * probe.BLOCK_WORDS * 4)


@functools.cache
def blocks_per_sm(core: str, mode: int, smem: int) -> int:
    """Resident blocks per SM for one instantiation (its core, compare
    ``mode``, or a bool: multi target) at ``smem`` bytes, from the CUDA
    occupancy calculator: the Bloom rows or the probe bitmap of a long
    list leave room for fewer blocks than the 8 of 256 threads an SM
    holds."""
    blocks = ctypes.c_int(0)
    rc = _library().dprf_mask_blocks_per_sm(
        KERNEL_CORES[core], int(mode), THREADS, smem,
        ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


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


def hit_buffers(multi: bool, capacity: int, device):
    """Fresh hit buffers, in a step's contract, for a launch or the
    launches of one window to append to: one target (count int32[1] 0,
    lanes int32[capacity] -1, tpos int32[capacity] 0); a list adds
    n_maybe int32[1] 0, and its tpos starts at -1."""
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((capacity,), -1, dtype=torch.int32, device=device)
    if not multi:
        return count, lanes, torch.zeros_like(lanes)
    return (count, lanes, torch.full_like(lanes, -1),
            torch.zeros((1,), dtype=torch.int32, device=device))


def check_out(out, multi: bool, hit_capacity: int, device) -> None:
    """Hit buffers a launch appends to: ``hit_buffers``' tuple on the
    lut's device, hit_capacity lanes."""
    if len(out) != (4 if multi else 3):
        raise ValueError(f"hit buffers of {len(out)} tensors for a "
                         f"{'multi' if multi else 'single'}-target launch")
    for name, t in zip(("count", "lanes", "tpos", "n_maybe"), out):
        _check_tensor(f"{name} buffer", t, 1, device)
    if [t.shape[0] for t in out] != [1, hit_capacity, hit_capacity,
                                      1][:len(out)]:
        raise ValueError(f"hit buffers {[list(t.shape) for t in out]} "
                         f"do not hold {hit_capacity} hits")


def launch_template(entry, kid: int, mode: int, engine_name: str,
                    lut: torch.Tensor, radices: Sequence[int],
                    base_digits: Sequence[int], n_valid: int,
                    target: Sequence[int], margs: MultiArgs,
                    hit_capacity: int, blocks_per_sm: int, *,
                    offset: int = 0, out=None):
    """Launch one instantiation of the mask kernel template
    (csrc/mask_kernel.cuh) through a source's C entry ``entry`` (its
    instantiation id ``kid``, compare ``mode``; a bool: multi target)
    over the window lanes [offset, n_valid): the fixed message words
    and the last position's byte mask of ``engine_name``'s packing
    (``message_block``, ``byte_mask``), the single target's words
    ``target`` and the multi-target state ``margs``; the grid from the
    instantiation's
    ``blocks_per_sm`` and the launch's runs (``run_grid``).  Appends to
    the hit buffers ``out`` (``hit_buffers``) when given, else
    allocates them on the lut's card; returns (count, lanes, tpos,
    n_maybe), still being computed (tpos and n_maybe None for one
    target); raises if the launch is refused."""
    require_cuda(lut)
    device = lut.device
    multi = int(mode) != SINGLE
    if out is None:
        out = hit_buffers(multi, hit_capacity, device)
    else:
        check_out(out, multi, hit_capacity, device)
    count, lanes = out[0], out[1]
    tpos, n_maybe = (out[2], out[3]) if multi else (None, None)
    block = message_block(engine_name, lut.shape[0])
    layout = args_layout(len(block))
    n, words = layout.POSITIONS, layout.BLOCK_WORDS
    args = layout(length=lut.shape[0], radix=(ctypes.c_int32 * n)(*radices),
                  base=(ctypes.c_int32 * n)(*base_digits),
                  block=(ctypes.c_uint32 * words)(*block),
                  target=(ctypes.c_uint32 * layout.TARGET_WORDS)(
                      *(int(w) & 0xFFFFFFFF for w in target)),
                  offset=offset)
    if layout.RUNS:
        rcp, rsh = decode_reciprocals(radices)
        args.rcp = (ctypes.c_uint32 * n)(*rcp)
        args.rsh = (ctypes.c_int32 * n)(*rsh)
        args.sel = (ctypes.c_uint32 * words)(
            *byte_mask(engine_name, lut.shape[0]))
        grid = run_grid(blocks_per_sm, run_count(
            radices[-1], base_digits[-1], offset, n_valid), device)
    else:
        grid = wave_grid(blocks_per_sm, max(0, n_valid - offset), device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = entry(kid, int(mode), device.index, lut.data_ptr(),
               ctypes.byref(args), ctypes.byref(margs), n_valid,
               count.data_ptr(), lanes.data_ptr(),
               tpos.data_ptr() if multi else None,
               n_maybe.data_ptr() if multi else None,
               hit_capacity, grid, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"mask kernel launch failed: CUDA error {rc}")
    return count, lanes, tpos, n_maybe


def _launch(eng, mode: int, lut: torch.Tensor,
            radices: Sequence[int], base_digits: Sequence[int],
            n_valid: int, target: Sequence[int], margs: MultiArgs,
            smem: int, hit_capacity: int, offset: int, out):
    require_cuda(lut)
    out = launch_template(_library().dprf_mask_launch,
                          KERNEL_CORES[eng.core], mode, eng.name, lut,
                          radices, base_digits, n_valid, target,
                          margs, hit_capacity,
                          blocks_per_sm(eng.core, mode, smem), offset=offset,
                          out=out)
    launches[kernel_name(eng.core, mode)] += 1
    return out


def mask_kernel(engine: str, lut: torch.Tensor, radices: Sequence[int],
                base_digits: Sequence[int], n_valid: int,
                target: Sequence[int], hit_capacity: int, batch: int, *,
                offset: int = 0, out=None):
    """Launch the single-target kernel over the window lanes [offset,
    n_valid) of a ``batch``-lane step (n_valid <= offset + batch): lut
    uint8[L, 256] on the card (``MaskGenerator.charset_lut``), the
    radices and the base digits of the window's first candidate as ints,
    the target as the core's uint32 digest words.  Returns (count
    int32[1], lanes int32[hit_capacity]) on the card, still being
    computed: fresh buffers, or ``out``'s (``hit_buffers``) appended
    to."""
    eng = device_engine(engine, lut.device)
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch,
              offset)
    check_target(eng, target)
    count, lanes, _, _ = _launch(eng, SINGLE, lut, radices, base_digits,
                                 n_valid, target, MultiArgs(),
                                 shared_bytes(lut.shape[0]), hit_capacity,
                                 offset, out)
    return count, lanes


def mask_multi_kernel(engine: str, lut: torch.Tensor, radices: Sequence[int],
                      base_digits: Sequence[int], n_valid: int,
                      bloom_rows: torch.Tensor, table: torch.Tensor,
                      hit_capacity: int, batch: int, *, offset: int = 0,
                      out=None):
    """Launch the multi-target kernel with the per-set Bloom prefilter:
    bloom_rows int32[n_sets * 8, 128] (``bloom.bloom_tables``) and table
    int32[T, W] (the sorted ``TargetTable``) on the card.  Returns
    (count int32[1], lanes int32[cap], tpos int32[cap], n_maybe
    int32[1]), still being computed (window and ``out`` as
    ``mask_kernel``)."""
    eng = device_engine(engine, lut.device)
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch,
              offset)
    check_tables(eng, bloom_rows, table, lut.device)
    n_sets = bloom_rows.shape[0] // bloom.K_PROBES
    margs = MultiArgs(bloom_rows.data_ptr(), table.data_ptr(), n_sets,
                      table.shape[0])
    return _launch(eng, SETS, lut, radices, base_digits, n_valid, [], margs,
                   shared_bytes(lut.shape[0], n_sets), hit_capacity, offset,
                   out)


def mask_probe_kernel(engine: str, lut: torch.Tensor,
                      radices: Sequence[int], base_digits: Sequence[int],
                      n_valid: int, probe_words: torch.Tensor,
                      block_bits: int, k: int, table: torch.Tensor,
                      hit_capacity: int, batch: int, *, offset: int = 0,
                      out=None):
    """Launch the multi-target kernel with the blocked probe:
    probe_words int32[16 << block_bits] (``probe_rows``), k bits a
    candidate, and table int32[T, W] (the sorted ``TargetTable``) on
    the card.  Returns (count, lanes, tpos, n_maybe) as
    ``mask_multi_kernel``."""
    eng = device_engine(engine, lut.device)
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch,
              offset)
    check_probe(probe_words, block_bits, k, lut.device)
    check_table(eng, table, lut.device)
    margs = MultiArgs(probe_words.data_ptr(), table.data_ptr(), 0,
                      table.shape[0], block_bits, k)
    return _launch(eng, PROBE, lut, radices, base_digits, n_valid, [],
                   margs, shared_bytes(lut.shape[0],
                                       probe_blocks=1 << block_bits),
                   hit_capacity, offset, out)


def mask_bulk_kernel(engine: str, lut: torch.Tensor,
                     radices: Sequence[int], base_digits: Sequence[int],
                     n_valid: int, probe_words: torch.Tensor,
                     block_bits: int, k: int, table, hit_capacity: int,
                     batch: int, *, offset: int = 0, out=None):
    """Launch the multi-target kernel with the bulk probe: probe_words
    int32[16 << block_bits] (a ``ProbeTable``'s bitmap) read from global
    memory, k bits a candidate, and table int32[T, W] (the sorted
    ``TargetTable``) on the card, or None for the host-verify layout,
    where every survivor is reported with tpos -1.  Returns (count,
    lanes, tpos, n_maybe) as ``mask_multi_kernel``."""
    eng = device_engine(engine, lut.device)
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch,
              offset)
    check_probe(probe_words, block_bits, k, lut.device, BULK_MAX_BLOCK_BITS)
    if table is not None:
        check_table(eng, table, lut.device, bulk=True)
    margs = MultiArgs(probe_words.data_ptr(),
                      None if table is None else table.data_ptr(), 0,
                      0 if table is None else table.shape[0], block_bits, k)
    return _launch(eng, BULK, lut, radices, base_digits, n_valid, [], margs,
                   shared_bytes(lut.shape[0]), hit_capacity, offset, out)


def _digest_plain(eng, lut, radices, base_digits, batch, offset):
    cand = decode_lut(lut, radices, base_digits, batch, lane_offset=offset)
    return eng.digest_packed(eng.pack(cand, lut.shape[0]))


def _window_lanes(lut, n_valid, batch, offset):
    """The step's lanes as window lanes, and which of them are valid."""
    lane = offset + torch.arange(batch, dtype=torch.int32, device=lut.device)
    return lane, lane < n_valid


def _compact(found, tpos, hit_capacity, offset):
    """Hit buffers of ``found`` with window lanes, ascending."""
    count, idx, tpos = cmp_ops.compact_hits(found, tpos, hit_capacity)
    return count, torch.where(idx >= 0, idx + offset, idx), tpos


def append_plain(out, count, lanes, tpos=None, n_maybe=None):
    """Fold one launch's hit buffers into the buffers ``out`` in place,
    as the kernel's atomic append does: the count and n_maybe sum, the
    hit lanes (and table positions) fill the free slots in order, and a
    hit past the capacity drops (the count keeps it).  Returns out."""
    cap = out[1].shape[0]
    slot = out[0] + torch.arange(lanes.shape[0], dtype=torch.int32,
                                 device=lanes.device)
    keep = (lanes >= 0) & (slot < cap)
    idx = slot[keep].long()
    out[1][idx] = lanes[keep]
    if tpos is not None:
        out[2][idx] = tpos[keep]
        out[3].add_(n_maybe)
    out[0].add_(count)
    return out


def single_plain(eng, lut: torch.Tensor, radices: Sequence[int],
                 base_digits: Sequence[int], n_valid: int,
                 target: Sequence[int], hit_capacity: int, batch: int, *,
                 offset: int = 0, out=None):
    """The single-target kernel's function in plain PyTorch for the
    device engine ``eng`` (its ``pack`` and ``digest_packed``), on the
    lut's device; hit lanes come back in ascending order (window and
    ``out`` as ``mask_kernel``)."""
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch,
              offset)
    check_target(eng, target)
    if out is not None:
        check_out(out, False, hit_capacity, lut.device)
    lane, valid = _window_lanes(lut, n_valid, batch, offset)
    digest = _digest_plain(eng, lut, radices, base_digits, batch, offset)
    want = cmp_ops.target_words_from_numpy(np.asarray(target, np.uint32),
                                           lut.device)
    found = cmp_ops.compare_single(digest, want) & valid
    count, lanes, _ = _compact(found, torch.zeros_like(lane), hit_capacity,
                               offset)
    if out is not None:
        return append_plain(out, count, lanes)[:2]
    return count, lanes


def _multi_hits(eng, lut, digest, maybe, table, hit_capacity, offset, out):
    """A list's exact verify of the prefilter's survivors ``maybe``:
    (count, lanes, tpos, n_maybe), or ``out`` appended to."""
    found, tpos = cmp_ops.compare_multi(digest, table)
    count, lanes, tpos = _compact(found & maybe, tpos, hit_capacity, offset)
    n_maybe = maybe.sum(dtype=torch.int32).reshape(1)
    if out is not None:
        check_out(out, True, hit_capacity, lut.device)
        return append_plain(out, count, lanes, tpos, n_maybe)
    return count, lanes, tpos, n_maybe


def multi_plain(eng, lut: torch.Tensor, radices: Sequence[int],
                base_digits: Sequence[int], n_valid: int,
                bloom_rows: torch.Tensor, table: torch.Tensor,
                hit_capacity: int, batch: int, *, offset: int = 0,
                out=None):
    """The multi-target kernel's function in plain PyTorch for the
    device engine ``eng``: the plain ``bloom_found``, then
    ``compare_multi`` on the survivors; hit lanes come back in
    ascending order."""
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch,
              offset)
    check_tables(eng, bloom_rows, table, lut.device)
    _, valid = _window_lanes(lut, n_valid, batch, offset)
    digest = _digest_plain(eng, lut, radices, base_digits, batch, offset)
    maybe = bloom.bloom_found(digest, bloom_rows, valid)
    return _multi_hits(eng, lut, digest, maybe, table, hit_capacity, offset,
                       out)


def probe_found(digest: torch.Tensor, words: torch.Tensor, block_bits: int,
                k: int, valid: torch.Tensor) -> torch.Tensor:
    """The blocked probe in plain PyTorch (the reference's
    probe_block_found over targets/probe.bloom_fill's bitmap): int32[B,
    W] digest words, the bitmap int32[16 << block_bits] -> bool[B], a
    lane valid and all k bits of its block set.  The uint32 arithmetic
    runs in int64 with masks, the golden-ratio product in 16-bit
    halves so no int64 product overflows."""
    d = digest.to(torch.int64) & 0xFFFFFFFF
    h1, h2 = d[:, 0], d[:, 1] | 1
    h3, h4 = (d[:, 2], d[:, 3] | 1) if d.shape[1] > 3 else (h1, h2)
    if block_bits:
        g = probe._GOLDEN
        mul = (h1 * (g & 0xFFFF) + (((h1 * (g >> 16)) & 0xFFFF) << 16)) \
            & 0xFFFFFFFF
        block = mul >> (32 - block_bits)
    else:
        block = torch.zeros_like(h1)
    found = valid.clone()
    for j in range(k):
        a, b = (h3, h4) if j & 1 else (h1, h2)
        bit = (a + (2 * (j >> 1) + 1) * b) & (probe.BLOCK_BITS - 1)
        word = words[block * probe.BLOCK_WORDS + (bit >> 5)]
        found &= ((word >> (bit & 31).to(torch.int32)) & 1) == 1
    return found


def probe_plain(eng, lut: torch.Tensor, radices: Sequence[int],
                base_digits: Sequence[int], n_valid: int,
                probe_words: torch.Tensor, block_bits: int, k: int,
                table: torch.Tensor, hit_capacity: int, batch: int, *,
                offset: int = 0, out=None):
    """The probe kernel's function in plain PyTorch for the device
    engine ``eng``: ``probe_found``, then ``compare_multi`` on the
    survivors; hit lanes come back in ascending order."""
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch,
              offset)
    check_probe(probe_words, block_bits, k, lut.device)
    check_table(eng, table, lut.device)
    _, valid = _window_lanes(lut, n_valid, batch, offset)
    digest = _digest_plain(eng, lut, radices, base_digits, batch, offset)
    maybe = probe_found(digest, probe_words, block_bits, k, valid)
    return _multi_hits(eng, lut, digest, maybe, table, hit_capacity, offset,
                       out)


def bulk_plain(eng, lut: torch.Tensor, radices: Sequence[int],
               base_digits: Sequence[int], n_valid: int,
               probe_words: torch.Tensor, block_bits: int, k: int, table,
               hit_capacity: int, batch: int, *, offset: int = 0,
               out=None):
    """The bulk kernel's function in plain PyTorch for the device engine
    ``eng``: ``probe_found`` (the reference's ``bloom_maybe``), then
    ``compare_multi`` on the survivors, or, with no table (host-verify),
    every survivor reported with tpos -1 (the reference's
    ``probe_hits``); hit lanes come back in ascending order."""
    check_job(eng, lut, radices, base_digits, n_valid, hit_capacity, batch,
              offset)
    check_probe(probe_words, block_bits, k, lut.device, BULK_MAX_BLOCK_BITS)
    _, valid = _window_lanes(lut, n_valid, batch, offset)
    digest = _digest_plain(eng, lut, radices, base_digits, batch, offset)
    maybe = probe_found(digest, probe_words, block_bits, k, valid)
    if table is not None:
        check_table(eng, table, lut.device, bulk=True)
        return _multi_hits(eng, lut, digest, maybe, table, hit_capacity,
                           offset, out)
    count, lanes, tpos = _compact(maybe, torch.full_like(
        maybe, -1, dtype=torch.int32), hit_capacity, offset)
    n_maybe = maybe.sum(dtype=torch.int32).reshape(1)
    if out is not None:
        check_out(out, True, hit_capacity, lut.device)
        return append_plain(out, count, lanes, tpos, n_maybe)
    return count, lanes, tpos, n_maybe


def mask_plain(engine: str, lut: torch.Tensor, *args, **window):
    """``mask_kernel``'s function in plain PyTorch on the lut's device;
    hit lanes come back in ascending order."""
    return single_plain(device_engine(engine, lut.device), lut, *args,
                        **window)


def mask_multi_plain(engine: str, lut: torch.Tensor, *args, **window):
    """``mask_multi_kernel``'s function in plain PyTorch on the lut's
    device (arguments as ``mask_multi_kernel``)."""
    return multi_plain(device_engine(engine, lut.device), lut, *args,
                       **window)


def mask_probe_plain(engine: str, lut: torch.Tensor, *args, **window):
    """``mask_probe_kernel``'s function in plain PyTorch on the lut's
    device (arguments as ``mask_probe_kernel``)."""
    return probe_plain(device_engine(engine, lut.device), lut, *args,
                       **window)


def mask_bulk_plain(engine: str, lut: torch.Tensor, *args, **window):
    """``mask_bulk_kernel``'s function in plain PyTorch on the lut's
    device (arguments as ``mask_bulk_kernel``)."""
    return bulk_plain(device_engine(engine, lut.device), lut, *args,
                      **window)


def dispatch(kernel, plain, lut, args, window=None):
    """``kernel(*args, **window)`` for a lut on a card, ``plain(*args,
    **window)`` for one on the CPU, and nothing else."""
    window = window or {}
    if lut.device.type == "cuda":
        return kernel(*args, **window)
    if lut.device.type == "cpu":
        return plain(*args, **window)
    raise ValueError(f"no mask kernel for device {lut.device}")


def mask_crack(engine: str, lut: torch.Tensor, *args, **window):
    """The single-target kernel on CUDA tensors, its plain version on
    CPU tensors (arguments as ``mask_kernel``)."""
    return dispatch(mask_kernel, mask_plain, lut, (engine, lut, *args),
                    window)


def mask_crack_multi(engine: str, lut: torch.Tensor, *args, **window):
    """The multi-target kernel on CUDA tensors, its plain version on CPU
    tensors (arguments as ``mask_multi_kernel``)."""
    return dispatch(mask_multi_kernel, mask_multi_plain, lut,
                    (engine, lut, *args), window)


def mask_crack_probe(engine: str, lut: torch.Tensor, *args, **window):
    """The probe kernel on CUDA tensors, its plain version on CPU
    tensors (arguments as ``mask_probe_kernel``)."""
    return dispatch(mask_probe_kernel, mask_probe_plain, lut,
                    (engine, lut, *args), window)


def mask_crack_bulk(engine: str, lut: torch.Tensor, *args, **window):
    """The bulk kernel on CUDA tensors, its plain version on CPU tensors
    (arguments as ``mask_bulk_kernel``)."""
    return dispatch(mask_bulk_kernel, mask_bulk_plain, lut,
                    (engine, lut, *args), window)


def _check_step(engine: str, gen, n_targets: int, batch: int) -> None:
    if not kernel_eligible(engine, gen, n_targets):
        limit = device_engine(engine).max_candidate_len
        raise ValueError(
            f"mask job not eligible for the mask kernel: engine {engine!r}, "
            f"{n_targets} targets, length {gen.length} (1..{limit}); use "
            "--device cpu")
    check_batch(batch)


def single_step(crack, engine: str, gen, target_words: np.ndarray,
                batch: int, hit_capacity: int, device):
    """A single-target step over the dispatcher ``crack`` (arguments as
    ``mask_crack``): step(base_digits, n_valid) -> (count, lanes, tpos
    all 0); the lut goes to ``device`` once, here.  A core's step also
    takes a window, step(base_digits, n_valid, offset=, out=), and then
    appends to ``out`` (``hit_buffers``, its capacity) and returns it;
    ``cap=`` sets the hit capacity of one call (a relaunch)."""
    device = torch.device(device)
    lut = gen.charset_lut(device)
    radices = gen.radices
    target = [int(w) for w in np.asarray(target_words, np.uint32).ravel()]
    tpos = torch.zeros((hit_capacity,), dtype=torch.int32, device=device)

    def step(base_digits: Sequence[int], n_valid: int, cap: int = None,
             **window):
        out = window.get("out")
        if out is not None:
            crack(engine, lut, radices, base_digits, n_valid, target,
                  out[1].shape[0], batch, **window)
            return out
        n = hit_capacity if cap is None else cap
        count, lanes = crack(engine, lut, radices, base_digits, n_valid,
                             target, n, batch, **window)
        return count, lanes, tpos if n == hit_capacity else \
            torch.zeros_like(lanes)

    return step


def _list_step(crack_multi, engine: str, gen, state: tuple, batch: int,
               hit_capacity: int, device):
    """A list's step over the dispatcher ``crack_multi``, whose
    arguments after n_valid are ``state`` (the prefilter's tensors and
    the sorted table), then the capacity and the batch; ``cap=`` sets
    the hit capacity of one call (a relaunch)."""
    lut = gen.charset_lut(device)
    radices = gen.radices

    def step(base_digits: Sequence[int], n_valid: int, cap: int = None,
             **window):
        out = window.get("out")
        if out is not None:
            cap = out[1].shape[0]
        elif cap is None:
            cap = hit_capacity
        return crack_multi(engine, lut, radices, base_digits, n_valid,
                           *state, cap, batch, **window)

    return step


def multi_step(crack_multi, engine: str, gen, table: cmp_ops.TargetTable,
               batch: int, hit_capacity: int, device):
    """A multi-target step over the dispatcher ``crack_multi``
    (arguments as ``mask_crack_multi``): step(base_digits, n_valid) ->
    (count, lanes, tpos, n_maybe); the lut, the Bloom rows and the
    sorted table go to ``device`` once, here.  A window as
    ``single_step``'s."""
    device = torch.device(device)
    # the sets hold the targets in the job's order, as the reference's
    rows = torch.as_tensor(
        bloom.bloom_tables(table.original_words()).view(np.int32),
        device=device)
    return _list_step(crack_multi, engine, gen, (rows, table.tensor(device)),
                      batch, hit_capacity, device)


def make_cuda_mask_crack_step(engine: str, gen, target_words: np.ndarray,
                              batch: int, hit_capacity: int = 64,
                              device="cuda"):
    """The worker's single-target step: step(base_digits, n_valid) ->
    (count int32[1], lanes int32[hit_capacity], tpos
    int32[hit_capacity]), with base_digits the host digit list of the
    batch's first candidate (``gen.digits``) and tpos all 0; or
    step(base_digits, n_valid, offset=, out=) over the window lanes
    [offset, n_valid), appending to ``out``.  target_words: the core's
    uint32 digest words."""
    _check_step(engine, gen, 1, batch)
    return single_step(mask_crack, engine, gen, target_words, batch,
                       hit_capacity, device)


def make_cuda_multi_crack_step(engine: str, gen, table, batch: int,
                               hit_capacity: int = 64, device="cuda"):
    """The worker's multi-target step: step(base_digits, n_valid) ->
    (count int32[1], lanes int32[cap], tpos int32[cap], n_maybe
    int32[1]); tpos indexes the sorted table (map it through the
    table's ``order``), -1 for a host-verify survivor.  A window as
    ``make_cuda_mask_crack_step``'s.  ``table``: a bulk list's
    ``probe.ProbeTable`` (the bulk probe), or the sorted ``TargetTable``
    of 2..N_BULK targets (the Bloom sets, or the blocked probe for a
    core without them)."""
    _check_step(engine, gen, table.num_targets, batch)
    if isinstance(table, probe.ProbeTable):
        return bulk_step(engine, gen, table, batch, hit_capacity, device)
    if SETS not in core_modes(device_engine(engine).core):
        return probe_step(engine, gen, table, batch, hit_capacity, device)
    return multi_step(mask_crack_multi, engine, gen, table, batch,
                      hit_capacity, device)


def probe_tensors(ptable, device) -> tuple:
    """A ``ProbeTable`` on ``device``: (bitmap int32[16 << block_bits],
    block_bits, k, sorted table int32[T, W] or None)."""
    words = torch.as_tensor(np.ascontiguousarray(ptable.bits).view(np.int32),
                            device=device)
    table = None if ptable.table is None else ptable.table.tensor(device)
    return words, ptable.block_bits, ptable.k, table


def bulk_step(engine: str, gen, ptable, batch: int, hit_capacity: int,
              device):
    """A bulk list's step over the bulk probe (arguments as
    ``mask_crack_bulk``): the ``ProbeTable``'s bitmap and sorted table go
    to ``device`` once, here.  A window as ``single_step``'s."""
    device = torch.device(device)
    return _list_step(mask_crack_bulk, engine, gen,
                      probe_tensors(ptable, device), batch, hit_capacity,
                      device)


def probe_step(engine: str, gen, table: cmp_ops.TargetTable, batch: int,
               hit_capacity: int, device):
    """A list's step over the blocked probe (arguments as
    ``mask_crack_probe``): the bitmap at PROBE_FP (``probe_rows``) and
    the sorted table go to ``device`` once, here.  A window as
    ``single_step``'s."""
    device = torch.device(device)
    rows, block_bits, k = probe_rows(table.words)
    words = torch.as_tensor(rows.view(np.int32), device=device)
    return _list_step(mask_crack_probe, engine, gen,
                      (words, block_bits, k, table.tensor(device)),
                      batch, hit_capacity, device)


def make_shard_mask_compute(engine: str, gen, target, batch_per_device: int,
                            hit_capacity: int, device="cuda"):
    """One shard's compute of the sharded runtime (parallel/sharded.py),
    the counterpart of the reference's make_shard_mask_compute:
    compute(base_digits, n_valid, offset=, out=) runs the window lanes
    [offset, n_valid) of a ``batch_per_device``-lane step on ``device``
    and appends to ``out``.  ``target``: one target's uint32 digest
    words (the exact compare), or the sorted ``TargetTable`` of 2..
    MAX_TARGETS targets (the blocked probe at PROBE_FP, and the verify
    on the card)."""
    if not isinstance(target, cmp_ops.TargetTable):
        return make_cuda_mask_crack_step(engine, gen, target,
                                         batch_per_device, hit_capacity,
                                         device)
    _check_step(engine, gen, target.num_targets, batch_per_device)
    return probe_step(engine, gen, target, batch_per_device, hit_capacity,
                      device)
