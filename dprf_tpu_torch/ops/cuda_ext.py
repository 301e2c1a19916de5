"""The salted and nested fast-hash chains of the mask kernel: the
counterpart of the JAX package's ops/pallas_ext.py.

csrc/ext.cu instantiates the mask kernel template (csrc/mask_kernel.cuh:
decode, single or multi-target compare, hit append) over new cores:

- the nested chains ``outer(hex(inner(p)))`` of ``NESTED_COMBOS`` and
  ``mysql41`` (sha1 over the raw sha1 digest), with one target or a list
  of up to ``bloom.MAX_TARGETS`` -- the same contract as
  ops/cuda_mask.py: (count, lanes[, tpos, n_maybe]);
- the salted kernel (csrc/salted.cuh), ``<algo>-ps`` ($pass.$salt) and
  ``<algo>-sp`` ($salt.$pass) for the algos of ``SALTED_ALGOS``, a group
  of up to ``SALTED_GROUP`` targets a launch (``salted_groups``: every
  ``ps`` target, or the ``sp`` targets of one salt length).  Each
  target is a row of ``salted_rows``: its fixed message words (salt,
  padding, bit length) and its digest words; the ``sp`` group's salt
  length is a launch parameter, the candidate's first byte.  Outputs
  (count, lanes, tpos, tcount): the hits as (lane, target position)
  pairs and each target's own hit count, so an overflowing batch is
  rescanned for the targets that overflowed only.  Beside the six
  64-byte variants of the reference's Pallas kernel (``SALTED_NAMES``),
  the same template holds two the reference runs on XLA only: the wide
  core, sha512 over one 128-byte block (``WIDE_SALTED``: a row of 32
  message and 16 digest words, candidate + salt up to 111 bytes), and
  the UTF-16LE placement of MSSQL (``UTF16_SALTED``: candidate byte q at
  message byte 2q, the salt after the widened candidate, unwidened).

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
from dprf_tpu_torch.ops.pack import pad_const, utf16le_widen

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
#: the salted kernel's 64-byte cores and orders, the reference's
#: Pallas salted kernel's
SALTED_ALGOS = ("md5", "sha1", "sha256")
ORDERS = ("ps", "sp")
SALTED_NAMES = tuple(f"{a}-{o}" for a in SALTED_ALGOS for o in ORDERS)
#: the wide core (sha512's 128-byte block) and the UTF-16LE placements
#: (MSSQL: ps only), which the reference runs on XLA only
WIDE_SALTED = ("sha512-ps", "sha512-sp")
UTF16_SALTED = ("sha1-ps-utf16", "sha512-ps-utf16")
#: every variant of the salted kernel, in the C entry's id order
SALTED_VARIANTS = SALTED_NAMES + WIDE_SALTED + UTF16_SALTED
#: single-block message budget: 64 - 1 marker byte - 8 length bytes;
#: 128 - 1 - 16 in SHA-512's block
BLOCK_LIMIT = 55
WIDE_BLOCK_LIMIT = 111
#: the longest salt a salted target line parses to
SALT_MAX = 32

#: the variant id of csrc/ext.cu's nested entry, by chain name
VARIANTS = {name: i for i, name in enumerate(NESTED_NAMES)}
#: the salted kernel's id of csrc/ext.cu's salted entry, by variant
SALTED_IDS = {name: i for i, name in enumerate(SALTED_VARIANTS)}
#: the most targets a launch of the salted kernel takes
#: (DPRF_SALTED_GROUP), and the words of a target's row (DPRF_SALTED_ROW;
#: the wide core's DPRF_SALTED_WIDE_ROW: 32 message and 16 digest words)
SALTED_GROUP = 256
SALTED_ROW = 24
SALTED_WIDE_ROW = 48
#: a target's row for the rules kernel's salted tail (csrc/rules_group.cu,
#: ``salted_rule_rows``): 14 zero words, the salt as message words from
#: byte 0 in 9 (``ps``: with its 0x80 marker), 5 zero words, the digest
#: in 8, the salt's bit length, 3 words of padding
SALTED_RULE_ROW = 40
RULE_SALT_AT, RULE_SALT_WORDS, RULE_DIGEST_AT, RULE_SALT_BITS = 14, 9, 28, 36
#: the same for sha512's 128-byte block (csrc/rules_wide.cu): a compact
#: row, the salt as message words from byte 0 in 9 (``ps``: with its
#: marker), the digest in 16, the salt's bit length, 2 words of padding;
#: the kernel moves the salt words with clamped reads, so no zero words
#: surround them
WIDE_SALTED_RULE_ROW = 28
WIDE_RULE_SALT_AT, WIDE_RULE_DIGEST_AT, WIDE_RULE_SALT_BITS = 0, 9, 25
#: ASCII a-z to A-Z, every other byte kept: MSSQL 2000's uppercase,
#: applied to a job's charset tables on the host
UPPER = np.array([c - 32 if 97 <= c <= 122 else c for c in range(256)],
                 np.uint8)
#: MD5's IV word 0: the salted kernel compares md5's word 0 less it
MD5_A0 = 0x67452301

#: the TPU kernels these replace, and the source
REPLACES_NESTED = "dprf_tpu/ops/pallas_ext.py:292"
REPLACES_SALTED = "dprf_tpu/ops/pallas_ext.py:352"
SOURCE = "dprf_tpu_torch/csrc/ext.cu"


def replaces(variant: str) -> str:
    """The TPU kernel an instantiation replaces; a wide or UTF-16LE
    salted variant replaces none (the reference runs it on XLA) and
    names its template's, the salted kernel's."""
    return REPLACES_SALTED if variant in SALTED_VARIANTS else REPLACES_NESTED


def kernel_name(variant: str, multi: bool = False) -> str:
    """The instantiation's name: ``<chain>_mask`` or
    ``<chain>_mask_multi`` (as ops/cuda_mask.kernel_name) for a nested
    chain, ``<variant>_group`` for a salted variant."""
    if variant in SALTED_VARIANTS:
        return f"{variant}_group"
    return f"{variant}_mask" + ("_multi" if multi else "")


#: every instantiation: (chain, multi target); a salted variant's takes
#: a group of targets
INSTANCES = tuple([(n, m) for n in NESTED_NAMES for m in (False, True)]
                  + [(n, True) for n in SALTED_VARIANTS])

#: launches of each instantiation in this process, by ``kernel_name``
#: (tests and chip_smoke.py reset them and read them)
launches = {kernel_name(n, m): 0 for n, m in INSTANCES}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def split_salted(variant: str) -> tuple:
    """``"sha1-sp"`` -> ``("sha1", "sp")``; ``"sha1-ps-utf16"`` ->
    ``("sha1", "ps")``."""
    if variant not in SALTED_VARIANTS:
        raise ValueError(f"no salted kernel variant {variant!r} "
                         f"(variants: {', '.join(SALTED_VARIANTS)})")
    algo, order = variant.split("-")[:2]
    return algo, order


def widened(variant: str) -> bool:
    """Whether the variant places the candidate as UTF-16LE."""
    return variant in UTF16_SALTED


def salted_geometry(variant: str) -> tuple:
    """(block bytes, row words, block limit, bytes a candidate byte
    takes) of a salted variant: 64 / 24 / 55 for the 64-byte cores, 128
    / 48 / 111 for sha512; 2 bytes a character for a UTF-16LE one."""
    width = 2 if widened(variant) else 1
    if split_salted(variant)[0] == "sha512":
        return 128, SALTED_WIDE_ROW, WIDE_BLOCK_LIMIT, width
    return 64, SALTED_ROW, BLOCK_LIMIT, width


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
    """Whether the salted kernel's 64-byte cores take this job (the
    reference's Pallas kernel's rule, but for its two stated
    differences): a core of SALTED_ALGOS, an order of ORDERS, salts of
    0..SALT_MAX bytes (any number of distinct lengths: the length is a
    launch parameter) and a mask that fits one block beside the longest
    salt."""
    return (algo in SALTED_ALGOS and order in ORDERS
            and variant_eligible(f"{algo}-{order}", gen, salt_lens))


def variant_eligible(variant: str, gen, salt_lens: Sequence[int]) -> bool:
    """Whether the salted kernel takes this job in ``variant`` (any of
    SALTED_VARIANTS): salts of 0..SALT_MAX bytes and a mask whose
    candidate (widened for a UTF-16LE variant) fits the variant's block
    beside the longest salt."""
    if variant not in SALTED_VARIANTS or not salt_lens or \
            not all(0 <= n <= SALT_MAX for n in salt_lens):
        return False
    _, _, limit, width = salted_geometry(variant)
    return cuda_mask.mask_fits(gen, (limit - max(salt_lens)) // width)


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


def salted_block(variant: str, length: int, salt: bytes) -> tuple:
    """One target's fixed message words: the block of an all-zero
    candidate with the target's salt (after it for ``ps``, before it for
    ``sp``), its 0x80 marker and bit length, as uint32 ints (16, or 32
    for sha512).  A UTF-16LE variant's candidate takes 2 bytes a
    character: the salt at byte 2L, the bit length (2L + S) * 8."""
    algo, order = split_salted(variant)
    block, _, _, width = salted_geometry(variant)
    big_endian = not cuda_mask.device_engine(algo).little_endian
    msg = pad_const(width * length + len(salt), big_endian, block)
    at = width * length if order == "ps" else 0
    msg[at:at + len(salt)] = np.frombuffer(salt, np.uint8)
    words = msg.view(">u4" if big_endian else "<u4")
    return tuple(int(w) for w in words)


def check_salt(variant: str, length: int, salt: bytes) -> None:
    """A salt of 0..SALT_MAX bytes that fits the variant's block beside
    a candidate of ``length`` positions."""
    _, _, limit, width = salted_geometry(variant)
    if not isinstance(salt, (bytes, bytearray)) or len(salt) > SALT_MAX:
        raise ValueError(f"salt must be 0..{SALT_MAX} bytes")
    if width * length + len(salt) > limit:
        raise ValueError(f"candidate ({width} x {length}) + salt "
                         f"({len(salt)}) exceeds the {limit}-byte block")


def salted_groups(variant: str, salts: Sequence[bytes]) -> list:
    """The launch groups of a job's targets (their salts, in job order):
    lists of target indices of at most SALTED_GROUP, each of one
    message layout.  A ``ps`` candidate sits at byte 0 whatever the salt,
    so every ``ps`` target shares one layout; an ``sp`` candidate starts
    after the salt, so ``sp`` targets group by salt length (shortest
    first)."""
    _, order = split_salted(variant)
    by_layout: dict = {}
    for i, salt in enumerate(salts):
        key = len(salt) if order == "sp" else 0
        by_layout.setdefault(key, []).append(i)
    return [idx[k:k + SALTED_GROUP] for _, idx in sorted(by_layout.items())
            for k in range(0, len(idx), SALTED_GROUP)]


def salted_rows(variant: str, length: int, group) -> np.ndarray:
    """A group's rows, uint32[T, SALTED_ROW] (SALTED_WIDE_ROW for
    sha512): per target (salt bytes, digest uint32 words), its fixed
    message words (``salted_block``), then its digest words; md5 keeps
    word 0 less the IV's in word 20, the kernel's compare after step 60.
    An ``sp`` group's salts are of one length."""
    algo, order = split_salted(variant)
    block, row_words, _, _ = salted_geometry(variant)
    m = block // 4
    n_words = cuda_mask.device_engine(algo).digest_words
    if not 1 <= len(group) <= SALTED_GROUP:
        raise ValueError(f"a salted group takes 1..{SALTED_GROUP} targets, "
                         f"got {len(group)}")
    if order == "sp" and len({len(salt) for salt, _ in group}) != 1:
        raise ValueError("an sp group's salts must be of one length")
    rows = np.zeros((len(group), row_words), np.uint32)
    for row, (salt, words) in zip(rows, group):
        check_salt(variant, length, bytes(salt))
        if len(words) != n_words:
            raise ValueError(f"{variant} needs {n_words} target words, got "
                             f"{len(words)}")
        row[:m] = salted_block(variant, length, bytes(salt))
        row[m:m + n_words] = [int(w) & 0xFFFFFFFF for w in words]
        if algo == "md5":
            row[20] = (int(words[0]) - MD5_A0) & 0xFFFFFFFF
    return rows


def rule_row_layout(variant: str) -> tuple:
    """(row words, salt at, digest at, salt bits at) of a salted
    variant's rows for the rules kernel: the 64-byte layout
    (SALTED_RULE_ROW, RULE_SALT_AT, ...) or sha512's (WIDE_...); the
    salt takes RULE_SALT_WORDS words in both."""
    if salted_geometry(variant)[0] == 128:
        return (WIDE_SALTED_RULE_ROW, WIDE_RULE_SALT_AT, WIDE_RULE_DIGEST_AT,
                WIDE_RULE_SALT_BITS)
    return SALTED_RULE_ROW, RULE_SALT_AT, RULE_DIGEST_AT, RULE_SALT_BITS


def salted_rule_rows(variant: str, group, max_len: int) -> np.ndarray:
    """A group's rows for the rules kernel's salted tail, uint32[T, row
    words] (``rule_row_layout``): per target (salt bytes, digest uint32
    words) its salt as message words (a ``ps`` salt with its 0x80
    marker: the candidate's length, and so the salt's place, varies per
    lane, and the kernel moves these words there), its digest words and
    the salt's bit length.  Each salt must fit the block beside a rule
    output of ``max_len`` bytes; an ``sp`` group's salts are of one
    length."""
    algo, order = split_salted(variant)
    width, salt_at, digest_at, bits_at = rule_row_layout(variant)
    big = not cuda_mask.device_engine(algo).little_endian
    n_words = cuda_mask.device_engine(algo).digest_words
    if not 1 <= len(group) <= SALTED_GROUP:
        raise ValueError(f"a salted group takes 1..{SALTED_GROUP} targets, "
                         f"got {len(group)}")
    if order == "sp" and len({len(salt) for salt, _ in group}) != 1:
        raise ValueError("an sp group's salts must be of one length")
    rows = np.zeros((len(group), width), np.uint32)
    for row, (salt, words) in zip(rows, group):
        check_salt(variant, max_len, bytes(salt))
        if len(words) != n_words:
            raise ValueError(f"{variant} needs {n_words} target words, got "
                             f"{len(words)}")
        msg = np.zeros(4 * RULE_SALT_WORDS, np.uint8)
        msg[:len(salt)] = np.frombuffer(bytes(salt), np.uint8)
        if order == "ps":
            msg[len(salt)] = 0x80
        row[salt_at:salt_at + RULE_SALT_WORDS] = msg.view(
            ">u4" if big else "<u4")
        row[digest_at:digest_at + n_words] = [int(w) & 0xFFFFFFFF
                                              for w in words]
        row[bits_at] = 8 * len(salt)
    return rows


def salted_rule_digests(variant: str, cand: torch.Tensor,
                        lens: torch.Tensor, rows: torch.Tensor,
                        upper: bool = False) -> torch.Tensor:
    """The rules kernel's salted tail in plain PyTorch, the reference's
    make_salted_wordlist_step: rule outputs uint8[B, L] of lengths
    int32[B] (ASCII-uppercased first with ``upper``, widened to UTF-16LE
    for a UTF-16LE variant) with each target's salt of ``rows``
    (``salted_rule_rows``) after them (``ps``) or before them (``sp``),
    the engine's ``pack_varlen`` and core over the single block (64 or,
    for sha512, 128 bytes): digest words int32[B, T, W]."""
    algo, order = split_salted(variant)
    device = cand.device
    eng = cuda_mask.device_engine(algo, device)
    pos = torch.arange(cand.shape[1], device=device)[None, :]
    cand = torch.where(pos < lens[:, None], cand, 0).to(torch.uint8)
    if upper:
        cand = torch.where((cand >= 97) & (cand <= 122), cand - 32,
                           cand).to(torch.uint8)
    if widened(variant):
        cand, lens = utf16le_widen(cand), 2 * lens
    batch, length = cand.shape
    digests = []
    for salt in rule_row_salts(variant, rows):
        n = len(salt)
        salt = torch.as_tensor(np.frombuffer(salt, np.uint8).copy(),
                               device=device)
        msg = torch.zeros((batch, length + n), dtype=torch.uint8,
                          device=device)
        if order == "ps":
            msg[:, :length] = cand
            at = lens[:, None] + torch.arange(n, device=device)[None, :]
            msg.scatter_(1, at.long(), salt.expand(batch, n))
        else:
            msg[:, :n] = salt
            msg[:, n:] = cand
        digests.append(eng.digest_packed(eng.pack_varlen(msg, lens + n)))
    return torch.stack(digests, dim=1)


def rule_row_salts(variant: str, rows) -> list:
    """The salts (bytes) of a group's rows (``salted_rule_rows``, int32
    or uint32, on any device), in row order."""
    big = not cuda_mask.device_engine(split_salted(variant)[0]).little_endian
    _, salt_at, _, bits_at = rule_row_layout(variant)
    rows = rows.cpu().numpy() if isinstance(rows, torch.Tensor) else rows
    return [row[salt_at:salt_at + RULE_SALT_WORDS]
            .astype(">u4" if big else "<u4").tobytes()
            [:int(row[bits_at]) // 8]
            for row in np.asarray(rows).view(np.uint32)]


def salted_rule_found(variant: str, cand: torch.Tensor, lens: torch.Tensor,
                      rows: torch.Tensor, upper: bool = False):
    """``salted_rule_digests`` compared with each target's digest words:
    found bool[B, T]."""
    words = cuda_mask.device_engine(split_salted(variant)[0]).digest_words
    at = rule_row_layout(variant)[2]
    want = rows[:, at:at + words].to(cand.device)
    return (salted_rule_digests(variant, cand, lens, rows, upper)
            == want[None]).all(dim=-1)


def salted_table(variant: str, length: int, group, device) -> tuple:
    """(rows int32[T, SALTED_ROW] on ``device``, shift): a group's
    launch arguments, the rows of ``salted_rows`` and the candidate's
    first byte (the ``sp`` salt length, 0 for ``ps``)."""
    rows = salted_rows(variant, length, group)
    shift = len(group[0][0]) if split_salted(variant)[1] == "sp" else 0
    return torch.as_tensor(rows.view(np.int32), device=device), shift


# ---- the kernels ----------------------------------------------------------

class SaltedArgs(ctypes.Structure):
    """``struct SaltedArgs`` of csrc/salted.cuh: the 64-byte cores, whose
    decode takes reciprocals."""
    POSITIONS = BLOCK_LIMIT
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * POSITIONS),
                ("base", ctypes.c_int32 * POSITIONS),
                ("rcp", ctypes.c_uint32 * POSITIONS),
                ("rsh", ctypes.c_int32 * POSITIONS),
                ("shift", ctypes.c_int32), ("n_targets", ctypes.c_int32),
                ("one", ctypes.c_uint32)]


class WideSaltedArgs(ctypes.Structure):
    """``struct WideSaltedArgs`` of csrc/salted.cuh: the sha512 core, up
    to 111 positions, each decoded by a division (once a candidate, for
    a whole group of pairs)."""
    POSITIONS = WIDE_BLOCK_LIMIT
    _fields_ = [("length", ctypes.c_int32),
                ("radix", ctypes.c_int32 * POSITIONS),
                ("base", ctypes.c_int32 * POSITIONS),
                ("shift", ctypes.c_int32), ("n_targets", ctypes.c_int32),
                ("one", ctypes.c_uint32)]


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
    lib.dprf_salted_launch.argtypes = [
        i32, i32, ptr, ptr, ptr, ctypes.c_uint32, ptr, ptr, ptr, ptr, i32,
        i32, i32, ptr]
    lib.dprf_salted_launch.restype = i32
    lib.dprf_salted_blocks_per_sm.argtypes = [i32, i32, i32,
                                              ctypes.POINTER(i32)]
    lib.dprf_salted_blocks_per_sm.restype = i32
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
            n_valid: int, target: Sequence[int], margs, n_sets: int,
            hit_capacity: int):
    cuda_mask.require_cuda(lut)
    smem = cuda_mask.shared_bytes(lut.shape[0], n_sets)
    out = cuda_mask.launch_template(
        _library().dprf_ext_launch, VARIANTS[variant], multi, variant, lut,
        radices, base_digits, n_valid, target, margs, hit_capacity,
        blocks_per_sm(variant, multi, smem))
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
        name, False, lut, radices, base_digits, n_valid, target,
        cuda_mask.MultiArgs(), 0, hit_capacity)
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
    return _launch(name, True, lut, radices, base_digits, n_valid, [],
                   margs, n_sets, hit_capacity)


def salted_shared_bytes(variant: str, length: int, n_targets: int) -> int:
    """Dynamic shared memory of one salted block: the group's rows, then
    the charset tables (at most 24 KiB + 14,080 bytes for a 64-byte
    core; 48 KiB + 28,416 for sha512, past the 48 KB a launch gets
    without the opt-in, which the wide variants take)."""
    return n_targets * salted_geometry(variant)[1] * 4 + length * 256


@functools.cache
def salted_blocks_per_sm(variant: str, smem: int) -> int:
    """Resident blocks per SM of a salted core at ``smem`` bytes."""
    blocks = ctypes.c_int(0)
    rc = _library().dprf_salted_blocks_per_sm(
        SALTED_IDS[variant], cuda_mask.THREADS, smem, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}, "
                           f"{blocks.value} blocks per SM")
    return blocks.value


def _check_salted(variant, lut, radices, base_digits, n_valid, shift, rows,
                  hit_capacity, batch):
    algo, order = split_salted(variant)
    _, row_words, limit, width = salted_geometry(variant)
    eng = cuda_mask.device_engine(algo, lut.device)
    cuda_mask.check_job(eng, lut, radices, base_digits, n_valid,
                        hit_capacity, batch)
    cuda_mask._check_tensor("salted rows", rows, 2, lut.device)
    if not 1 <= rows.shape[0] <= SALTED_GROUP or \
            rows.shape[1] != row_words:
        raise ValueError(f"salted rows must be int32[1..{SALTED_GROUP}, "
                         f"{row_words}], got {list(rows.shape)}")
    if not (0 <= shift <= SALT_MAX and (shift == 0 or order == "sp")
            and width * lut.shape[0] + shift <= limit):
        raise ValueError(f"salt shift {shift} outside 0..{SALT_MAX}, past "
                         f"the {limit}-byte block or on a ps core")
    return eng


def salted_kernel(variant: str, lut: torch.Tensor, radices: Sequence[int],
                  base_digits: Sequence[int], n_valid: int, shift: int,
                  rows: torch.Tensor, hit_capacity: int, batch: int):
    """Launch the salted variant ``variant`` (``SALTED_VARIANTS``: for a
    UTF-16LE one, ``lut`` already mapped, as the step maps MSSQL 2000's
    to uppercase) for a group of targets: ``rows`` (``salted_table``) on
    the card and,
    for ``sp``, the group's salt length ``shift``.  Returns (count
    int32[1], lanes int32[cap], tpos int32[cap], tcount int32[T]) on the
    card, still being computed: the (lane, target position) hits, -1 in
    unused slots, and each target's hit count."""
    cuda_mask.require_cuda(lut)
    _check_salted(variant, lut, radices, base_digits, n_valid, shift, rows,
                  hit_capacity, batch)
    device = lut.device
    n_targets = rows.shape[0]
    count, lanes, tpos = cuda_mask.hit_buffers(False, hit_capacity, device)
    tpos.fill_(-1)
    tcount = torch.zeros((n_targets,), dtype=torch.int32, device=device)
    length = lut.shape[0]
    if salted_geometry(variant)[0] == 128:
        n = WideSaltedArgs.POSITIONS
        args = WideSaltedArgs(length, (ctypes.c_int32 * n)(*radices),
                              (ctypes.c_int32 * n)(*base_digits), shift,
                              n_targets, 1)
    else:
        rcp, rsh = cuda_mask.decode_reciprocals(radices)
        n = SaltedArgs.POSITIONS
        args = SaltedArgs(length, (ctypes.c_int32 * n)(*radices),
                          (ctypes.c_int32 * n)(*base_digits),
                          (ctypes.c_uint32 * n)(*rcp),
                          (ctypes.c_int32 * n)(*rsh), shift, n_targets, 1)
    smem = salted_shared_bytes(variant, length, n_targets)
    grid = cuda_mask.wave_grid(salted_blocks_per_sm(variant, smem), n_valid,
                               device)
    rc = _library().dprf_salted_launch(
        SALTED_IDS[variant], device.index, lut.data_ptr(),
        ctypes.byref(args), rows.data_ptr(), n_valid, count.data_ptr(),
        lanes.data_ptr(), tpos.data_ptr(), tcount.data_ptr(), hit_capacity,
        grid, cuda_mask.THREADS, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"salted kernel launch failed: CUDA error {rc}")
    launches[kernel_name(variant)] += 1
    return count, lanes, tpos, tcount


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


def candidate_words(cand: torch.Tensor, at: int, big_endian: bool,
                    block_bytes: int = 64) -> torch.Tensor:
    """uint8[B, L] candidates -> int32[B, block_bytes / 4]: each
    candidate's bytes at [at, at + L) of a zeroed block, as message
    words."""
    n = block_bytes // 4
    block = torch.zeros((cand.shape[0], block_bytes), dtype=torch.uint8,
                        device=cand.device)
    block[:, at:at + cand.shape[1]] = cand
    if big_endian:
        block = block.view(-1, n, 4).flip(-1).reshape(-1, block_bytes)
    return block.contiguous().view(torch.int32)


def salted_candidate_words(variant: str, lut: torch.Tensor,
                           radices: Sequence[int],
                           base_digits: Sequence[int], batch: int,
                           shift: int) -> torch.Tensor:
    """A batch's decoded candidates (UTF-16LE for a widened variant) as
    the variant's message words at [shift, ...), zero elsewhere:
    int32[batch, 16 or 32]."""
    algo, _ = split_salted(variant)
    cand = decode_lut(lut, radices, base_digits, batch)
    if widened(variant):
        cand = utf16le_widen(cand)
    return candidate_words(
        cand, shift, not cuda_mask.device_engine(algo).little_endian,
        salted_geometry(variant)[0])


def salted_row_digest(variant: str, words: torch.Tensor,
                      row: torch.Tensor) -> torch.Tensor:
    """The digest words of each candidate of ``salted_candidate_words``
    under one target's row: its fixed words ORed in, the core's plain
    ``digest_packed``."""
    eng = cuda_mask.device_engine(split_salted(variant)[0], words.device)
    return eng.digest_packed(words | row[:salted_geometry(variant)[0] // 4])


def mapped_lut(gen, device, byte_map=None) -> torch.Tensor:
    """The job's charset tables on ``device``, each byte through
    ``byte_map`` (uint8[256], e.g. ``UPPER``) if one is given."""
    lut = gen.charset_lut(device)
    if byte_map is None:
        return lut
    return torch.as_tensor(np.asarray(byte_map, np.uint8),
                           device=device)[lut.long()]


def salted_plain(variant: str, lut: torch.Tensor, radices: Sequence[int],
                 base_digits: Sequence[int], n_valid: int, shift: int,
                 rows: torch.Tensor, hit_capacity: int, batch: int):
    """``salted_kernel``'s function in plain PyTorch on the lut's device:
    the decoded candidates (UTF-16LE for a widened variant) as words at
    [shift, shift + L), per target ORed into its fixed words, the core,
    the compare of every digest word; the (lane, target) hits in lane
    then target order."""
    eng = _check_salted(variant, lut, radices, base_digits, n_valid, shift,
                        rows, hit_capacity, batch)
    m = salted_geometry(variant)[0] // 4
    words = salted_candidate_words(variant, lut, radices, base_digits, batch,
                                   shift)
    lane = torch.arange(batch, device=lut.device)
    found = torch.stack(
        [cmp_ops.compare_single(salted_row_digest(variant, words, row),
                                row[m:m + eng.digest_words])
         for row in rows], dim=1) & (lane < n_valid)[:, None]
    return cmp_ops.compact_group_hits(found, hit_capacity)


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


def make_salted_crack_step(variant: str, gen, group, batch: int,
                           hit_capacity: int = 64, device="cuda",
                           byte_map=None):
    """The salted worker's step for one group: ``group`` its targets'
    (salt bytes, digest uint32 words) (``salted_groups``), their rows on
    ``device`` once, here; ``byte_map`` (uint8[256], e.g. ``UPPER``)
    maps the job's charset tables before they go there, so the hashed
    candidate is the mapped one while the worker decodes its hits from
    the generator's own charsets.  step(base_digits, n_valid) -> (count
    int32[1], lanes int32[cap], tpos int32[cap], tcount int32[T])."""
    if not variant_eligible(variant, gen, [len(s) for s, _ in group]):
        raise ValueError(f"mask job not eligible for the salted kernel "
                         f"{variant!r}: length {gen.length}")
    cuda_mask.check_batch(batch)
    device = torch.device(device)
    lut = mapped_lut(gen, device, byte_map)
    radices = gen.radices
    rows, shift = salted_table(variant, gen.length, group, device)

    def step(base_digits: Sequence[int], n_valid: int):
        return salted_crack(variant, lut, radices, base_digits, n_valid,
                            shift, rows, hit_capacity, batch)

    return step
