"""The fused wordlist+rules kernel: the counterpart of the JAX package's
ops/pallas_rules.py for the md5, ntlm (md4), sha1 and sha256 cores, one
target or a list; of its XLA wordlist pipeline (ops/rules_pipeline.py)
for sha224, mysql323, the nested chains, sha512 and sha384; of its
Keccak wordlist step (engines/device/sha3.py) for the 13 sha3/keccak
names; and of its salted and Kerberos etype-23 wordlist steps
(engines/device/salted.py, engines/device/krb5.py) for a group of
targets a launch.

Per candidate the kernel (csrc/rules_kernel.cuh, instantiated by
csrc/rules.cu, csrc/rules_nested.cu, csrc/rules_group.cu and, for the
wide cores -- SHA-512's 128-byte block, the Keccak rate block -- and the
sha512 salted tails, csrc/rules_wide.cu) takes word
b of the step's word window and rule r, interprets the rule's bytecode
(``encode_rules``) with the semantics of rules/cpu.py, packs the
variable-length message, runs the core and compares exactly with the
target.  Hit lanes are
rule-major, lane = r * word_batch + b, as in the reference's step.

The kernel reads the word table with rows padded with zeros to a
multiple of 16 bytes (``pad_rows``, ``row_bytes``), in 16-byte
loads; a thread holds one word and runs ``rule_runs`` consecutive rules
over it, the block's threads the same rules, so that a launch of
``launch_grid`` blocks fills whole resident waves.

Outputs: ``count int32[1]``, the exact number of hits, and ``lanes
int32[hit_capacity]``, the lanes of the first ``hit_capacity`` hits in
no fixed order, -1 where unused; ``count > hit_capacity`` sends the word
window to the worker's relaunch with a buffer of its count.

A list of targets (the reference sends it to its XLA pipeline,
ops/rules_pipeline.py; its Pallas kernel takes one target): the
blocked probe over the list's bitmap -- in shared memory for 2..N_BULK
targets (mode PROBE, ``cuda_mask.probe_rows``' bitmap), in global memory
past N_BULK (mode BULK, a ``targets/probe.ProbeTable``) -- and each
survivor's exact verify against the sorted table on the card; the
outputs add ``tpos int32[hit_capacity]`` (each hit's table position, -1
for a survivor of the host-verify layout, which the worker confirms with
the oracle) and ``n_maybe int32[1]``, the probe's survivors
(``rules_list_kernel``, ``rules_list_plain``, ``rules_crack_list``).

Three functions carry it: the kernel's wrapper ``rules_kernel`` (CUDA
tensors only, launches on the current stream without synchronising,
counts its launches in ``launches``), the same function in plain
PyTorch ``rules_plain`` (rules/device.py per rule, ``pack_varlen``, the
engine's ``digest_packed``, an exact compare; hit lanes in ascending
order), and the dispatcher ``rules_crack``: the kernel for CUDA tensors,
the plain version for CPU tensors.  ``make_cuda_rules_crack_step``
builds the worker's step on the dispatcher, so one step serves
``--device cuda`` and ``--device torch-cpu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from dprf_tpu_torch.ops import compare as cmp_ops
from dprf_tpu_torch.ops import cuda_mask
from dprf_tpu_torch.ops.cuda_mask import BULK, PROBE, device_engine
from dprf_tpu_torch.rules import device as rules_device
from dprf_tpu_torch.rules.parser import Op, Opcode

#: interpreter steps per rule (best64's longest rule has 8 ops)
MAX_STEPS = 8
#: threads per block (kThreads in the source)
THREADS = 256
#: threads of a warp; the hit lanes' word stride (word_batch) is a
#: multiple of it
WARP = 32
#: the word table's row alignment: the kernel loads a row in 16-byte
#: vector loads
ROW_ALIGN = 16
#: rules a thread runs at most (kMaxRun in the source: a block stages
#: its run's bytecode in shared memory)
MAX_RUN = 64
#: resident waves a launch fills before its runs grow past one rule
#: (``rule_runs``): the last blocks of a launch find idle SMs, so a
#: launch of a few waves loses more of its time to its end than runs of
#: a few rules lose to loading their word
MIN_WAVES = 8

#: the TPU kernel this one replaces, and this kernel's source
REPLACES = "dprf_tpu/ops/pallas_rules.py:442"
SOURCE = "dprf_tpu_torch/csrc/rules.cu"

#: the rules kernel's cores by the source that instantiates them, in the
#: order of their ids: by the device engine's ``core`` (``ldap-sha`` runs
#: on sha1's, sha3-N and keccak-N on ``keccakN``'s, the pad byte a launch
#: parameter), the 64-byte cores (sha224 and mysql323 included), the
#: nested chains, then the wide cores: sha512 and sha384 over SHA-512's
#: 128-byte block, and the sponge at rates 144, 136, 104 and 72.
CORE_SOURCES = {
    "rules": ("md5", "ntlm", "sha1", "sha256", "sha224", "mysql323"),
    "rules_nested": ("md5(md5)", "sha1(sha1)", "md5(sha1)", "sha1(md5)",
                     "sha256(md5)", "sha256(sha1)", "mysql41"),
    "rules_wide": ("sha512", "sha384", "keccak224", "keccak256",
                   "keccak384", "keccak512")}
#: the core id of the rules kernel's C interface (each source's
#: DPRF_DISPATCH switch takes its own cores' ids)
KERNEL_CORES = {core: i for i, core in enumerate(
    c for cores in CORE_SOURCES.values() for c in cores)}
#: the rules kernel's group tails by the source that instantiates them
#: (csrc/rules_group.cu: the salted variants of the 64-byte cores,
#: ``cuda_ext.SALTED_NAMES`` and MSSQL's UTF-16LE sha1, and Kerberos
#: etype 23; csrc/rules_wide.cu: sha512's, ``cuda_ext.WIDE_SALTED`` and
#: MSSQL 2012's UTF-16LE), and their ids, which each source's
#: DPRF_GROUP_DISPATCH switch takes
TAIL_SOURCES = {
    "rules_group": ("md5-ps", "md5-sp", "sha1-ps", "sha1-sp", "sha256-ps",
                    "sha256-sp", "sha1-ps-utf16", "krb5"),
    "rules_wide": ("sha512-ps", "sha512-sp", "sha512-ps-utf16")}
GROUP_TAILS = {tail: i for i, tail in enumerate(
    t for tails in TAIL_SOURCES.values() for t in tails)}
KRB5 = "krb5"
#: the core whose slots a tail's candidate sits in: the salted
#: algorithm's, or md4's (ntlm) for Kerberos
TAIL_CORES = {t: ("ntlm" if t == KRB5 else t.split("-")[0])
              for t in GROUP_TAILS}
#: the sources of the kernel's instantiations
SOURCES = ("rules", "rules_nested", "rules_group", "rules_wide")
SOURCE_FILES = {src: f"dprf_tpu_torch/csrc/{src}.cu" for src in SOURCES}

#: opcodes the kernel interprets: all but PURGE (a compaction) and
#: TITLE / TITLE_SEP (a separator scan), as in the reference's kernel;
#: jobs with them are refused
SUPPORTED = frozenset(Opcode) - {Opcode.PURGE, Opcode.TITLE,
                                 Opcode.TITLE_SEP}


#: a list's compare modes (csrc/compare.cuh ``Compare``): the blocked
#: probe in shared memory, the bulk probe in global memory
LIST_MODES = {PROBE: "_probe", BULK: "_bulk"}


def kernel_name(core: str, mode: int = 0) -> str:
    """The instantiation's name: ``<core>_rules`` for one target,
    ``<core>_rules_probe`` or ``<core>_rules_bulk`` for a list, and
    ``<tail>_rules`` for a group tail (``GROUP_TAILS``)."""
    return f"{core}_rules" + LIST_MODES.get(mode, "")


def replaces(core: str) -> str:
    """The TPU kernel row an instantiation (a core or a group tail)
    stands under: the rules kernel's, which the first four cores replace
    and whose template sha224, mysql323, the wide cores and the salted
    tails share; the nested chains' (pallas_ext.py's nested kernel) and
    Kerberos' (pallas_krb5.py's), whose chains and filter they run.  The
    reference runs the wordlists of all but the first four on XLA."""
    from dprf_tpu_torch.ops import cuda_ext, cuda_krb5
    if core == KRB5:
        return cuda_krb5.REPLACES
    if core in cuda_ext.NESTED_NAMES:
        return cuda_ext.REPLACES_NESTED
    return REPLACES


def source_of(core: str) -> str:
    """The source that instantiates a core (``KERNEL_CORES``) or a group
    tail (``GROUP_TAILS``)."""
    sources = TAIL_SOURCES if core in GROUP_TAILS else CORE_SOURCES
    return next(src for src, cores in sources.items() if core in cores)


#: launches of each kernel instantiation in this process, by
#: ``kernel_name`` (tests and chip_smoke.py reset them and read them)
launches = {kernel_name(n, m): 0 for n in KERNEL_CORES
            for m in (0, *LIST_MODES)}
launches.update({kernel_name(t): 0 for t in GROUP_TAILS})


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def rules_supported(rules: Sequence[Sequence[Op]]) -> bool:
    return all(len(ops) <= MAX_STEPS
               and all(op.opcode in SUPPORTED for op in ops)
               for ops in rules)


def encode_rules(rules: Sequence[Sequence[Op]],
                 n_steps: int = None) -> np.ndarray:
    """Rule set -> bytecode int32[R, n_steps, 3] of (opcode, p1, p2);
    steps past a rule's ops stay (NOOP, 0, 0).  n_steps defaults to the
    longest rule."""
    n_steps = (max((len(ops) for ops in rules), default=1)
               if n_steps is None else n_steps)
    bc = np.zeros((len(rules), max(1, n_steps), 3), np.int32)
    for r, ops in enumerate(rules):
        for s, op in enumerate(ops):
            bc[r, s] = (int(op.opcode), op.p1, op.p2)
    return bc


def rule_tables(rules: Sequence[Sequence[Op]], device="cpu"):
    """The kernel's rule inputs: (bytecode int32[R, MAX_STEPS, 3], n_ops
    int32[R]) on ``device``."""
    if not rules_supported(rules):
        raise ValueError(f"rules need at most {MAX_STEPS} ops each and no "
                         "PURGE/TITLE/TITLE_SEP op")
    bc = torch.as_tensor(encode_rules(rules, MAX_STEPS), device=device)
    n_ops = torch.as_tensor([len(ops) for ops in rules], dtype=torch.int32,
                            device=device)
    return bc, n_ops


def decode_rules(bytecode: torch.Tensor, n_ops: torch.Tensor) -> list:
    """``rule_tables``' tensors -> the rules as Op tuples."""
    bc = bytecode.cpu().numpy()
    return [tuple(Op(Opcode(int(c)), int(p1), int(p2))
                  for c, p1, p2 in bc[r, :n])
            for r, n in enumerate(n_ops.cpu().tolist())]


def rules_engine(engine_name: str, device="cpu"):
    """The device engine of ``engine_name`` if the rules kernel has its
    core; its tensors on ``device``."""
    from dprf_tpu_torch.engines import engine_names, get_engine
    if engine_name.lower() in engine_names("cuda"):
        eng = get_engine(engine_name, "cuda", torch_device=device)
        if getattr(eng, "core", None) in KERNEL_CORES:
            return eng
    raise ValueError(f"no rules kernel core for engine {engine_name!r} "
                     f"(cores: {', '.join(KERNEL_CORES)})")


def kernel_rules_eligible(engine_name: str, gen, n_targets: int) -> bool:
    """Whether the kernel takes this job: a core engine, one target or a
    list of any length, a wordlist generator whose max_len fits one
    block (27 for ntlm, 111 for sha512 and sha384, rate - 1 for a sponge,
    55 for the others), rules of at most MAX_STEPS supported ops."""
    try:
        eng = rules_engine(engine_name)
    except ValueError:
        return False
    if n_targets < 1 or not (hasattr(gen, "rules")
                             and hasattr(gen, "packed_words")):
        return False
    return (1 <= gen.max_len <= eng.max_candidate_len
            and rules_supported(gen.rules))


def _check_job(eng, words: torch.Tensor, lens: torch.Tensor,
               bytecode: torch.Tensor, n_ops: torch.Tensor, ws: int,
               n_valid: int, target: Sequence[int], hit_capacity: int,
               word_batch: int, max_len: int = None) -> None:
    """Raise on a job the kernel does not take.  The table's rows are
    max_len bytes (default: its width), or that padded (``row_bytes``).
    ``target``: one target's digest words, or None for a list."""
    device = words.device
    if words.dtype != torch.uint8 or words.dim() != 2:
        raise ValueError(f"words must be uint8[n_words, max_len], got "
                         f"{words.dtype}{list(words.shape)}")
    n_words, width = words.shape
    max_len = width if max_len is None else max_len
    if not 1 <= max_len <= eng.max_candidate_len:
        raise ValueError(f"{eng.name}: max_len {max_len} outside "
                         f"1..{eng.max_candidate_len}")
    if width not in (max_len, row_bytes(max_len)):
        raise ValueError(f"word table rows of {width} bytes: max_len "
                         f"{max_len} takes {max_len} or {row_bytes(max_len)}")
    if lens.dtype != torch.int32 or list(lens.shape) != [n_words]:
        raise ValueError(f"lens must be int32[{n_words}], got "
                         f"{lens.dtype}{list(lens.shape)}")
    if bytecode.dtype != torch.int32 or bytecode.dim() != 3 or \
            list(bytecode.shape[1:]) != [MAX_STEPS, 3]:
        raise ValueError(f"bytecode must be int32[R, {MAX_STEPS}, 3], got "
                         f"{bytecode.dtype}{list(bytecode.shape)}")
    n_rules = bytecode.shape[0]
    if n_ops.dtype != torch.int32 or list(n_ops.shape) != [n_rules]:
        raise ValueError(f"n_ops must be int32[{n_rules}]")
    for name, t in (("lens", lens), ("bytecode", bytecode),
                    ("n_ops", n_ops)):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, words on {device}")
    for name, t in (("words", words), ("lens", lens),
                    ("bytecode", bytecode), ("n_ops", n_ops)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if word_batch < WARP or word_batch % WARP:
        raise ValueError(f"word_batch {word_batch} must be a positive "
                         f"multiple of {WARP}")
    if not 1 <= n_rules * word_batch < 1 << 31:
        raise ValueError(f"{n_rules} rules x {word_batch} words overflow "
                         "the int32 hit lanes")
    if not 0 <= n_valid <= word_batch or not 0 <= ws <= n_words - n_valid:
        raise ValueError(f"window of {n_valid} words at {ws} outside the "
                         f"{n_words}-word table or the {word_batch}-word "
                         "batch")
    if target is not None and len(target) != eng.digest_words:
        raise ValueError(f"{eng.name} needs {eng.digest_words} target "
                         f"words, got {len(target)}")
    if hit_capacity < 0:
        raise ValueError("hit_capacity must be >= 0")


class _RulesArgs(ctypes.Structure):
    """``struct RulesArgs`` of csrc/rules.cu."""
    _fields_ = [("max_len", ctypes.c_int32), ("n_rules", ctypes.c_int32),
                ("word_batch", ctypes.c_int32), ("ws", ctypes.c_int32),
                ("n_valid", ctypes.c_int32),
                ("target", ctypes.c_uint32 * 8), ("run", ctypes.c_int32)]


class _WideRulesArgs(_RulesArgs):
    """``struct WideRulesArgs`` of csrc/rules_wide.cu: RulesArgs, a wide
    core's 16 target words and a sponge's pad byte."""
    _fields_ = [("wide_target", ctypes.c_uint32 * 16),
                ("pad", ctypes.c_uint32)]


class _GroupArgs(ctypes.Structure):
    """``struct GroupArgs`` of csrc/rules_group.cu."""
    _fields_ = [("rows", ctypes.c_void_p), ("count", ctypes.c_void_p),
                ("lanes", ctypes.c_void_p), ("tpos", ctypes.c_void_p),
                ("tcount", ctypes.c_void_p), ("n_targets", ctypes.c_int32),
                ("shift", ctypes.c_int32), ("msg_type", ctypes.c_uint32),
                ("upper", ctypes.c_int32), ("cap", ctypes.c_int32)]


@functools.cache
def _library(src: str = "rules"):
    """The C entry points of one source (``SOURCES``), built at first
    use: a core's (``CORE_SOURCES``), a group tail's (``TAIL_SOURCES``),
    or both."""
    from dprf_tpu_torch.ops import _build
    lib = _build.load(src)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if src in TAIL_SOURCES:
        lib.dprf_rules_group_launch.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr, ctypes.POINTER(_RulesArgs),
            ctypes.POINTER(_GroupArgs), i32, i32, i32, ptr]
        lib.dprf_rules_group_launch.restype = i32
        lib.dprf_rules_group_shared_bytes.argtypes = [i32, i32,
                                                      ctypes.POINTER(i32)]
        lib.dprf_rules_group_shared_bytes.restype = i32
        lib.dprf_rules_group_blocks_per_sm.argtypes = [i32, i32,
                                                       ctypes.POINTER(i32)]
        lib.dprf_rules_group_blocks_per_sm.restype = i32
    if src not in CORE_SOURCES:
        return lib
    args = ctypes.POINTER(_WideRulesArgs if src == "rules_wide"
                          else _RulesArgs)
    lib.dprf_rules_launch.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, args, ptr, ptr, i32, i32, i32, ptr]
    lib.dprf_rules_launch.restype = i32
    lib.dprf_rules_list_launch.argtypes = [
        i32, i32, i32, ptr, ptr, ptr, ptr, args,
        ctypes.POINTER(cuda_mask.MultiArgs), ptr, ptr, ptr, ptr, i32, i32,
        i32, i32, ptr]
    lib.dprf_rules_list_launch.restype = i32
    for fn in (lib.dprf_rules_blocks_per_sm, lib.dprf_rules_shared_bytes):
        fn.argtypes = [i32, ctypes.POINTER(i32)]
        fn.restype = i32
    lib.dprf_rules_list_blocks_per_sm.argtypes = [i32, i32, i32,
                                                  ctypes.POINTER(i32)]
    lib.dprf_rules_list_blocks_per_sm.restype = i32
    return lib


def load_kernel(src: str = None) -> None:
    """Build and load the kernel now (one source, or all of them), so a
    build failure surfaces at worker construction rather than at the
    first batch."""
    for name in (src,) if src else SOURCES:
        _library(name)


def row_bytes(max_len: int) -> int:
    """The kernel's word table row: max_len bytes padded to ROW_ALIGN."""
    return -(-max_len // ROW_ALIGN) * ROW_ALIGN


def pad_rows(words: torch.Tensor) -> torch.Tensor:
    """A word table uint8[n_words, max_len] (``gen.packed_words``') with
    its rows padded with zeros to ``row_bytes(max_len)``, on its device."""
    max_len = words.shape[1]
    return torch.nn.functional.pad(words, (0, row_bytes(max_len) - max_len))


def _query(name: str, core: str, *args) -> int:
    """A C query of the core's source: its int result."""
    value = ctypes.c_int(0)
    rc = getattr(_library(source_of(core)), name)(*args, ctypes.byref(value))
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    return value.value


@functools.cache
def shared_bytes(core: str) -> int:
    """Dynamic shared memory of one block of an instantiation: its
    threads' word slots and its run's ops."""
    return _query("dprf_rules_shared_bytes", core, KERNEL_CORES[core])


@functools.cache
def blocks_per_sm(core: str, mode: int = 0, smem: int = 0) -> int:
    """Resident blocks per SM for one instantiation (a list's at its
    ``smem`` bytes of dynamic shared memory), from the CUDA occupancy
    calculator."""
    if mode:
        blocks = _query("dprf_rules_list_blocks_per_sm", core,
                        KERNEL_CORES[core], int(mode), smem)
    else:
        blocks = _query("dprf_rules_blocks_per_sm", core, KERNEL_CORES[core])
    if blocks < 1:
        raise RuntimeError(f"occupancy query: {blocks} blocks per SM")
    return blocks


def list_shared_bytes(core: str, mode: int, block_bits: int) -> int:
    """Dynamic shared memory of one block of a list's instantiation: the
    slots, and for PROBE the bitmap of 16 << block_bits words."""
    extra = 64 << block_bits if mode == PROBE else 0
    return shared_bytes(core) + extra


def word_blocks(n_valid: int) -> int:
    """Blocks of THREADS words that cover a window of n_valid words."""
    return -(-n_valid // THREADS)


def rule_runs(n_valid: int, n_rules: int, wave: int) -> int:
    """Rules a thread runs over its word: the longest run (at most
    MAX_RUN) at which the launch's ``launch_grid`` blocks still fill
    MIN_WAVES waves of ``wave`` resident blocks, or runs of one rule
    where even those fill fewer."""
    n_runs = min(n_rules, -(-MIN_WAVES * wave // word_blocks(n_valid)))
    run = -(-n_rules // n_runs)
    while -(-n_rules // run) < n_runs:
        run -= 1
    return min(MAX_RUN, run)


def launch_grid(n_valid: int, n_rules: int, run: int) -> int:
    """The launch's blocks: word blocks x runs.  Block g takes run
    g // word_blocks(n_valid) and word block g % word_blocks(n_valid)."""
    return word_blocks(n_valid) * -(-n_rules // run)


def thread_work(block: int, thread: int, n_valid: int, n_rules: int,
                run: int):
    """(word b of the window, its rules) of one thread, as csrc/rules.cu
    derives them, or None for a thread whose warp lies past the window;
    a thread of a live warp past n_valid has no rules."""
    bx = word_blocks(n_valid)
    j = block // bx
    b = (block - j * bx) * THREADS + thread
    if b & ~(WARP - 1) >= n_valid:
        return None
    rules = range(j * run, min(j * run + run, n_rules))
    return b, (rules if b < n_valid else range(0))


def rules_kernel(engine: str, words: torch.Tensor, lens: torch.Tensor,
                 bytecode: torch.Tensor, n_ops: torch.Tensor, ws: int,
                 n_valid: int, target: Sequence[int], hit_capacity: int,
                 word_batch: int, max_len: int = None, run: int = None):
    """Launch the kernel over words [ws, ws + n_valid) of the table
    under every rule: words uint8[n_words, row_bytes(max_len)]
    (``pad_rows`` of ``gen.packed_words``) and lens int32[n_words],
    bytecode and n_ops from ``rule_tables``, all on the card; the target
    as the core's uint32 digest words; word_batch, the hit lanes' stride
    between rules.  max_len defaults to the table's width; a table of
    unpadded max_len-byte rows is padded here, a copy each launch.  run:
    rules a thread takes, by default ``rule_runs`` for this card
    (chip_smoke.py sets it to run a whole rule set as one run).
    Returns (count int32[1], lanes int32[hit_capacity]) on the card,
    still being computed."""
    eng, words, max_len = _kernel_job(engine, words, lens, bytecode, n_ops,
                                      ws, n_valid, target, hit_capacity,
                                      word_batch, max_len)
    device = words.device
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    lanes = torch.full((hit_capacity,), -1, dtype=torch.int32,
                       device=device)
    if n_valid == 0:
        return count, lanes
    args = _launch_args(bytecode, ws, n_valid, target, word_batch, max_len,
                        run, blocks_per_sm(eng.core), device, eng)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library(source_of(eng.core)).dprf_rules_launch(
        KERNEL_CORES[eng.core], device.index, words.data_ptr(),
        lens.data_ptr(), bytecode.data_ptr(), n_ops.data_ptr(),
        ctypes.byref(args), count.data_ptr(), lanes.data_ptr(),
        hit_capacity, launch_grid(n_valid, bytecode.shape[0], args.run),
        THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel_name(eng.core)} kernel launch failed: "
                           f"CUDA error {rc}")
    launches[kernel_name(eng.core)] += 1
    return count, lanes


def _kernel_job(engine, words, lens, bytecode, n_ops, ws, n_valid, target,
                hit_capacity, word_batch, max_len):
    """A kernel launch's checks: (engine, the padded table, max_len)."""
    if words.device.type != "cuda":
        raise ValueError(f"the CUDA rules kernel takes CUDA tensors, got "
                         f"words on {words.device}")
    eng = rules_engine(engine, words.device)
    max_len = words.shape[1] if max_len is None else max_len
    _check_job(eng, words, lens, bytecode, n_ops, ws, n_valid, target,
               hit_capacity, word_batch, max_len)
    if words.shape[1] != row_bytes(max_len):
        words = pad_rows(words)
    return eng, words, max_len


def _launch_args(bytecode, ws, n_valid, target, word_batch, max_len, run,
                 blocks, device, eng=None) -> _RulesArgs:
    """The launch's RulesArgs -- a wide core's (``eng``) WideRulesArgs,
    with its target words and its sponge's pad byte -- its run from
    ``rule_runs`` at ``blocks`` resident blocks an SM unless ``run`` is
    given."""
    n_rules = bytecode.shape[0]
    if run is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        run = rule_runs(n_valid, n_rules, sms * blocks)
    if not 1 <= run <= min(n_rules, MAX_RUN):
        raise ValueError(f"run {run} outside 1..{min(n_rules, MAX_RUN)}")
    words = [int(w) & 0xFFFFFFFF for w in (target or ())]
    if eng is not None and source_of(eng.core) == "rules_wide":
        return _WideRulesArgs(
            max_len, n_rules, word_batch, ws, n_valid,
            (ctypes.c_uint32 * 8)(), run,
            (ctypes.c_uint32 * 16)(*words), getattr(eng, "pad_byte", 0))
    return _RulesArgs(max_len, n_rules, word_batch, ws, n_valid,
                      (ctypes.c_uint32 * 8)(*words), run)


def _check_list(eng, mode, probe_words, block_bits, k, table, device):
    if mode not in LIST_MODES:
        raise ValueError(f"list mode {mode} not in {sorted(LIST_MODES)}")
    cuda_mask.check_probe(
        probe_words, block_bits, k, device,
        cuda_mask.PROBE_MAX_BLOCK_BITS if mode == PROBE
        else cuda_mask.BULK_MAX_BLOCK_BITS)
    if table is None:
        if mode == PROBE:
            raise ValueError("the shared-memory probe needs the sorted table")
    else:
        cuda_mask.check_table(eng, table, device, bulk=mode == BULK)


def rules_list_kernel(engine: str, mode: int, words: torch.Tensor,
                      lens: torch.Tensor, bytecode: torch.Tensor,
                      n_ops: torch.Tensor, ws: int, n_valid: int,
                      probe_words: torch.Tensor, block_bits: int, k: int,
                      table, hit_capacity: int, word_batch: int,
                      max_len: int = None, run: int = None):
    """Launch a list's instantiation (mode PROBE or BULK) over words [ws,
    ws + n_valid) under every rule (the table, rules and run as
    ``rules_kernel``): probe_words int32[16 << block_bits] (PROBE:
    ``cuda_mask.probe_rows``, at most 10 block bits; BULK: a
    ``ProbeTable``'s), k bits a candidate, table int32[T, W] the sorted
    ``TargetTable`` on the card, or None for a bulk host-verify list.
    Returns (count int32[1], lanes int32[cap], tpos int32[cap], n_maybe
    int32[1]) on the card, still being computed."""
    eng, words, max_len = _kernel_job(engine, words, lens, bytecode, n_ops,
                                      ws, n_valid, None, hit_capacity,
                                      word_batch, max_len)
    device = words.device
    _check_list(eng, mode, probe_words, block_bits, k, table, device)
    count, lanes, tpos, n_maybe = cuda_mask.hit_buffers(True, hit_capacity,
                                                        device)
    if n_valid == 0:
        return count, lanes, tpos, n_maybe
    smem = list_shared_bytes(eng.core, mode, block_bits)
    args = _launch_args(bytecode, ws, n_valid, None, word_batch, max_len, run,
                        blocks_per_sm(eng.core, mode, smem), device, eng)
    margs = cuda_mask.MultiArgs(
        probe_words.data_ptr(), None if table is None else table.data_ptr(),
        0, 0 if table is None else table.shape[0], block_bits, k)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _library(source_of(eng.core)).dprf_rules_list_launch(
        KERNEL_CORES[eng.core], int(mode), device.index, words.data_ptr(),
        lens.data_ptr(), bytecode.data_ptr(), n_ops.data_ptr(),
        ctypes.byref(args), ctypes.byref(margs), count.data_ptr(),
        lanes.data_ptr(), tpos.data_ptr(), n_maybe.data_ptr(), hit_capacity,
        launch_grid(n_valid, bytecode.shape[0], args.run), THREADS, smem,
        stream)
    name = kernel_name(eng.core, mode)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    return count, lanes, tpos, n_maybe


def rules_plain(engine: str, words: torch.Tensor, lens: torch.Tensor,
                bytecode: torch.Tensor, n_ops: torch.Tensor, ws: int,
                n_valid: int, target: Sequence[int], hit_capacity: int,
                word_batch: int):
    """``rules_kernel``'s function in plain PyTorch on the words'
    device; hit lanes come back in ascending order."""
    eng = rules_engine(engine, words.device)
    _check_job(eng, words, lens, bytecode, n_ops, ws, n_valid, target,
               hit_capacity, word_batch)
    digest, valid = _digest_plain(eng, words, lens, bytecode, n_ops, ws,
                                  n_valid, word_batch)
    want = cmp_ops.target_words_from_numpy(np.asarray(target, np.uint32),
                                           words.device)
    found = cmp_ops.compare_single(digest, want) & valid
    count, lanes, _ = cmp_ops.compact_hits(found, torch.zeros_like(
        found, dtype=torch.int32), hit_capacity)
    return count, lanes


def rules_list_plain(engine: str, mode: int, words: torch.Tensor,
                     lens: torch.Tensor, bytecode: torch.Tensor,
                     n_ops: torch.Tensor, ws: int, n_valid: int,
                     probe_words: torch.Tensor, block_bits: int, k: int,
                     table, hit_capacity: int, word_batch: int):
    """``rules_list_kernel``'s function in plain PyTorch on the words'
    device (an unpadded table): every (word, rule) digest, the probe
    (``cuda_mask.probe_found``), then ``compare_multi`` on the
    survivors, or every survivor at tpos -1 without a table; hit lanes
    come back in ascending order."""
    eng = rules_engine(engine, words.device)
    _check_job(eng, words, lens, bytecode, n_ops, ws, n_valid, None,
               hit_capacity, word_batch)
    _check_list(eng, mode, probe_words, block_bits, k, table, words.device)
    digest, valid = _digest_plain(eng, words, lens, bytecode, n_ops, ws,
                                  n_valid, word_batch)
    maybe = cuda_mask.probe_found(digest, probe_words, block_bits, k, valid)
    if table is None:
        found, tpos = maybe, torch.full_like(maybe, -1, dtype=torch.int32)
    else:
        found, tpos = cmp_ops.compare_multi(digest, table)
        found = found & maybe
    count, lanes, tpos = cmp_ops.compact_hits(found, tpos, hit_capacity)
    return count, lanes, tpos, maybe.sum(dtype=torch.int32).reshape(1)


def _digest_plain(eng, words, lens, bytecode, n_ops, ws, n_valid,
                  word_batch):
    """Every rule over the window's words, rule-major: (digest int32[R *
    word_batch, W], valid bool[R * word_batch])."""
    cand, clen, valid = _expand_plain(words, lens, bytecode, n_ops, ws,
                                      n_valid, word_batch)
    return eng.digest_packed(eng.pack_varlen(cand, clen)), valid


def _expand_plain(words, lens, bytecode, n_ops, ws, n_valid, word_batch):
    """Every rule over the window's words, rule-major, in plain PyTorch
    (rules/device.py): (candidates uint8[R * word_batch, max_len],
    lengths int32[R * word_batch], kept bool[R * word_batch]); a lane past
    the window's words is not kept."""
    device, max_len = words.device, words.shape[1]
    # the window's words, padded to word_batch with empty words that
    # the lane mask drops
    w = torch.zeros((word_batch, max_len), dtype=torch.uint8, device=device)
    ln = torch.zeros((word_batch,), dtype=torch.int32, device=device)
    w[:n_valid] = words[ws:ws + n_valid]
    ln[:n_valid] = lens[ws:ws + n_valid]
    in_window = torch.arange(word_batch, device=device) < n_valid
    return tuple(torch.cat(x) for x in zip(*(
        rules_device.apply_rule(w, ln, in_window, ops, max_len)
        for ops in decode_rules(bytecode, n_ops))))


def rules_crack(engine: str, words: torch.Tensor, *args,
                max_len: int = None):
    """The kernel on CUDA tensors (``max_len``: its growth limit, for a
    padded table), its plain version on CPU tensors, whose table is
    unpadded (arguments as ``rules_plain``)."""
    if words.device.type == "cuda":
        return rules_kernel(engine, words, *args, max_len=max_len)
    if words.device.type == "cpu":
        return rules_plain(engine, words, *args)
    raise ValueError(f"no rules kernel for device {words.device}")


def rules_crack_list(engine: str, mode: int, words: torch.Tensor, *args,
                     max_len: int = None):
    """A list's kernel on CUDA tensors, its plain version on CPU tensors
    (arguments as ``rules_list_plain``)."""
    if words.device.type == "cuda":
        return rules_list_kernel(engine, mode, words, *args, max_len=max_len)
    if words.device.type == "cpu":
        return rules_list_plain(engine, mode, words, *args)
    raise ValueError(f"no rules kernel for device {words.device}")


def make_cuda_rules_crack_step(engine: str, gen, target,
                               word_batch: int, hit_capacity: int = 64,
                               device="cuda"):
    """The worker's step: step(ws, n_valid_words) -> (count int32[1],
    lanes int32[hit_capacity], tpos int32[hit_capacity]) over words
    [ws, ws + n_valid_words) and every rule, lanes rule-major (lane =
    r * word_batch + b), tpos all 0; step(ws, n, cap=N) sets one call's
    hit capacity (a relaunch).  The packed word table and the rule
    tables go to ``device`` once, here, the table's rows padded to
    ``row_bytes`` on a card.  ``target``: the core's uint32 digest
    words; or a list -- the sorted ``TargetTable`` of 2..N_BULK targets
    (the shared-memory probe at ``cuda_mask.probe_rows``' bitmap) or a
    bulk list's ``probe.ProbeTable`` (the bulk probe) -- whose step
    returns (count, lanes, tpos, n_maybe) with tpos the sorted table's
    positions (-1 for a host-verify survivor)."""
    from dprf_tpu_torch.targets.probe import ProbeTable
    if not kernel_rules_eligible(engine, gen, 1):
        limit = rules_engine(engine).max_candidate_len
        raise ValueError(
            f"wordlist job not eligible for the rules kernel: engine "
            f"{engine!r}, max_len {gen.max_len} (1..{limit}), rules of at "
            f"most {MAX_STEPS} ops without PURGE/TITLE/TITLE_SEP")
    device = torch.device(device)
    words, lens, bytecode, n_ops = job_tables(gen, device)
    if isinstance(target, (cmp_ops.TargetTable, ProbeTable)):
        if isinstance(target, ProbeTable):
            mode, state = BULK, cuda_mask.probe_tensors(target, device)
        else:
            bits, block_bits, k = cuda_mask.probe_rows(target.words)
            mode, state = PROBE, (
                torch.as_tensor(bits.view(np.int32), device=device),
                block_bits, k, target.tensor(device))

        def list_step(ws: int, n_valid: int, cap: int = None):
            return rules_crack_list(
                engine, mode, words, lens, bytecode, n_ops, ws, n_valid,
                *state, hit_capacity if cap is None else cap, word_batch,
                max_len=gen.max_len)

        list_step.word_batch = word_batch
        return list_step
    target = [int(w) for w in np.asarray(target, np.uint32).ravel()]
    tpos = torch.zeros((hit_capacity,), dtype=torch.int32, device=device)

    def step(ws: int, n_valid: int, cap: int = None):
        n = hit_capacity if cap is None else cap
        count, lanes = rules_crack(engine, words, lens, bytecode, n_ops, ws,
                                   n_valid, target, n, word_batch,
                                   max_len=gen.max_len)
        return count, lanes, tpos if n == hit_capacity else \
            torch.zeros_like(lanes)

    step.word_batch = word_batch
    return step


# ---- a group of targets: the salted and Kerberos tails ----------------------

def job_tables(gen, device) -> tuple:
    """A wordlist job's tables on ``device``, once a job: (words uint8[N,
    row], lens int32[N], bytecode, n_ops) -- the packed words (their rows
    padded to ``row_bytes`` on a card) and ``rule_tables``."""
    device = torch.device(device)
    buf, lens = gen.packed_words()
    words = torch.as_tensor(buf, device=device)
    if device.type == "cuda":
        words = pad_rows(words)
    return (words, torch.as_tensor(lens, device=device),
            *rule_tables(gen.rules, device))


def tail_geometry(tail: str) -> tuple:
    """(most targets a group, a row's words, bytes a candidate character
    takes, the block's message limit) of a group tail."""
    from dprf_tpu_torch.ops import cuda_ext, cuda_krb5
    if tail not in GROUP_TAILS:
        raise ValueError(f"no rules group tail {tail!r} (tails: "
                         f"{', '.join(GROUP_TAILS)})")
    if tail == KRB5:
        return cuda_krb5.GROUP, cuda_krb5.ROW, 2, cuda_ext.BLOCK_LIMIT
    _, _, limit, width = cuda_ext.salted_geometry(tail)
    return (cuda_ext.SALTED_GROUP, cuda_ext.rule_row_layout(tail)[0], width,
            limit)


def _check_group(tail, words, lens, bytecode, n_ops, ws, n_valid, rows,
                 hit_capacity, word_batch, shift, max_len=None):
    """Raise on a group launch the kernel does not take; returns max_len.
    A salted group's salts were checked against max_len where its rows
    were made (``cuda_ext.salted_rule_rows``); an ``sp`` group's salt
    length ``shift`` is checked here."""
    from dprf_tpu_torch.ops import cuda_ext
    group, row, width, limit = tail_geometry(tail)
    eng = device_engine(TAIL_CORES[tail], words.device)
    max_len = words.shape[1] if max_len is None else max_len
    _check_job(eng, words, lens, bytecode, n_ops, ws, n_valid, None,
               hit_capacity, word_batch, max_len)
    cuda_mask._check_tensor("group rows", rows, 2, words.device)
    if not 1 <= rows.shape[0] <= group or rows.shape[1] != row:
        raise ValueError(f"group rows must be int32[1..{group}, {row}], "
                         f"got {list(rows.shape)}")
    sp = tail != KRB5 and cuda_ext.split_salted(tail)[1] == "sp"
    if not (0 <= shift <= cuda_ext.SALT_MAX and (shift == 0 or sp)
            and width * max_len + shift <= limit):
        raise ValueError(f"salt shift {shift} outside 0..{cuda_ext.SALT_MAX},"
                         f" past the {limit}-byte block at max_len "
                         f"{max_len} or on a ps or krb5 tail")
    return max_len


@functools.cache
def group_shared_bytes(tail: str, n_targets: int) -> int:
    """Dynamic shared memory of one block of a group tail over
    ``n_targets``: the slots and ops, the RC4 states (Kerberos), the
    rows."""
    return _query("dprf_rules_group_shared_bytes", tail, GROUP_TAILS[tail],
                  n_targets)


@functools.cache
def group_blocks_per_sm(tail: str, smem: int) -> int:
    """Resident blocks per SM of a group tail at ``smem`` bytes."""
    blocks = _query("dprf_rules_group_blocks_per_sm", tail,
                    GROUP_TAILS[tail], smem)
    if blocks < 1:
        raise RuntimeError(f"occupancy query: {blocks} blocks per SM")
    return blocks


def rules_group_kernel(tail: str, words: torch.Tensor, lens: torch.Tensor,
                       bytecode: torch.Tensor, n_ops: torch.Tensor, ws: int,
                       n_valid: int, rows: torch.Tensor, hit_capacity: int,
                       word_batch: int, *, shift: int = 0,
                       msg_type: int = 0, upper: bool = False,
                       max_len: int = None, run: int = None):
    """Launch the group tail ``tail`` (``GROUP_TAILS``) over words [ws, ws
    + n_valid) of the table under every rule (the table, rules and run as
    ``rules_kernel``) for a group of targets: rows int32[T, row] on the
    card (``cuda_ext.salted_rule_rows``, ``cuda_krb5.ticket_rows``);
    ``shift`` an ``sp`` group's salt length, ``msg_type`` a Kerberos
    group's, ``upper`` MSSQL 2000's uppercase of the candidate.  Returns
    (count int32[1], lanes int32[cap], tpos int32[cap], tcount int32[T])
    on the card, still being computed: the (lane, target position) hits,
    -1 in unused slots, and each target's own count."""
    if words.device.type != "cuda":
        raise ValueError(f"the CUDA rules kernel takes CUDA tensors, got "
                         f"words on {words.device}")
    max_len = _check_group(tail, words, lens, bytecode, n_ops, ws, n_valid,
                           rows, hit_capacity, word_batch, shift, max_len)
    if words.shape[1] != row_bytes(max_len):
        words = pad_rows(words)
    device = words.device
    n_targets = rows.shape[0]
    count, lanes, tpos = cuda_mask.hit_buffers(False, hit_capacity, device)
    tpos.fill_(-1)
    tcount = torch.zeros((n_targets,), dtype=torch.int32, device=device)
    if n_valid == 0:
        return count, lanes, tpos, tcount
    smem = group_shared_bytes(tail, n_targets)
    args = _launch_args(bytecode, ws, n_valid, None, word_batch, max_len, run,
                        group_blocks_per_sm(tail, smem), device)
    group = _GroupArgs(rows.data_ptr(), count.data_ptr(), lanes.data_ptr(),
                       tpos.data_ptr(), tcount.data_ptr(), n_targets, shift,
                       msg_type, int(upper), hit_capacity)
    rc = _library(source_of(tail)).dprf_rules_group_launch(
        GROUP_TAILS[tail], device.index, words.data_ptr(), lens.data_ptr(),
        bytecode.data_ptr(), n_ops.data_ptr(), ctypes.byref(args),
        ctypes.byref(group), launch_grid(n_valid, bytecode.shape[0], args.run),
        THREADS, smem, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel_name(tail)} kernel launch failed: CUDA "
                           f"error {rc}")
    launches[kernel_name(tail)] += 1
    return count, lanes, tpos, tcount


def rules_group_plain(tail: str, words: torch.Tensor, lens: torch.Tensor,
                      bytecode: torch.Tensor, n_ops: torch.Tensor, ws: int,
                      n_valid: int, rows: torch.Tensor, hit_capacity: int,
                      word_batch: int, *, shift: int = 0, msg_type: int = 0,
                      upper: bool = False):
    """``rules_group_kernel``'s function in plain PyTorch on the words'
    device (an unpadded table): every rule over the window's words
    (rules/device.py), then each kept candidate against each target --
    the salted message and the core (``cuda_ext.salted_rule_found``) or
    the Kerberos filter (``cuda_krb5.tickets_found``); the (lane, target)
    hits in lane then target order."""
    from dprf_tpu_torch.ops import cuda_ext, cuda_krb5
    _check_group(tail, words, lens, bytecode, n_ops, ws, n_valid, rows,
                  hit_capacity, word_batch, shift)
    cand, clen, kept = _expand_plain(words, lens, bytecode, n_ops, ws,
                                     n_valid, word_batch)
    if tail == KRB5:
        found = cuda_krb5.tickets_found(cand, clen, msg_type, rows)
    else:
        found = cuda_ext.salted_rule_found(tail, cand, clen, rows, upper)
    return cmp_ops.compact_group_hits(found & kept[:, None], hit_capacity)


def rules_group_crack(tail: str, words: torch.Tensor, *args,
                      max_len: int = None, **params):
    """A group tail's kernel on CUDA tensors, its plain version on CPU
    tensors (arguments as ``rules_group_plain``)."""
    if words.device.type == "cuda":
        return rules_group_kernel(tail, words, *args, max_len=max_len,
                                  **params)
    if words.device.type == "cpu":
        return rules_group_plain(tail, words, *args, **params)
    raise ValueError(f"no rules kernel for device {words.device}")


def make_rules_group_step(tail: str, tables: tuple, max_len: int,
                          rows: torch.Tensor, word_batch: int,
                          hit_capacity: int, **params):
    """A group's step over a job's ``tables`` (``job_tables``, shared by
    its groups): step(ws, n_valid_words) -> (count int32[1], lanes
    int32[cap], tpos int32[cap], tcount int32[T]) over words [ws, ws +
    n_valid_words) and every rule, lanes rule-major; step(ws, n, cap=N)
    sets one call's hit capacity (a relaunch); ``params`` as
    ``rules_group_kernel``'s (shift, msg_type, upper)."""
    words, lens, bytecode, n_ops = tables

    def step(ws: int, n_valid: int, cap: int = None):
        return rules_group_crack(
            tail, words, lens, bytecode, n_ops, ws, n_valid, rows,
            hit_capacity if cap is None else cap, word_batch,
            max_len=max_len, **params)

    step.word_batch = word_batch
    return step
