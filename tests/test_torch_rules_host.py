"""csrc/rules.cu itself, built for the CPU with g++: the CUDA built-ins it
uses become plain C++ (``SHIM``), a launch becomes a loop over the grid's
blocks and threads, and each candidate's words are recorded where the
kernel writes its 0x80 marker.  Every (word, rule) candidate is held
against the reference's rule interpreter (dprf_tpu/rules/cpu.apply_rule):
under every op the kernel takes and under random rules of up to 8 ops, at
max_len 16, 27 and 55, with runs of one rule, of a few and of MAX_RUN, so
the restore between a thread's rules runs after every op.  Planted digests
hold the pack, the cores and the compare against the engines' hashes, on
the short-message path and on the full one.

A thread runs to its end before the next one starts, so each thread
stages its block's run of ops in full, and a warp's vote (``__all_sync``)
is the thread's own predicate, or false with ``emu_set_long(1)``.  What
only a card shows (the warps, the shared-memory banks, nvcc's code) is
chip_smoke.py phase 8's.  Skips where there is no g++.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dprf_tpu.rules import cpu as ref_cpu
from dprf_tpu.rules import parser as ref_parser
from dprf_tpu_torch.engines import get_engine
from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
from dprf_tpu_torch.ops import cuda_rules
from dprf_tpu_torch.ops.compare import digest_rows
from dprf_tpu_torch.rules import parser

from test_torch_rules import RULES, WORDS

pytestmark = pytest.mark.smoke

CSRC = os.path.join(os.path.dirname(cuda_rules.__file__), os.pardir, "csrc")

#: RULES of test_torch_rules.py, less the ops the kernel refuses, and
#: edge cases: NUL and 0xff bytes, positions 0 and past the word, ops
#: repeated, the longest rules
EDGE_RULES = [
    "s\x00Q", "!\x00", "/\x00", "%3\x00", "O05", "OZ1", "x05", "xA5", "D0",
    "i0A", "iZA", "z0", "Z0", "y0", "Y0", "p1", "p0", "pZ", "d d", "f f",
    "q q", "$a $b $c $d $e $f", "^a ^b ^c", "r r", "{ { {", "} } }", "Y5",
    "y5", "z9", "Z9", "'0", "T0", "*11", "*10", "K K", "k k", "L0", "R0",
    "+0", "-0", ".0", ",0", ",1", ".Z", "sab", "s  ", "$\xff", "o0\xff",
    "T0 T1 T2", "i5\x00", "^\x00 $\x00", "d ]", "f [", "Z5 '3", "z5 D0",
    "x23 O12", "p3 '8", "u }", "c {", "t r", "l $1 $2 $3 $4 $5 $6 $7",
    "]]]] $a"]
ALL_RULES = [r for r in RULES if r not in ("@l", "E", "e-")] + EDGE_RULES
#: the engines' growth limits: max_len 55 only where the core has it
CASES = [(e, m) for e in ("md5", "ntlm", "sha1", "sha256")
         for m in (16, 27, 55) if m <= (27 if e == "ntlm" else 55)]
#: and the cores the kernel took since: sha224, mysql323, the nested
#: chains (csrc/rules_nested.cu); csrc/rules_wide.cu's wide cores are
#: tests/test_torch_slice_o.py's
CORE_CASES = CASES + [(e, m) for e in cuda_rules.KERNEL_CORES
                      if e not in ("md5", "ntlm", "sha1", "sha256")
                      and cuda_rules.source_of(e) != "rules_wide"
                      for m in (16, 27, 55)]

SHIM = r"""
#include <cstdint>
#include <cstddef>
#include <algorithm>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __constant__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(x)
using std::min;
using std::max;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* b, F, int, size_t) { *b = 1; return 0; }
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
struct Dim { unsigned x; };
static Dim threadIdx, blockIdx;
struct uint4 { uint32_t x, y, z, w; };
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s)
{ return (uint32_t)(((((uint64_t)hi << 32) | lo) << (s & 31)) >> 32); }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s)
{ return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31)); }
inline uint32_t __funnelshift_lc(uint32_t lo, uint32_t hi, uint32_t s)
{
    s = s > 32 ? 32 : s;
    return (uint32_t)(((((uint64_t)hi << 32) | lo) << s) >> 32);
}
inline uint32_t __funnelshift_rc(uint32_t lo, uint32_t hi, uint32_t s)
{
    s = s > 32 ? 32 : s;
    return s == 32 ? hi : (uint32_t)((((uint64_t)hi << 32) | lo) >> s);
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s)
{
    const uint64_t v = ((uint64_t)y << 32) | x;
    uint32_t r = 0;
    for (int i = 0; i < 4; ++i)
        r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
    return r;
}
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int atomicAdd(int32_t* p, int v)
{
    const int o = *p;
    *p += v;
    return o;
}
inline unsigned __activemask() { return 0xffffffffu; }
static bool emu_long = false;
extern "C" void emu_set_long(int on) { emu_long = on != 0; }
inline bool __all_sync(unsigned, bool p) { return p && !emu_long; }
static uint32_t smem[1 << 16];
extern "C" int emu_smem_bytes() { return (int)sizeof(smem); }
// each recorded candidate: its lane, its length, its 14 words
static std::vector<int32_t> recs;
inline void emu_record(int lane, int n, const uint32_t* v, int nw)
{
    recs.push_back(lane);
    recs.push_back(n);
    for (int k = 0; k < 14; ++k) recs.push_back(k < nw ? (int32_t)v[k] : 0);
}
extern "C" int emu_records() { return (int)recs.size() / 16; }
extern "C" void emu_take(int32_t* out)
{
    std::copy(recs.begin(), recs.end(), out);
    recs.clear();
}
"""


def host_source(name: str = "rules") -> str:
    """csrc/<name>.cu for g++: csrc/rules_kernel.cuh inlined and the other
    headers included by path, SHIM for the CUDA headers, the launch as a
    loop over blocks and threads, the run's staging (and a list's bitmap,
    a group's rows) done by each thread, no barrier, and a record of each
    candidate at its marker."""
    with open(os.path.join(CSRC, name + ".cu")) as fh:
        src = fh.read()
    with open(os.path.join(CSRC, "rules_kernel.cuh")) as fh:
        kernel = fh.read()
    inc = '#include "rules_kernel.cuh"'
    assert src.count(inc) == 1, f"csrc/{name}.cu changed: {inc}"
    src = SHIM + re.sub(r'#include "(\w+\.cuh)"', lambda m: '#include "%s"' % (
        os.path.abspath(os.path.join(CSRC, m.group(1)))),
        src.replace(inc, kernel.replace("#pragma once\n", "")))
    edits = [
        ("#include <cuda_runtime.h>", ""),
        ("for (int i = threadIdx.x; i < n_probe; i += kThreads)",
         "for (int i = 0; i < n_probe; ++i)"),
        ("for (int i = threadIdx.x; i < 3 * nr * DPRF_RULE_STEPS; "
         "i += kThreads)",
         "for (int i = 0; i < 3 * nr * DPRF_RULE_STEPS; ++i)"),
        ("for (int i = threadIdx.x; i < nr; i += kThreads)",
         "for (int i = 0; i < nr; ++i)"),
        ("    __syncthreads();\n", "\n"),
        ("        W.byte(n) = 0x80;\n",
         "        W.byte(n) = 0x80;\n"
         "        { uint32_t v[NW]; for (int k = 0; k < NW; ++k) v[k] = "
         "W.at(k); emu_record((r0 + rr) * args.word_batch + b, n, v, NW); }"
         "\n"),
    ]
    for old, new in edits:
        assert src.count(old) == 1, f"csrc/rules_kernel.cuh changed: {old!r}"
        src = src.replace(old, new)
    # a group's rows, staged by each thread
    src = src.replace("for (int i = threadIdx.x; i < g.n_targets * kRow;\n"
                      "             i += kThreads)",
                      "for (int i = 0; i < g.n_targets * kRow; ++i)")
    assert "threadIdx.x; i <" not in src, f"csrc/{name}.cu: a staging loop"
    launch = re.compile(r"(\w+<Core, \w+>)<<<grid, kThreads, smem, "
                        r"stream>>>\(")
    assert launch.findall(src), f"csrc/{name}.cu changed: launch"
    return launch.sub(
        "for (blockIdx.x = 0; blockIdx.x < (unsigned)grid; ++blockIdx.x) "
        "for (threadIdx.x = 0; threadIdx.x < kThreads; ++threadIdx.x) "
        r"\1(", src)


def build_host(out, name: str) -> ctypes.CDLL:
    """csrc/<name>.cu built with g++ into ``out``, loaded."""
    (out / f"{name}_host.cpp").write_text(host_source(name))
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-o", str(out / f"{name}_host.so"),
                    str(out / f"{name}_host.cpp")], check=True)
    return ctypes.CDLL(str(out / f"{name}_host.so"))


def _launch_types(so) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if hasattr(so, "dprf_rules_group_launch"):
        so.dprf_rules_group_launch.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr,
            ctypes.POINTER(cuda_rules._RulesArgs),
            ctypes.POINTER(cuda_rules._GroupArgs), i32, i32, i32, ptr]
        so.dprf_rules_group_shared_bytes.argtypes = [i32, i32,
                                                     ctypes.POINTER(i32)]
    else:
        so.dprf_rules_launch.argtypes = [
            i32, i32, ptr, ptr, ptr, ptr,
            ctypes.POINTER(cuda_rules._RulesArgs), ptr, ptr, i32, i32, i32,
            ptr]
        so.dprf_rules_shared_bytes.argtypes = [i32, ctypes.POINTER(i32)]
    so.emu_take.argtypes = [ptr]
    so.emu_set_long.argtypes = [i32]
    return so


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/rules.cu built for the CPU."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build csrc/rules.cu for the CPU")
    return _launch_types(build_host(tmp_path_factory.mktemp("rules_host"),
                                    "rules"))


@pytest.fixture(scope="module")
def libs(lib, tmp_path_factory):
    """Every source of the rules kernel built for the CPU, by name; each
    core's slots fit the emulation's shared memory."""
    out = tmp_path_factory.mktemp("rules_host_more")
    libs = {"rules": lib,
            "rules_nested": _launch_types(build_host(out, "rules_nested")),
            "rules_group": _launch_types(build_host(out, "rules_group"))}
    for core in {e for e, _ in CORE_CASES}:
        i = cuda_rules.KERNEL_CORES[core]
        smem = ctypes.c_int(0)
        assert libs[cuda_rules.source_of(core)].dprf_rules_shared_bytes(
            i, ctypes.byref(smem)) == 0
        assert smem.value <= lib.emu_smem_bytes()
    return libs


class Job:
    """A word list under rule lines at max_len, the window cut mid-warp
    (words 3 .. n - 2), the kernel's tables and the reference's
    candidates by lane."""

    def __init__(self, words, lines, max_len):
        self.words, self.max_len = words, max_len
        self.rules = [parser.parse_rule(r) for r in lines]
        assert cuda_rules.rules_supported(self.rules)
        gen = WordlistRulesGenerator(words, self.rules, max_len)
        buf, lens = gen.packed_words()
        self.table = cuda_rules.pad_rows(torch.as_tensor(buf)).numpy()
        self.lens = np.ascontiguousarray(lens, np.int32)
        self.bc = np.ascontiguousarray(
            cuda_rules.encode_rules(self.rules, cuda_rules.MAX_STEPS))
        self.n_ops = np.array([len(r) for r in self.rules], np.int32)
        self.ws, self.nv = 3, len(words) - 5
        self.wb = -(-self.nv // 32) * 32 + 32
        ref = [ref_parser.parse_rule(r) for r in lines]
        self.want = {r * self.wb + b: c for r, ops in enumerate(ref)
                     for b in range(self.nv)
                     if (c := ref_cpu.apply_rule(words[self.ws + b], ops,
                                                 max_len)) is not None}

    def launch(self, so, engine, run, target=(0,) * 8, cap=64):
        """(count, sorted lanes, records int32[n, 16]) of one launch."""
        count = np.zeros(1, np.int32)
        lanes = np.full(cap, -1, np.int32)
        target = list(target) + [0] * (8 - len(target))
        args = cuda_rules._RulesArgs(
            self.max_len, len(self.rules), self.wb, self.ws, self.nv,
            (ctypes.c_uint32 * 8)(*target), run)
        grid = cuda_rules.launch_grid(self.nv, len(self.rules), run)
        assert so.dprf_rules_launch(
            cuda_rules.KERNEL_CORES[engine], 0, self.table.ctypes.data,
            self.lens.ctypes.data, self.bc.ctypes.data,
            self.n_ops.ctypes.data, ctypes.byref(args), count.ctypes.data,
            lanes.ctypes.data, cap, grid, cuda_rules.THREADS, None) == 0
        recs = np.zeros((so.emu_records(), 16), np.int32)
        so.emu_take(recs.ctypes.data)
        return int(count[0]), sorted(int(x) for x in lanes if x >= 0), recs

    def check_records(self, recs, engine):
        """Each lane once, and its words: the reference's candidate, 0x80
        at its length, zeros after."""
        nw = (get_engine(engine).max_candidate_len + 4) // 4
        got = {}
        for row in recs:
            lane = int(row[0])
            assert lane not in got, f"lane {lane} twice"
            got[lane] = (int(row[1]), row[2:2 + nw].astype(np.uint32)
                         .view(np.uint8).tobytes())
        assert sorted(got) == sorted(self.want)
        for lane, c in self.want.items():
            want = c + b"\x80" + bytes(4 * nw - len(c) - 1)
            r, b = divmod(lane, self.wb)
            assert got[lane] == (len(c), want), (
                self.words[self.ws + b], ALL_RULES[r] if len(
                    self.rules) == len(ALL_RULES) else self.rules[r])


def _words(max_len, seed):
    """WORDS, a few odd bytes, and a random word of every length
    0..max_len in all bytes and in printable ones."""
    rng = np.random.default_rng(seed)
    words = [w for w in WORDS if len(w) <= max_len]
    words += [b"\x00a\x00", b"@[`{", b"\xc1\xe1Zz"]
    for lo, hi in ((0, 256), (32, 127)):
        words += [bytes(rng.integers(lo, hi, n, dtype=np.uint8))
                  for n in range(max_len + 1)]
    return words


@functools.cache
def _all_ops_job(max_len):
    return Job(_words(max_len, max_len), ALL_RULES, max_len)


def test_the_rules_hold_every_op():
    rules = [parser.parse_rule(r) for r in ALL_RULES]
    assert {op.opcode for ops in rules for op in ops} == cuda_rules.SUPPORTED


@pytest.mark.parametrize("run", [1, 3, cuda_rules.MAX_RUN])
@pytest.mark.parametrize("engine,max_len", CORE_CASES)
def test_every_candidate_matches_the_reference(libs, engine, max_len, run):
    job = _all_ops_job(max_len)
    count, lanes, recs = job.launch(libs[cuda_rules.source_of(engine)],
                                    engine, run)
    assert (count, lanes) == (0, [])
    job.check_records(recs, engine)


# random rules: one to eight ops of every kind
_ONE = "lucCtrdfq{}[]kK:"
_POS = "TpDzZyYLR+-.,'<>_"


def _random_rule(rng):
    pos = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"

    def p():
        return pos[int(rng.integers(0, 12 if rng.random() < .8 else 36))]

    def ch():
        return chr(int(rng.choice([0, 32, 48, 97, 65, 122, 90, 126, 255, 101]))
                   if rng.random() < .5 else int(rng.integers(0, 256)))

    ops = []
    for _ in range(int(rng.integers(1, 9))):
        kind = int(rng.integers(0, 6))
        if kind == 0:
            ops.append(_ONE[int(rng.integers(0, len(_ONE)))])
        elif kind == 1:
            ops.append(_POS[int(rng.integers(0, len(_POS)))] + p())
        elif kind == 2:
            ops.append("io="[int(rng.integers(0, 3))] + p() + ch())
        elif kind == 3:
            ops.append("xO*"[int(rng.integers(0, 3))] + p() + p())
        elif kind == 4:
            ops.append("$^!/()"[int(rng.integers(0, 6))] + ch())
        else:
            ops.append("s" + ch() + ch() if rng.random() < .5
                       else "%" + p() + ch())
    return "".join(ops)


@pytest.mark.parametrize("engine,max_len",
                         [("md5", 55), ("ntlm", 27), ("sha1", 16)])
def test_random_rules_match_the_reference(lib, engine, max_len):
    """150 random rules of 1-8 ops over 64 words, in the runs the host
    picks for a one-block wave (runs of 19 rules)."""
    rng = np.random.default_rng(max_len)
    lines = [_random_rule(rng) for _ in range(150)]
    words = [bytes(rng.integers(0, 256, int(rng.integers(0, max_len + 1)),
                                dtype=np.uint8)) if rng.random() < .3
             else bytes(rng.integers(97, 123, int(rng.integers(
                 0, min(max_len, 14) + 1)), dtype=np.uint8))
             for _ in range(64)]
    job = Job(words, lines, max_len)
    run = cuda_rules.rule_runs(job.nv, len(lines), 1)
    assert run > 1
    job.check_records(job.launch(lib, engine, run)[2], engine)


@functools.cache
def _mysql323_digests(max_len):
    """The all-ops job's candidates by their mysql323 digest."""
    cands = sorted(set(_all_ops_job(max_len).want.values()))
    return dict(zip(cands, get_engine("mysql323").hash_batch(cands)))


@pytest.mark.parametrize("long_path", [False, True])
@pytest.mark.parametrize("engine,max_len", CORE_CASES)
def test_planted_digests_hit_their_lanes(libs, engine, max_len, long_path):
    """The digests of candidates of every length class (0, 1, 3-5,
    15-17, max_len - 1, max_len) as targets: the count and the lanes are
    every lane with that candidate (mysql323: with that digest, since its
    scan skips spaces and tabs); an unreachable digest hits none."""
    job = _all_ops_job(max_len)
    eng = get_engine(engine)
    le = get_engine(engine, "cuda", torch_device="cpu").little_endian
    lib = libs[cuda_rules.source_of(engine)]
    rng = np.random.default_rng(len(CASES) * max_len + long_path)
    classes = [(0, 0), (1, 1), (3, 5), (15, 17), (max_len - 1, max_len - 1),
               (max_len, max_len)]
    plants = []
    for lo, hi in classes:
        pool = sorted({c for c in job.want.values() if lo <= len(c) <= hi})
        plants.append(pool[int(rng.integers(0, len(pool)))])
    lib.emu_set_long(int(long_path))
    try:
        for c in plants + [b"\xff" * (max_len + 1)]:
            target = [int(w) for w in digest_rows(eng.hash_batch([c]),
                                                  le)[0]]
            count, lanes, _ = job.launch(lib, engine, 7, target, cap=4096)
            if engine == "mysql323":
                d = eng.hash_batch([c])[0]
                same = {cc for cc, dd in _mysql323_digests(max_len).items()
                        if dd == d}
            else:
                same = {c}
            want = sorted(lane for lane, cc in job.want.items() if cc in same)
            assert (count, lanes) == (len(want), want), c
    finally:
        lib.emu_set_long(0)


# ---- the group tails (csrc/rules_group.cu) ------------------------------

def _salted_digest(tail: str, cand: bytes, salt: bytes, upper: bool):
    """hashlib's digest of a salted tail's message."""
    algo, order = tail.split("-")[:2]
    if upper:
        cand = cand.upper() if cand.isascii() else bytes(
            c - 32 if 97 <= c <= 122 else c for c in cand)
    if tail.endswith("-utf16"):
        cand = bytes(b for c in cand for b in (c, 0))
    msg = cand + salt if order == "ps" else salt + cand
    return hashlib.new(algo, msg).digest()


#: (tail, max_len, salt lengths of the group's targets, MSSQL 2000's
#: uppercase): every tail at max_len 16 and at the longest its salts
#: leave (27 for Kerberos, whose rows hold tickets)
GROUP_CASES = [
    ("md5-ps", 16, (0, 1, 3, 7, 32), False), ("md5-ps", 51, (0, 4), False),
    ("md5-sp", 16, (5, 5, 5), False), ("md5-sp", 55, (0, 0), False),
    ("sha1-ps", 16, (0, 2, 31), False), ("sha1-ps", 45, (10, 10), False),
    ("sha1-sp", 16, (32, 32), False), ("sha1-sp", 51, (4, 4), False),
    ("sha256-ps", 16, (1, 8, 32), False), ("sha256-ps", 55, (0,), False),
    ("sha256-sp", 16, (3, 3), False), ("sha256-sp", 52, (3, 3), False),
    ("sha1-ps-utf16", 16, (4, 4, 4), False),
    ("sha1-ps-utf16", 25, (4, 4), True), ("krb5", 16, (), False),
    ("krb5", 27, (), False)]


def _group_rows(tail, job, salt_lens, upper, rng):
    """A group's rows (numpy int32) and its targets' planted candidates
    (one a target, the last target a random digest or a ticket of a
    password past max_len), and the launch's msg_type and shift."""
    from dprf_tpu_torch.engines.cpu.krb5 import TGS_MSG_TYPE, der, encrypt
    from dprf_tpu_torch.ops import cuda_ext, cuda_krb5
    pool = sorted(set(job.want.values()))
    plants = [pool[int(i)] for i in rng.choice(len(pool), 3, replace=False)]
    if tail == cuda_rules.KRB5:
        tgts = []
        for i, c in enumerate(plants + [b"\xff" * 40]):
            plain = bytes(8) + der(0x63, der(0x30, bytes(range(i, 60 + i))))
            chk, edata = encrypt(c, TGS_MSG_TYPE, plain)
            t = get_engine("krb5tgs").parse_target(
                f"$krb5tgs$23$*u$R$s*${chk.hex()}${edata.hex()}")
            tgts.append(cuda_krb5.target_kernel_args(t))
        rows = cuda_krb5.ticket_rows(tgts)
        return rows.view(np.int32), plants, TGS_MSG_TYPE, 0
    algo = tail.split("-")[0]
    group = []
    for i, n in enumerate(salt_lens):
        salt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        d = _salted_digest(tail, plants[i % len(plants)], salt, upper) \
            if i < len(salt_lens) - 1 else rng.bytes(hashlib.new(algo).digest_size)
        group.append((salt, [int(w) for w in digest_rows([d],
                                                         algo == "md5")[0]]))
    rows = cuda_ext.salted_rule_rows(tail, group, job.max_len)
    shift = salt_lens[0] if tail.endswith("-sp") else 0
    return rows.view(np.int32), plants, 0, shift


@pytest.mark.parametrize("tail,max_len,salt_lens,upper", GROUP_CASES)
def test_group_tail_matches_plain(libs, tail, max_len, salt_lens, upper):
    """Every (word, rule) candidate of the all-ops job against a group:
    the host-built tail's count, (lane, target) pairs and per-target
    counts equal its plain version's (``rules_group_plain``), and each
    planted candidate's lanes are among its target's hits."""
    so = libs["rules_group"]
    job = _all_ops_job(max_len)
    rng = np.random.default_rng(max_len + len(salt_lens))
    rows, plants, msg_type, shift = _group_rows(tail, job, salt_lens, upper,
                                                rng)
    T = rows.shape[0]
    cap = 4096
    count = np.zeros(1, np.int32)
    lanes = np.full(cap, -1, np.int32)
    tpos = np.full(cap, -1, np.int32)
    tcount = np.zeros(T, np.int32)
    run = 7
    args = cuda_rules._RulesArgs(job.max_len, len(job.rules), job.wb, job.ws,
                                 job.nv, (ctypes.c_uint32 * 8)(), run)
    group = cuda_rules._GroupArgs(
        rows.ctypes.data, count.ctypes.data, lanes.ctypes.data,
        tpos.ctypes.data, tcount.ctypes.data, T, shift, msg_type,
        int(upper), cap)
    smem = ctypes.c_int(0)
    tid = cuda_rules.GROUP_TAILS[tail]
    assert so.dprf_rules_group_shared_bytes(tid, T, ctypes.byref(smem)) == 0
    assert smem.value <= so.emu_smem_bytes()
    assert so.dprf_rules_group_launch(
        tid, 0, job.table.ctypes.data, job.lens.ctypes.data,
        job.bc.ctypes.data, job.n_ops.ctypes.data, ctypes.byref(args),
        ctypes.byref(group), cuda_rules.launch_grid(job.nv, len(job.rules),
                                                    run),
        cuda_rules.THREADS, smem.value, None) == 0
    recs = np.zeros((so.emu_records(), 16), np.int32)
    so.emu_take(recs.ctypes.data)          # each candidate, at its marker
    assert len(recs) == len(job.want)
    gen = WordlistRulesGenerator(job.words, job.rules, max_len)
    buf, lens = gen.packed_words()
    bc, n_ops = cuda_rules.rule_tables(job.rules)
    pc, pl, pt, ptc = cuda_rules.rules_group_plain(
        tail, torch.as_tensor(buf), torch.as_tensor(lens), bc, n_ops, job.ws,
        job.nv, torch.as_tensor(rows), cap, job.wb, shift=shift,
        msg_type=msg_type, upper=upper)
    got = sorted((int(a), int(b)) for a, b in zip(lanes, tpos) if a >= 0)
    want = sorted((int(a), int(b)) for a, b in zip(pl, pt) if a >= 0)
    assert (int(count[0]), got, tcount.tolist()) == \
        (int(pc), want, ptc.tolist())
    for t in range(T - 1):
        c = plants[t % len(plants)]
        assert {(lane, t) for lane, cc in job.want.items() if cc == c} <= \
            set(got), (tail, t, c)
    assert tcount[T - 1] == 0
