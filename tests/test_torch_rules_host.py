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
CASES = [(e, m) for e in cuda_rules.KERNEL_CORES for m in (16, 27, 55)
         if m <= (27 if e == "ntlm" else 55)]

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


def host_source(src: str) -> str:
    """csrc/rules.cu for g++: SHIM for the CUDA headers, the launch as a
    loop over blocks and threads, the run's staging (and a list's bitmap)
    done by each thread, no barrier, and a record of each candidate at
    its marker."""
    edits = [
        ("#include <cuda_runtime.h>", SHIM),
        ('#include "cores.cuh"',
         f'#include "{os.path.abspath(os.path.join(CSRC, "cores.cuh"))}"'),
        ('#include "compare.cuh"',
         f'#include "{os.path.abspath(os.path.join(CSRC, "compare.cuh"))}"'),
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
        assert src.count(old) == 1, f"csrc/rules.cu changed: {old!r}"
        src = src.replace(old, new)
    launch = re.compile(r"rules_kernel<Core, kMode><<<grid, kThreads, "
                        r"smem, stream>>>\(")
    assert len(launch.findall(src)) == 1, "csrc/rules.cu changed: launch"
    return launch.sub(
        "for (blockIdx.x = 0; blockIdx.x < (unsigned)grid; ++blockIdx.x) "
        "for (threadIdx.x = 0; threadIdx.x < kThreads; ++threadIdx.x) "
        "rules_kernel<Core, kMode>(", src)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build csrc/rules.cu for the CPU")
    out = tmp_path_factory.mktemp("rules_host")
    with open(os.path.join(CSRC, "rules.cu")) as fh:
        (out / "rules_host.cpp").write_text(host_source(fh.read()))
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-o", str(out / "rules_host.so"),
                    str(out / "rules_host.cpp")], check=True)
    so = ctypes.CDLL(str(out / "rules_host.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    so.dprf_rules_launch.argtypes = [
        i32, i32, ptr, ptr, ptr, ptr, ctypes.POINTER(cuda_rules._RulesArgs),
        ptr, ptr, i32, i32, i32, ptr]
    so.dprf_rules_shared_bytes.argtypes = [i32, ctypes.POINTER(i32)]
    so.emu_take.argtypes = [ptr]
    so.emu_set_long.argtypes = [i32]
    for core in cuda_rules.KERNEL_CORES.values():
        smem = ctypes.c_int(0)
        assert so.dprf_rules_shared_bytes(core, ctypes.byref(smem)) == 0
        assert smem.value <= so.emu_smem_bytes()
    return so


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
@pytest.mark.parametrize("engine,max_len", CASES)
def test_every_candidate_matches_the_reference(lib, engine, max_len, run):
    job = _all_ops_job(max_len)
    count, lanes, recs = job.launch(lib, engine, run)
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


@pytest.mark.parametrize("long_path", [False, True])
@pytest.mark.parametrize("engine,max_len", CASES)
def test_planted_digests_hit_their_lanes(lib, engine, max_len, long_path):
    """The digests of candidates of every length class (0, 1, 3-5,
    15-17, max_len - 1, max_len) as targets: the count and the lanes are
    every lane with that candidate; an unreachable digest hits none."""
    job = _all_ops_job(max_len)
    eng = get_engine(engine)
    le = engine in ("md5", "ntlm")
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
            want = sorted(lane for lane, cc in job.want.items() if cc == c)
            assert (count, lanes) == (len(want), want), c
    finally:
        lib.emu_set_long(0)
