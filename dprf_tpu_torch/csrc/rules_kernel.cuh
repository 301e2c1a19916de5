// rules_kernel.cuh -- the fused wordlist+rules kernel for Hopper (sm_90a):
// rule interpreter -> pack -> hash -> compare, one target, a list, or a
// group of salted targets or Kerberos tickets.  csrc/rules.cu,
// csrc/rules_nested.cu, csrc/rules_group.cu and csrc/rules_wide.cu
// instantiate it.
//
// Per candidate (word b of the window, rule r): apply the rule's ops to
// the word with the semantics of rules/cpu.py (growth past max_len and
// the rejection ops reject; a position past the end makes an op a
// no-op), place the bytes, the 0x80 marker and the bit length in one
// block (little-endian for md5/md4, big-endian for SHA, UTF-16LE widened
// for ntlm), run the core of cores.cuh and compare all digest words with
// the target.  A rejected lane, or one past the window's valid words, is
// never compared.
//
// A list of targets (the Compare mode, csrc/compare.cuh): the blocked
// probe over the list's bitmap, in shared memory after the block's slots
// (kProbe: at most 64 KiB, the mask kernel's PROBE sizing) or read from
// global memory (kBulk: a bulk list's bitmap of any size), then each
// survivor's exact verify against the sorted table on the card (or, in
// the bulk table's host-verify layout, every survivor reported at
// position -1 for the oracle); hits append (lane, table position) and
// n_maybe counts the survivors.  The reference sends lists to its XLA
// pipeline (ops/rules_pipeline.py: compare_multi, probe_hits); its Pallas
// kernel takes one target.
//
// A group (csrc/rules_group.cu): the same run of rules, then each kept
// candidate is hashed with every target of a group -- its salt after or
// before the candidate, or a Kerberos ticket -- the work that does not
// depend on the target done once a candidate.  The run of rules is
// rules_body below, whatever becomes of its candidates (a tail).
//
// The TPU kernel's artefacts of Mosaic are not carried over: its
// (word_tile, rule) grid over structure-of-arrays byte registers, the
// L^2 select "gather" that moves bytes, the bucketing of rules by op
// count, the window padding that exists because dynamic_slice clamps,
// and the packed (count << 16) | (hit_lane + 1) output.  What stays is
// the step contract: hit lanes are rule-major (lane = r * B + b, B the
// step's words per rule), every hit appends its lane, and count > cap
// sends the word window to the worker's exact rescan.
//
// What bounds it: issue slots -- the core's rounds (~126 slots per md5
// candidate, ~950 per sha256 one, ops/opcount.py) plus the rule's ops
// and the pack, which the bound counts as zero; a list adds the probe's
// few bits a candidate (and the digest's last rounds, which one target's
// word-0 compare skips).
//
// What the design does about it.  The candidate is kept as 32-bit words
// in the md5/md4 message layout (byte p in word p >> 2 at bits
// 8 * (p & 3)), with every byte at or past the length n zero, so the
// pack is the words themselves: 0x80 at n, the bit length, and for SHA
// one PRMT byte swap a word, for ntlm two PRMTs that widen a word to two
// message words.  The words sit in 32-bit shared-memory slots (word k of
// thread t at slot k * kThreads + t, conflict-free at any per-thread k),
// so a loop runs to the thread's own length and a byte at a run-time
// position is one LDS.U8 / STS.U8: the case maps and the byte compares
// are SWAR over the words that hold the n bytes; the positional ops,
// `$` and `]` one byte; the shifting ops funnel shifts across the words
// from the first one they touch; only the rare `r f q y Y` move a byte at
// a time.  (Registers, with a byte at a run-time position as a select
// over 14 words, measured slower: PERF.md row 4.)  A thread holds one
// word of the window, loaded once in 16-byte vector loads from a table
// whose rows are padded with zeros to a multiple of 16 bytes, and runs a
// run of consecutive rules over it, restoring before each rule the words
// the last one set from a second slot array.  A block's threads share
// the run, whose ops the block stages in shared memory (opcode, p1, p2,
// a byte each), so every warp applies the same rule at every step: the
// op dispatch is warp-uniform and the op loads broadcast; `$` and `]`,
// the commonest ops, are tested before the switch.  The host
// (ops/cuda_rules.rule_runs) picks the run so that the launch fills
// several resident waves; a block's index gives its word block and run
// with one divide a thread, not one a candidate.  A warp whose
// candidates all fit in 16 bytes hashes them with the message words past
// the fourth constant zero, which the core folds away, and digest word 0
// is compared first, so md5's and md4's last three rounds run only on a
// match of it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "compare.cuh"
#include "cores.cuh"

#define DPRF_RULE_STEPS 8

// threads per block
constexpr int kThreads = 256;

// The opcodes of rules/parser.Opcode (a test holds the values equal).
enum Opcode : int {
    OP_NOOP = 0,
    OP_LOWER = 1,
    OP_UPPER = 2,
    OP_CAPITALIZE = 3,
    OP_INV_CAPITALIZE = 4,
    OP_TOGGLE_ALL = 5,
    OP_TOGGLE_AT = 6,
    OP_REVERSE = 7,
    OP_DUPLICATE = 8,
    OP_DUPLICATE_N = 9,
    OP_REFLECT = 10,
    OP_ROT_LEFT = 11,
    OP_ROT_RIGHT = 12,
    OP_DEL_FIRST = 13,
    OP_DEL_LAST = 14,
    OP_DEL_AT = 15,
    OP_EXTRACT = 16,
    OP_OMIT = 17,
    OP_INSERT = 18,
    OP_OVERWRITE = 19,
    OP_TRUNCATE = 20,
    OP_SUBSTITUTE = 21,
    OP_DUP_FIRST = 23,
    OP_DUP_LAST = 24,
    OP_DUP_ALL = 25,
    OP_SWAP_FRONT = 26,
    OP_SWAP_BACK = 27,
    OP_SWAP_AT = 28,
    OP_SHIFT_LEFT = 29,
    OP_SHIFT_RIGHT = 30,
    OP_INCR_AT = 31,
    OP_DECR_AT = 32,
    OP_REPL_NEXT = 33,
    OP_REPL_PREV = 34,
    OP_DUP_BLOCK_FRONT = 35,
    OP_DUP_BLOCK_BACK = 36,
    OP_APPEND = 37,
    OP_PREPEND = 38,
    OP_REJ_GT = 41,
    OP_REJ_LT = 42,
    OP_REJ_NEQ_LEN = 43,
    OP_REJ_CONTAIN = 44,
    OP_REJ_NOT_CONTAIN = 45,
    OP_REJ_NOT_FIRST = 46,
    OP_REJ_NOT_LAST = 47,
    OP_REJ_NOT_AT = 48,
    OP_REJ_LT_COUNT = 49,
};

// Kernel parameters of one launch (mirrored by ops/cuda_rules._RulesArgs).
struct RulesArgs {
    int32_t max_len;     // the growth limit; the table's rows are max_len
                         // bytes padded with zeros to a multiple of 16
    int32_t n_rules;
    int32_t word_batch;  // B, the hit lanes' stride between rules
    int32_t ws;          // the window's first word
    int32_t n_valid;     // the window's words, <= B
    uint32_t target[8];  // the target's digest words
    int32_t run;         // rules a thread runs over its word
};

// ---- word formulas ------------------------------------------------------
//
// tests/test_torch_k3.py mirrors them in numpy (with the byte at a
// position, the marker, the ntlm widen and the SHA swap) and holds them
// against the reference's rule interpreter and pack.

// x << s with s clamped at 32: 0 for s >= 32, and so for a negative s
// taken as unsigned
__device__ __forceinline__ uint32_t shl_c(uint32_t x, uint32_t s)
{
    return __funnelshift_lc(0u, x, s);
}

// The bytes of word k at positions below x, as a byte mask.
__device__ __forceinline__ uint32_t below(int k, int x)
{
    return ~shl_c(0xffffffffu, (uint32_t)max(8 * (x - 4 * k), 0));
}

// 0x20, a byte's case bit, in each byte of x in [lo, lo + 25]; bytes
// with the top bit set are never letters
__device__ __forceinline__ uint32_t letters(uint32_t x, uint32_t lo)
{
    const uint32_t t = x & 0x7f7f7f7fu;
    const uint32_t a = t + (0x80u - lo) * 0x01010101u;
    const uint32_t z = t + (0x80u - lo - 26u) * 0x01010101u;
    return (a & ~z & ~x & 0x80808080u) >> 2;
}

__device__ __forceinline__ uint32_t swar_lower(uint32_t x)
{
    return x ^ letters(x, 0x41);
}

__device__ __forceinline__ uint32_t swar_upper(uint32_t x)
{
    return x ^ letters(x, 0x61);
}

__device__ __forceinline__ uint32_t swar_toggle(uint32_t x)
{
    return x ^ letters(x | 0x20202020u, 0x61);
}

// 0x80 in each zero byte of x, exactly
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x)
{
    return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}

// 0xff in each byte of x equal to c
__device__ __forceinline__ uint32_t eq_mask(uint32_t x, uint32_t c)
{
    return (zero_bytes(x ^ (c * 0x01010101u)) >> 7) * 0xffu;
}

// ---- a thread's words in shared memory ---------------------------------
//
// Word k of a thread's candidate sits at w[k * kThreads]: the 32-bit
// slots of one word index lie in consecutive banks across a warp, so 32
// threads at any per-thread k never conflict.  A loop over a thread's
// words runs to its own length; a byte at a run-time position is one
// LDS.U8 / STS.U8.

struct Slots {
    uint32_t* w;   // the thread's word 0

    __device__ __forceinline__ uint32_t& at(int k) const
    {
        return w[k * kThreads];
    }
    // byte p at (p >> 2) * 4 * kThreads + (p & 3) past word 0
    __device__ __forceinline__ uint8_t& byte(int p) const
    {
        return reinterpret_cast<uint8_t*>(w)[p * kThreads
                                             - (p & 3) * (kThreads - 1)];
    }
};

// Bytes [p, n) move down by s to [p, n - s), zeros come in from past n;
// bytes below p stay.  Funnel shifts, ascending, a word read once.
template <int NW>
__device__ __forceinline__ void shift_down(Slots W, int p, int s, int n)
{
    const int a = s >> 2, b = 8 * (s & 3), k0 = p >> 2;
    const uint32_t keep = below(k0, p);
    const uint32_t old0 = W.at(k0);
    uint32_t lo = k0 + a < NW ? W.at(k0 + a) : 0u;
    for (int k = k0; k <= (n - 1) >> 2; ++k) {
        const uint32_t hi = k + a + 1 < NW ? W.at(k + a + 1) : 0u;
        uint32_t v = __funnelshift_r(lo, hi, b);
        if (k == k0) v = (old0 & keep) | (v & ~keep);
        W.at(k) = v;
        lo = hi;
    }
}

// Bytes [p, n) move up by s to [p + s, n + s), zeros at [p, p + s);
// bytes below p stay.  Funnel shifts, descending, a word read once; the
// caller has checked n + s against max_len.
__device__ __forceinline__ void shift_up(Slots W, int p, int s, int n)
{
    const int a = s >> 2, b = 8 * (s & 3), k0 = p >> 2;
    // the bytes from p on of word j, zero below word k0
    const auto src = [&](int j) {
        return j >= k0 ? W.at(j) & ~below(j, p) : 0u;
    };
    const int top = (n + s - 1) >> 2;
    uint32_t hi = src(top - a);
    for (int k = top; k >= k0; --k) {
        const uint32_t lo = src(k - a - 1);
        uint32_t v = __funnelshift_l(lo, hi, b);
        if (k == k0) v |= W.at(k0) & below(k0, p);
        W.at(k) = v;
        hi = lo;
    }
}

// Bytes [p, n) become zero.
__device__ __forceinline__ void cut(Slots W, int p, int n)
{
    for (int k = p >> 2; k <= (n - 1) >> 2; ++k) W.at(k) &= below(k, p);
}

// Bytes [d, d + len) |= bytes [0, len), which sit below d: a copy of the
// front behind it (the bytes at d on are zero)
__device__ __forceinline__ void or_front(Slots W, int len, int d)
{
    const int a = d >> 2, b = 8 * (d & 3);
    const auto src = [&](int j) {
        return j >= 0 ? W.at(j) & below(j, len) : 0u;
    };
    for (int k = (d + len - 1) >> 2; k >= a; --k)
        W.at(k) |= __funnelshift_l(src(k - a - 1), src(k - a), b);
}

// ---- the ops ------------------------------------------------------------
//
// Apply one op to the n bytes of W in place; false = the candidate is
// rejected.  Every byte at or past n stays zero.  Growth past max_len
// rejects before anything is written, so no byte past max_len
// (< 4 * NW) is ever set.

template <int NW>
__device__ __forceinline__ bool apply_op(int op, int p1, int p2, Slots W,
                                         int& n, int max_len)
{
    const int kn = (n + 3) >> 2;   // the words that hold the n bytes
    switch (op) {
    case OP_NOOP:
        break;
    case OP_LOWER:
        for (int k = 0; k < kn; ++k) W.at(k) = swar_lower(W.at(k));
        break;
    case OP_UPPER:
        for (int k = 0; k < kn; ++k) W.at(k) = swar_upper(W.at(k));
        break;
    case OP_TOGGLE_ALL:
        for (int k = 0; k < kn; ++k) W.at(k) = swar_toggle(W.at(k));
        break;
    case OP_CAPITALIZE:
    case OP_INV_CAPITALIZE:
        for (int k = 0; k < kn; ++k) {
            const uint32_t x = W.at(k), lo = swar_lower(x),
                           up = swar_upper(x);
            const uint32_t rest = op == OP_CAPITALIZE ? lo : up;
            const uint32_t first = op == OP_CAPITALIZE ? up : lo;
            W.at(k) = k ? rest : (rest & 0xffffff00u) | (first & 0xffu);
        }
        break;
    case OP_TOGGLE_AT:
        if (p1 < n) W.byte(p1) = (uint8_t)swar_toggle(W.byte(p1));
        break;
    case OP_REVERSE:
        for (int i = 0, j = n - 1; i < j; ++i, --j) {
            const uint8_t t = W.byte(i);
            W.byte(i) = W.byte(j);
            W.byte(j) = t;
        }
        break;
    case OP_DUPLICATE:
        if (2 * n > max_len) return false;
        or_front(W, n, n);
        n *= 2;
        break;
    case OP_DUPLICATE_N:
        if (n * (p1 + 1) > max_len) return false;
        for (int i = 1; i <= p1 && n > 0; ++i) or_front(W, n, i * n);
        n *= p1 + 1;
        break;
    case OP_REFLECT:
        if (2 * n > max_len) return false;
        for (int i = 0; i < n; ++i) W.byte(n + i) = W.byte(n - 1 - i);
        n *= 2;
        break;
    case OP_ROT_LEFT:
        if (n > 1) {
            const uint8_t c = W.byte(0);
            shift_down<NW>(W, 0, 1, n);
            W.byte(n - 1) = c;
        }
        break;
    case OP_ROT_RIGHT:
        if (n > 1) {
            const uint8_t c = W.byte(n - 1);
            W.byte(n - 1) = 0;
            shift_up(W, 0, 1, n - 1);
            W.byte(0) = c;
        }
        break;
    case OP_DEL_FIRST:
        if (n > 0) {
            shift_down<NW>(W, 0, 1, n);
            n -= 1;
        }
        break;
    case OP_DEL_LAST:
        if (n > 0) {
            n -= 1;
            W.byte(n) = 0;
        }
        break;
    case OP_DEL_AT:
    case OP_OMIT:
        // bytes from p1 on move down by 1 (D) or p2 (O); what comes in
        // from past n is zero, so an O past the end is a cut at p1
        if (p1 < n) {
            const int k = op == OP_DEL_AT ? 1 : p2;
            shift_down<NW>(W, p1, k, n);
            n -= min(k, n - p1);
        }
        break;
    case OP_EXTRACT:
        if (p1 < n) {
            shift_down<NW>(W, 0, p1, n);
            n -= p1;
            if (p2 < n) {
                cut(W, p2, n);
                n = p2;
            }
        }
        break;
    case OP_INSERT:
        if (p1 <= n) {
            if (n + 1 > max_len) return false;
            shift_up(W, p1, 1, n);
            W.byte(p1) = (uint8_t)p2;
            n += 1;
        }
        break;
    case OP_OVERWRITE:
        if (p1 < n) W.byte(p1) = (uint8_t)p2;
        break;
    case OP_TRUNCATE:
        if (p1 < n) {
            cut(W, p1, n);
            n = p1;
        }
        break;
    case OP_SUBSTITUTE:
        for (int k = 0; k < kn; ++k) {
            const uint32_t x = W.at(k);
            uint32_t m = eq_mask(x, (uint32_t)p1);
            if (p1 == 0) m &= below(k, n);   // the zeros past n stay
            W.at(k) = (x & ~m) | ((uint32_t)p2 * 0x01010101u & m);
        }
        break;
    case OP_DUP_FIRST:
        if (n > 0) {
            if (n + p1 > max_len) return false;
            const uint32_t c = W.byte(0) * 0x01010101u;
            shift_up(W, 0, p1, n);
            for (int k = 0; k < (p1 + 3) >> 2; ++k) W.at(k) |= c & below(k, p1);
            n += p1;
        }
        break;
    case OP_DUP_LAST:
        if (n > 0) {
            if (n + p1 > max_len) return false;
            const uint32_t c = W.byte(n - 1) * 0x01010101u;
            for (int k = n >> 2; k <= (n + p1 - 1) >> 2; ++k)
                W.at(k) |= c & below(k, n + p1) & ~below(k, n);
            n += p1;
        }
        break;
    case OP_DUP_ALL:
        if (2 * n > max_len) return false;
        for (int i = n - 1; i >= 0; --i) {
            const uint8_t c = W.byte(i);
            W.byte(2 * i + 1) = c;
            W.byte(2 * i) = c;
        }
        n *= 2;
        break;
    case OP_SWAP_FRONT:
        if (n >= 2) W.at(0) = __byte_perm(W.at(0), 0, 0x3201);
        break;
    case OP_SWAP_BACK:
    case OP_SWAP_AT: {
        const int i = op == OP_SWAP_BACK ? n - 1 : p1;
        const int j = op == OP_SWAP_BACK ? n - 2 : p2;
        if (op == OP_SWAP_BACK ? n >= 2 : (p1 < n && p2 < n)) {
            const uint8_t t = W.byte(i);
            W.byte(i) = W.byte(j);
            W.byte(j) = t;
        }
        break;
    }
    case OP_SHIFT_LEFT:
        if (p1 < n) W.byte(p1) = (uint8_t)(W.byte(p1) << 1);
        break;
    case OP_SHIFT_RIGHT:
        if (p1 < n) W.byte(p1) = W.byte(p1) >> 1;
        break;
    case OP_INCR_AT:
        if (p1 < n) W.byte(p1) = (uint8_t)(W.byte(p1) + 1);
        break;
    case OP_DECR_AT:
        if (p1 < n) W.byte(p1) = (uint8_t)(W.byte(p1) - 1);
        break;
    case OP_REPL_NEXT:
        if (p1 + 1 < n) W.byte(p1) = W.byte(p1 + 1);
        break;
    case OP_REPL_PREV:
        if (p1 >= 1 && p1 < n) W.byte(p1) = W.byte(p1 - 1);
        break;
    case OP_DUP_BLOCK_FRONT:
        // the bytes move up by p1, descending; [0, p1) keeps its copy
        if (p1 <= n) {
            if (n + p1 > max_len) return false;
            for (int i = n - 1; i >= 0; --i) W.byte(i + p1) = W.byte(i);
            n += p1;
        }
        break;
    case OP_DUP_BLOCK_BACK:
        if (p1 <= n) {
            if (n + p1 > max_len) return false;
            for (int i = 0; i < p1; ++i) W.byte(n + i) = W.byte(n - p1 + i);
            n += p1;
        }
        break;
    case OP_APPEND:
        if (n + 1 > max_len) return false;
        W.byte(n) = (uint8_t)p1;
        n += 1;
        break;
    case OP_PREPEND:
        if (n + 1 > max_len) return false;
        shift_up(W, 0, 1, n);
        W.byte(0) = (uint8_t)p1;
        n += 1;
        break;
    case OP_REJ_GT:
        return n <= p1;
    case OP_REJ_LT:
        return n >= p1;
    case OP_REJ_NEQ_LEN:
        return n == p1;
    case OP_REJ_CONTAIN:
    case OP_REJ_NOT_CONTAIN:
    case OP_REJ_LT_COUNT: {
        // bytes equal to c in the kn words, less the zeros past n for
        // c = 0
        const uint32_t c = op == OP_REJ_LT_COUNT ? p2 : p1;
        int cnt = c ? 0 : n - 4 * kn;
        for (int k = 0; k < kn; ++k)
            cnt += __popc(zero_bytes(W.at(k) ^ (c * 0x01010101u)));
        return op == OP_REJ_CONTAIN ? cnt == 0
               : op == OP_REJ_NOT_CONTAIN ? cnt > 0 : cnt >= p1;
    }
    case OP_REJ_NOT_FIRST:
        return n > 0 && W.byte(0) == p1;
    case OP_REJ_NOT_LAST:
        return n > 0 && W.byte(n - 1) == p1;
    case OP_REJ_NOT_AT:
        return p1 < n && W.byte(p1) == p2;
    default:
        // PURGE, TITLE, TITLE_SEP: ops/cuda_rules refuses such jobs
        return false;
    }
    return true;
}

// ---- the kernel ---------------------------------------------------------

// rules a thread runs at most (ops/cuda_rules.MAX_RUN): the block's run
// of bytecode is staged in shared memory
constexpr int kMaxRun = 64;
// a candidate shorter than 4 * kShortWords bytes (its marker included)
// fits in the first kShortWords words
constexpr int kShortWords = 4;

// The message block of a candidate of n bytes whose words past the first
// L are zero (every byte past n zero, the 0x80 marker at n): with L a
// constant, the core folds the zero words away.  BlockWords<Core> words
// (16, SHA-512's 32, a sponge's rate / 4), the bit length in the core's
// kLenWord.  A sponge's (Sponge<Core>) marker is the pad byte `pad` while
// its slot is read (written there and put back, so that no message word
// is chosen at run time: a register array indexed by n would go to local
// memory), and 0x80 goes into the rate's last byte (one byte, 0x86 or
// 0x81, at n = rate - 1).
template <class Core, int L>
__device__ __forceinline__ void pack(Slots W, int n, uint32_t* m,
                                     uint32_t pad = 0)
{
    constexpr int kBlock = BlockWords<Core>::value;
    if constexpr (Sponge<Core>::value) W.byte(n) = (uint8_t)pad;
#pragma unroll
    for (int k = 0; k < kBlock; ++k) m[k] = 0;
#pragma unroll
    for (int k = 0; k < L; ++k) {
        const uint32_t x = W.at(k);
        if constexpr (Core::kBitsPerChar == 16) {
            // UTF-16LE: byte q to message byte 2q
            m[2 * k] = __byte_perm(x, 0, 0x4140);
            m[2 * k + 1] = __byte_perm(x, 0, 0x4342);
        } else if constexpr (Core::shift(1) == 8) {
            m[k] = x;
        } else {
            m[k] = __byte_perm(x, 0, 0x0123);
        }
    }
    if constexpr (Sponge<Core>::value) {
        W.byte(n) = (uint8_t)0x80u;     // the marker back
        m[kBlock - 1] |= 0x80000000u;
    } else {
        m[Core::kLenWord] = (uint32_t)n * Core::kBitsPerChar;
    }
}

// The digest of a candidate of n bytes whose words past the first L are
// zero (a list's compare needs every word).
template <class Core, int L>
__device__ __forceinline__ void digest_of(Slots W, int n, uint32_t* dg,
                                          uint32_t pad = 0)
{
    uint32_t m[BlockWords<Core>::value];
    pack<Core, L>(W, n, m, pad);
    Core::digest(m, dg);
}

template <class Core, int L>
__device__ __forceinline__ bool matches(Slots W, int n, const uint32_t* want,
                                        uint32_t pad = 0)
{
    uint32_t m[BlockWords<Core>::value], dg[Core::kWords];
    pack<Core, L>(W, n, m, pad);
    Core::digest(m, dg);
    // word 0 first: the rounds that only the other words need (md5's
    // and md4's last three) sink into the rare branch
    if (dg[0] != want[0]) return false;
    bool hit = true;
#pragma unroll
    for (int k = 1; k < Core::kWords; ++k) hit &= dg[k] == want[k];
    return hit;
}

// Dynamic shared memory of one block: each thread's working and
// original words, then the run's op counts and ops (opcode, p1, p2 as
// bytes); a tail keeps its own after them (kProbe: the list's bitmap).
template <class Core>
__host__ __device__ constexpr int shared_bytes()
{
    return 4 * (2 * ((Core::kMaxLen + 4) / 4) * kThreads + kMaxRun)
           + 3 * kMaxRun * DPRF_RULE_STEPS;
}


// the words a thread's slots hold: the candidate's bytes 0..kMaxLen (the
// marker's last place)
template <class Core>
__host__ __device__ constexpr int slot_words()
{
    return (Core::kMaxLen + 4) / 4;
}

// ---- the run of rules ---------------------------------------------------
//
// rules_body is the kernel but for what becomes of a candidate that its
// rule keeps, which a tail does (the compare with one target or a list
// below; a group's salted targets or Kerberos tickets in
// csrc/rules_group.cu):
//
// - tail.stage(extra): what the tail keeps in shared memory after the
//   run's ops, at `extra` (16-byte aligned), staged before the block's
//   barrier;
// - tail.take(W, n, lane): a candidate its rule kept, its n bytes in W
//   with the 0x80 marker at n and every byte past it zero, and its hit
//   lane r * word_batch + b.

template <class Core, class Tail>
__device__ __forceinline__ void rules_body(const uint8_t* __restrict__ words,
                                           const int32_t* __restrict__ lens,
                                           const int32_t* __restrict__ bytecode,
                                           const int32_t* __restrict__ n_ops,
                                           const RulesArgs& args, Tail& tail)
{
    constexpr int NW = slot_words<Core>();
    constexpr int kOps = kMaxRun * DPRF_RULE_STEPS;
    extern __shared__ uint32_t smem[];
    const Slots W{smem + threadIdx.x};
    const Slots O{W.w + NW * kThreads};
    int32_t* const steps = reinterpret_cast<int32_t*>(smem
                                                      + 2 * NW * kThreads);
    uint8_t* const code = reinterpret_cast<uint8_t*>(steps + kMaxRun);

    // the block: word block x of the window under rule run j
    const int blocks_x = (args.n_valid + kThreads - 1) / kThreads;
    const int j = blockIdx.x / blocks_x;
    const int b = (blockIdx.x - j * blocks_x) * kThreads + threadIdx.x;
    const int r0 = j * args.run;
    const int nr = min(args.run, args.n_rules - r0);

    // the run's ops: opcode at code[i], p1 at code[kOps + i], p2 at
    // code[2 * kOps + i], i = rule * 8 + step
    for (int i = threadIdx.x; i < 3 * nr * DPRF_RULE_STEPS; i += kThreads)
        code[i % 3 * kOps + i / 3] =
            (uint8_t)bytecode[(size_t)r0 * (DPRF_RULE_STEPS * 3) + i];
    for (int i = threadIdx.x; i < nr; i += kThreads) steps[i] = n_ops[r0 + i];
    tail.stage(reinterpret_cast<uint32_t*>(code + 3 * kOps));
    __syncthreads();
    if ((b & ~31) >= args.n_valid) return;      // a warp past the window
    const bool live = b < args.n_valid;

    // the word, once: 16-byte loads of its padded row, masked at its
    // length, into both slot arrays
    int n0 = 0;
    {
        uint32_t o[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) o[k] = 0;
        if (live) {
            const size_t word = (size_t)args.ws + b;
            const int row = (args.max_len + 15) & ~15;
            const uint4* p = reinterpret_cast<const uint4*>(words + word * row);
            n0 = min(lens[word], args.max_len);
#pragma unroll
            for (int c = 0; c < (NW + 3) / 4; ++c) {
                if (16 * c < row) {
                    const uint4 q = __ldg(p + c);
                    const uint32_t e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        if (4 * c + i < NW) o[4 * c + i] = e[i];
                }
            }
        }
#pragma unroll
        for (int k = 0; k < NW; ++k) {
            const uint32_t x = o[k] & below(k, n0);
            W.at(k) = x;
            O.at(k) = x;
        }
    }

    int n = n0;   // the last rule's length: W is O but for [0, n]
    for (int rr = 0; rr < nr; ++rr) {
        // back to the word: the words that the last rule may have set,
        // its marker's included
#pragma unroll
        for (int k = 0; k < kShortWords; ++k) W.at(k) = O.at(k);
        for (int k = kShortWords; k <= max(n, n0) >> 2; ++k)
            W.at(k) = O.at(k);
        n = n0;
        bool valid = live;
        const uint8_t* c = code + rr * DPRF_RULE_STEPS;
        for (const uint8_t* end = c + steps[rr]; valid && c < end; ++c) {
            const int op = c[0], p1 = c[kOps];
            // `$` and `]`, best64's commonest ops, before the switch
            if (op == OP_APPEND) {
                valid = n < args.max_len;
                if (valid) W.byte(n++) = (uint8_t)p1;
            } else if (op == OP_DEL_LAST) {
                if (n > 0) W.byte(--n) = 0;
            } else {
                valid = apply_op<NW>(op, p1, c[2 * kOps], W, n,
                                     args.max_len);
            }
        }
        if (!valid) continue;

        W.byte(n) = 0x80;
        tail.take(W, n, (int32_t)((r0 + rr) * args.word_batch + b));
    }
}

// ---- one target or a list -----------------------------------------------

// The target's digest words and a sponge's pad byte of a launch's
// parameters: RulesArgs holds 8 target words and no pad; a wider core's
// parameters (csrc/rules_wide.cu) overload these.
__device__ __forceinline__ const uint32_t* target_of(const RulesArgs& a)
{
    return a.target;
}

__device__ __forceinline__ uint32_t pad_of(const RulesArgs&) { return 0u; }

template <class Core, Compare kMode, class Args = RulesArgs>
struct CompareTail {
    static constexpr int NW = slot_words<Core>();
    const Args& args;
    const MultiArgs& multi;
    int32_t* const count;
    int32_t* const lanes;
    const int32_t cap;
    int32_t* const tpos;
    int32_t* const n_maybe;
    const uint32_t* s_probe;

    __device__ __forceinline__ void stage(uint32_t* extra)
    {
        s_probe = extra;
        if constexpr (kMode == kProbe) {
            const int n_probe = DPRF_PROBE_BLOCK_WORDS << multi.block_bits;
            for (int i = threadIdx.x; i < n_probe; i += kThreads)
                extra[i] = multi.bloom[i];
        }
    }

    __device__ __forceinline__ void take(Slots W, int n, int32_t lane)
    {
        if constexpr (kMode == kSingle) {
            // a warp whose candidates all fit in kShortWords words hashes
            // them with the other words constant zero
            const bool hit =
                __all_sync(__activemask(), n < 4 * kShortWords)
                    ? matches<Core, kShortWords>(W, n, target_of(args),
                                                 pad_of(args))
                    : matches<Core, NW>(W, n, target_of(args), pad_of(args));
            if (hit) {
                const int32_t slot = atomicAdd(count, 1);
                if (slot < cap) lanes[slot] = lane;
            }
        } else {
            uint32_t dg[Core::kWords];
            if (__all_sync(__activemask(), n < 4 * kShortWords))
                digest_of<Core, kShortWords>(W, n, dg, pad_of(args));
            else
                digest_of<Core, NW>(W, n, dg, pad_of(args));
            const bool maybe =
                kMode == kProbe
                    ? probe_maybe<Core::kWords>(dg, s_probe, multi.block_bits,
                                                multi.k)
                    : probe_maybe<Core::kWords, true>(dg, multi.bloom,
                                                      multi.block_bits,
                                                      multi.k);
            if (maybe) {
                atomicAdd(n_maybe, 1);
                int pos;
                if (bulk_verify<Core::kWords>(dg, multi, &pos)) {
                    const int32_t slot = atomicAdd(count, 1);
                    if (slot < cap) {
                        lanes[slot] = lane;
                        tpos[slot] = pos;
                    }
                }
            }
        }
    }
};

// A list's parameters come after the one-target kernel's, which a
// kSingle instantiation leaves unread.
template <class Core, Compare kMode = kSingle>
__global__ void __launch_bounds__(kThreads)
rules_kernel(const uint8_t* __restrict__ words,
             const int32_t* __restrict__ lens,
             const int32_t* __restrict__ bytecode,
             const int32_t* __restrict__ n_ops, const RulesArgs args,
             int32_t* __restrict__ count, int32_t* __restrict__ lanes,
             int32_t cap, const MultiArgs multi, int32_t* __restrict__ tpos,
             int32_t* __restrict__ n_maybe)
{
    CompareTail<Core, kMode> tail{args,  multi, count,   lanes,
                                  cap,   tpos,  n_maybe, nullptr};
    rules_body<Core>(words, lens, bytecode, n_ops, args, tail);
}

// ---- launching -----------------------------------------------------------

// A kernel's dynamic shared memory limit, raised to smem past the 48 KB
// a launch gets without asking (a kProbe bitmap of 64 KiB, a group's
// rows).
template <class F>
static cudaError_t allow_shared(F* kernel, size_t smem)
{
    if (smem > 48 * 1024)
        return cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return cudaSuccess;
}

template <class Core, Compare kMode>
static int launch(const uint8_t* words, const int32_t* lens,
                  const int32_t* bytecode, const int32_t* n_ops,
                  const RulesArgs* args, const MultiArgs* multi,
                  int32_t* count, int32_t* lanes, int32_t* tpos,
                  int32_t* n_maybe, int32_t cap, int grid, size_t smem,
                  cudaStream_t stream)
{
    const cudaError_t err = allow_shared(rules_kernel<Core, kMode>, smem);
    if (err != cudaSuccess) return (int)err;
    rules_kernel<Core, kMode><<<grid, kThreads, smem, stream>>>(
        words, lens, bytecode, n_ops, *args, count, lanes, cap, *multi, tpos,
        n_maybe);
    return (int)cudaGetLastError();
}

template <class F>
static int occupancy(F* kernel, size_t smem, int* blocks)
{
    const cudaError_t err = allow_shared(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kThreads, smem);
}

template <class Core, Compare>
static int smem_of(int* bytes)
{
    *bytes = shared_bytes<Core>();
    return 0;
}

// ---- a group of targets ---------------------------------------------------
//
// The kernel over a tail that hashes each kept candidate with every target
// of a group (csrc/rules_group.cu, csrc/rules_wide.cu); its C interface is
// csrc/rules_group_entry.cuh.

// A group launch's parameters (mirrored by ops/cuda_rules._GroupArgs).
struct GroupArgs {
    const uint32_t* rows;     // n_targets rows in device memory
    int32_t* count;           // hits, the first `cap` of them in
    int32_t* lanes;           // (lanes, tpos); tcount per target
    int32_t* tpos;
    int32_t* tcount;
    int32_t n_targets;
    int32_t shift;            // "sp": the group's salt length
    uint32_t msg_type;        // Kerberos: the group's msg_type
    int32_t upper;            // MSSQL 2000: uppercase the candidate
    int32_t cap;
};

__device__ __forceinline__ void append_hit(const GroupArgs& g, int t,
                                           int32_t lane)
{
    atomicAdd(g.tcount + t, 1);
    const int32_t slot = atomicAdd(g.count, 1);
    if (slot < g.cap) {
        g.lanes[slot] = lane;
        g.tpos[slot] = t;
    }
}

template <class Core, class Tail>
__global__ void __launch_bounds__(kThreads)
rules_group_kernel(const uint8_t* __restrict__ words,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ bytecode,
                   const int32_t* __restrict__ n_ops, const RulesArgs args,
                   const GroupArgs group)
{
    Tail tail{group};
    rules_body<Core>(words, lens, bytecode, n_ops, args, tail);
}

template <class Core, class Tail>
static int group_launch(const uint8_t* words, const int32_t* lens,
                        const int32_t* bytecode, const int32_t* n_ops,
                        const RulesArgs* args, const GroupArgs* group,
                        int grid, size_t smem, cudaStream_t stream)
{
    if (group->n_targets > Tail::kGroup) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_shared(rules_group_kernel<Core, Tail>,
                                         smem);
    if (err != cudaSuccess) return (int)err;
    rules_group_kernel<Core, Tail><<<grid, kThreads, smem, stream>>>(
        words, lens, bytecode, n_ops, *args, *group);
    return (int)cudaGetLastError();
}

// Dynamic shared memory of one block: the slots and ops, then the
// tail's own -- the RC4 states (Kerberos) and the group's rows.
template <class Core, class Tail>
static int group_smem_of(int n_targets, int* bytes)
{
    *bytes = shared_bytes<Core>() + Tail::kFixedBytes
             + 4 * Tail::kRow * n_targets;
    return 0;
}
