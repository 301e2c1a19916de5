// rules.cu -- the fused wordlist+rules kernel for Hopper (sm_90a): rule
// interpreter -> varlen pack -> hash -> compare, one target.
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_rules.py
// (make_rules_pallas_fn, its rule VM _interp_step and
// _pack_varlen_words) for the md5, md4 (ntlm), sha1 and sha256 cores.
// Per candidate (word b of the window, rule r): load the word, apply the
// rule's ops with the semantics of rules/cpu.py (growth past max_len and
// the rejection ops reject; a position past the end makes an op a
// no-op), place the bytes, the 0x80 marker and the bit length in one
// block (little-endian for md5/md4, big-endian for SHA, UTF-16LE widened
// for ntlm), run the core of cores.cuh and compare all digest words with
// the target.  A rejected lane, or one past the window's valid words, is
// never compared.
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
// What bounds it: issue slots, as in the mask kernel -- the core's
// rounds (~1,000 slots per sha256 candidate, ops/opcount.py) -- plus the
// interpreter's byte moves and the reads of the word table, which every
// one of a word's rules reads again (B * max_len bytes per rule).
//
// What the design does about it: one thread per candidate, rule-major,
// with B a multiple of 32, so the 32 threads of a warp share one rule:
// the op dispatch is warp-uniform, the bytecode loads broadcast, and a
// warp runs only its own rule's op count (this replaces the TPU's
// bucketing).  A thread's bytes live in shared memory, position-major
// (byte p of thread t at p * 256 + t): run-time positions need an
// indexed array, which in registers would go to local memory; here a
// warp touches 32 neighbouring bytes at one position.  Every op edits
// the bytes in place, so one buffer of max_len bytes a thread suffices
// (14,080 bytes a block at max_len 55).  The word table stays on the card
// for the whole job; a launch takes the window's first word and its
// count, so no padding is needed and nothing past the table is read.
// The launch's lanes cover the window's valid words only (rounded up to
// 32), so a short last window idles no warps.

#include <cstdint>
#include <cuda_runtime.h>

#include "cores.cuh"

#define DPRF_RULE_STEPS 8

// threads per block; the byte buffers' stride
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
    int32_t max_len;     // the word table's row width and the growth limit
    int32_t n_rules;
    int32_t word_batch;  // B, the hit lanes' stride between rules
    int32_t ws;          // the window's first word
    int32_t n_valid;     // the window's words, <= B
    uint32_t target[8];  // the target's digest words
};

// One thread's candidate bytes: byte p at s[p * kThreads].
struct Word {
    uint8_t* s;
    __device__ __forceinline__ uint8_t& operator[](int p) const
    {
        return s[p * kThreads];
    }
};

__device__ __forceinline__ uint8_t to_lower(uint8_t b)
{
    return (uint32_t)(b - 0x41) < 26u ? b + 0x20 : b;
}

__device__ __forceinline__ uint8_t to_upper(uint8_t b)
{
    return (uint32_t)(b - 0x61) < 26u ? b - 0x20 : b;
}

__device__ __forceinline__ uint8_t toggle(uint8_t b)
{
    return (uint32_t)((b | 0x20) - 0x61) < 26u ? b ^ 0x20 : b;
}

__device__ __forceinline__ void swap_at(Word w, int i, int j)
{
    const uint8_t t = w[i];
    w[i] = w[j];
    w[j] = t;
}

// w[at .. n-k) = w[at+k .. n): delete k bytes at `at`.
__device__ __forceinline__ void shift_down(Word w, int at, int k, int n)
{
    for (int p = at; p + k < n; ++p) w[p] = w[p + k];
}

// w[at+k .. n+k) = w[at .. n): open k bytes at `at`.
__device__ __forceinline__ void shift_up(Word w, int at, int k, int n)
{
    for (int p = n - 1; p >= at; --p) w[p + k] = w[p];
}

__device__ __forceinline__ int count_of(Word w, int n, int ch)
{
    int c = 0;
    for (int p = 0; p < n; ++p) c += w[p] == ch;
    return c;
}

// Apply one op to the n bytes of w in place; false = the candidate is
// rejected.  Growth past max_len rejects before anything is written, so
// no write reaches past max_len.
__device__ bool apply_op(int op, int p1, int p2, Word w, int& n,
                         int max_len)
{
    switch (op) {
    case OP_NOOP:
        break;
    case OP_LOWER:
        for (int p = 0; p < n; ++p) w[p] = to_lower(w[p]);
        break;
    case OP_UPPER:
        for (int p = 0; p < n; ++p) w[p] = to_upper(w[p]);
        break;
    case OP_CAPITALIZE:
        for (int p = 0; p < n; ++p)
            w[p] = p ? to_lower(w[p]) : to_upper(w[p]);
        break;
    case OP_INV_CAPITALIZE:
        for (int p = 0; p < n; ++p)
            w[p] = p ? to_upper(w[p]) : to_lower(w[p]);
        break;
    case OP_TOGGLE_ALL:
        for (int p = 0; p < n; ++p) w[p] = toggle(w[p]);
        break;
    case OP_TOGGLE_AT:
        if (p1 < n) w[p1] = toggle(w[p1]);
        break;
    case OP_REVERSE:
        for (int i = 0, j = n - 1; i < j; ++i, --j) swap_at(w, i, j);
        break;
    case OP_DUPLICATE:
        if (2 * n > max_len) return false;
        for (int p = 0; p < n; ++p) w[n + p] = w[p];
        n *= 2;
        break;
    case OP_DUPLICATE_N:
        if (n * (p1 + 1) > max_len) return false;
        for (int k = 1; k <= p1; ++k)
            for (int p = 0; p < n; ++p) w[k * n + p] = w[p];
        n *= p1 + 1;
        break;
    case OP_REFLECT:
        if (2 * n > max_len) return false;
        for (int p = 0; p < n; ++p) w[n + p] = w[n - 1 - p];
        n *= 2;
        break;
    case OP_ROT_LEFT:
        if (n > 1) {
            const uint8_t t = w[0];
            shift_down(w, 0, 1, n);
            w[n - 1] = t;
        }
        break;
    case OP_ROT_RIGHT:
        if (n > 1) {
            const uint8_t t = w[n - 1];
            shift_up(w, 0, 1, n - 1);
            w[0] = t;
        }
        break;
    case OP_DEL_FIRST:
        if (n > 0) {
            shift_down(w, 0, 1, n);
            n -= 1;
        }
        break;
    case OP_DEL_LAST:
        if (n > 0) n -= 1;
        break;
    case OP_DEL_AT:
        if (p1 < n) {
            shift_down(w, p1, 1, n);
            n -= 1;
        }
        break;
    case OP_EXTRACT:
        if (p1 < n) {
            const int k = min(p2, n - p1);
            for (int p = 0; p < k; ++p) w[p] = w[p + p1];
            n = k;
        }
        break;
    case OP_OMIT:
        if (p1 < n) {
            const int k = min(p2, n - p1);
            shift_down(w, p1, k, n);
            n -= k;
        }
        break;
    case OP_INSERT:
        if (p1 <= n) {
            if (n + 1 > max_len) return false;
            shift_up(w, p1, 1, n);
            w[p1] = (uint8_t)p2;
            n += 1;
        }
        break;
    case OP_OVERWRITE:
        if (p1 < n) w[p1] = (uint8_t)p2;
        break;
    case OP_TRUNCATE:
        if (p1 < n) n = p1;
        break;
    case OP_SUBSTITUTE:
        for (int p = 0; p < n; ++p)
            if (w[p] == p1) w[p] = (uint8_t)p2;
        break;
    case OP_DUP_FIRST:
        if (n > 0) {
            if (n + p1 > max_len) return false;
            shift_up(w, 0, p1, n);
            for (int p = 0; p < p1; ++p) w[p] = w[p1];
            n += p1;
        }
        break;
    case OP_DUP_LAST:
        if (n > 0) {
            if (n + p1 > max_len) return false;
            const uint8_t c = w[n - 1];
            for (int k = 0; k < p1; ++k) w[n + k] = c;
            n += p1;
        }
        break;
    case OP_DUP_ALL:
        if (2 * n > max_len) return false;
        for (int i = n - 1; i >= 0; --i) {
            const uint8_t c = w[i];
            w[2 * i + 1] = c;
            w[2 * i] = c;
        }
        n *= 2;
        break;
    case OP_SWAP_FRONT:
        if (n >= 2) swap_at(w, 0, 1);
        break;
    case OP_SWAP_BACK:
        if (n >= 2) swap_at(w, n - 1, n - 2);
        break;
    case OP_SWAP_AT:
        if (p1 < n && p2 < n) swap_at(w, p1, p2);
        break;
    case OP_SHIFT_LEFT:
        if (p1 < n) w[p1] = (uint8_t)(w[p1] << 1);
        break;
    case OP_SHIFT_RIGHT:
        if (p1 < n) w[p1] = w[p1] >> 1;
        break;
    case OP_INCR_AT:
        if (p1 < n) w[p1] = (uint8_t)(w[p1] + 1);
        break;
    case OP_DECR_AT:
        if (p1 < n) w[p1] = (uint8_t)(w[p1] - 1);
        break;
    case OP_REPL_NEXT:
        if (p1 + 1 < n) w[p1] = w[p1 + 1];
        break;
    case OP_REPL_PREV:
        if (p1 >= 1 && p1 < n) w[p1] = w[p1 - 1];
        break;
    case OP_DUP_BLOCK_FRONT:
        if (p1 <= n) {
            if (n + p1 > max_len) return false;
            shift_up(w, 0, p1, n);
            for (int p = 0; p < p1; ++p) w[p] = w[p + p1];
            n += p1;
        }
        break;
    case OP_DUP_BLOCK_BACK:
        if (p1 <= n) {
            if (n + p1 > max_len) return false;
            for (int k = 0; k < p1; ++k) w[n + k] = w[n - p1 + k];
            n += p1;
        }
        break;
    case OP_APPEND:
        if (n + 1 > max_len) return false;
        w[n] = (uint8_t)p1;
        n += 1;
        break;
    case OP_PREPEND:
        if (n + 1 > max_len) return false;
        shift_up(w, 0, 1, n);
        w[0] = (uint8_t)p1;
        n += 1;
        break;
    case OP_REJ_GT:
        return n <= p1;
    case OP_REJ_LT:
        return n >= p1;
    case OP_REJ_NEQ_LEN:
        return n == p1;
    case OP_REJ_CONTAIN:
        return count_of(w, n, p1) == 0;
    case OP_REJ_NOT_CONTAIN:
        return count_of(w, n, p1) > 0;
    case OP_REJ_NOT_FIRST:
        return n > 0 && w[0] == p1;
    case OP_REJ_NOT_LAST:
        return n > 0 && w[n - 1] == p1;
    case OP_REJ_NOT_AT:
        return p1 < n && w[p1] == p2;
    case OP_REJ_LT_COUNT:
        return count_of(w, n, p2) >= p1;
    default:
        // PURGE, TITLE, TITLE_SEP: ops/cuda_rules refuses such jobs
        return false;
    }
    return true;
}

template <class Core>
__global__ void __launch_bounds__(kThreads)
rules_kernel(const uint8_t* __restrict__ words,
             const int32_t* __restrict__ lens,
             const int32_t* __restrict__ bytecode,
             const int32_t* __restrict__ n_ops, const RulesArgs args,
             int32_t* __restrict__ count, int32_t* __restrict__ lanes,
             int32_t cap)
{
    extern __shared__ uint8_t smem[];
    const Word w{smem + threadIdx.x};
    // the launch's lanes: n_rules x bw, bw the valid words rounded up to
    // a warp, so every warp lies inside one rule
    const uint32_t bw = ((uint32_t)args.n_valid + 31u) & ~31u;
    const uint32_t total = (uint32_t)args.n_rules * bw;
    const uint32_t stride = gridDim.x * kThreads;
    for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < total;
         i += stride) {
        const uint32_t r = i / bw;
        const uint32_t b = i - r * bw;
        if (b >= (uint32_t)args.n_valid) continue;

        const size_t word = (size_t)args.ws + b;
        int n = lens[word];
        const uint8_t* row = words + word * (size_t)args.max_len;
        for (int p = 0; p < n; ++p) w[p] = row[p];

        // the rule: warp-uniform loads of its ops
        const int steps = __ldg(n_ops + r);
        const int32_t* code = bytecode + r * (DPRF_RULE_STEPS * 3);
        bool valid = true;
        for (int s = 0; s < steps && valid; ++s)
            valid = apply_op(__ldg(code + 3 * s), __ldg(code + 3 * s + 1),
                             __ldg(code + 3 * s + 2), w, n, args.max_len);
        if (!valid) continue;

        // one block: the bytes, 0x80 at the length, the bit length
        uint32_t m[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) m[k] = 0;
#pragma unroll
        for (int q = 0; q <= Core::kMaxLen; ++q) {
            uint32_t byte = q == n ? 0x80u : 0u;
            if (q < n) byte = w[q];
            m[Core::word(q)] |= byte << Core::shift(q);
        }
        m[Core::kLenWord] = (uint32_t)n * Core::kBitsPerChar;

        uint32_t dg[Core::kWords];
        Core::digest(m, dg);
        bool hit = true;
#pragma unroll
        for (int k = 0; k < Core::kWords; ++k) hit &= dg[k] == args.target[k];
        if (hit) {
            const int32_t slot = atomicAdd(count, 1);
            if (slot < cap)
                lanes[slot] = (int32_t)(r * (uint32_t)args.word_batch + b);
        }
    }
}

// ---- the C interface ---------------------------------------------------

// core ids: 0 md5, 1 md4 (ntlm), 2 sha1, 3 sha256
// (ops/cuda_rules.KERNEL_CORES)
#define DPRF_DISPATCH(CALL)                                               \
    switch (core) {                                                       \
    case 0: return CALL(Md5Core);                                         \
    case 1: return CALL(Md4Core);                                         \
    case 2: return CALL(Sha1Core);                                        \
    case 3: return CALL(Sha256Core);                                      \
    default: return (int)cudaErrorInvalidValue;                           \
    }

template <class Core>
static int launch(const uint8_t* words, const int32_t* lens,
                  const int32_t* bytecode, const int32_t* n_ops,
                  const RulesArgs* args, int32_t* count, int32_t* lanes,
                  int32_t cap, int grid, size_t smem, cudaStream_t stream)
{
    rules_kernel<Core><<<grid, kThreads, smem, stream>>>(
        words, lens, bytecode, n_ops, *args, count, lanes, cap);
    return (int)cudaGetLastError();
}

template <class Core>
static int occupancy(size_t smem, int* blocks)
{
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, rules_kernel<Core>, kThreads, smem);
}

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  count must hold 0 and lanes -1
// on entry (the wrapper allocates them so).  `threads` must be kThreads.
extern "C" int dprf_rules_launch(int core, int device, const uint8_t* words,
                                 const int32_t* lens,
                                 const int32_t* bytecode,
                                 const int32_t* n_ops, const RulesArgs* args,
                                 int32_t* count, int32_t* lanes,
                                 int32_t cap, int grid, int threads,
                                 void* stream)
{
    if (threads != kThreads) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)args->max_len * kThreads;
    const cudaStream_t st = (cudaStream_t)stream;
#define DPRF_LAUNCH(C)                                                    \
    launch<C>(words, lens, bytecode, n_ops, args, count, lanes, cap, grid, \
              smem, st)
    DPRF_DISPATCH(DPRF_LAUNCH)
#undef DPRF_LAUNCH
}

// Resident blocks of kThreads threads per SM for one instantiation at
// `smem` bytes of dynamic shared memory (the grid's size).
extern "C" int dprf_rules_blocks_per_sm(int core, int smem, int* blocks)
{
#define DPRF_OCCUPANCY(C) occupancy<C>((size_t)smem, blocks)
    DPRF_DISPATCH(DPRF_OCCUPANCY)
#undef DPRF_OCCUPANCY
}
