// mask_kernel.cuh -- the fused mask -> hash -> compare kernel template
// the mask-attack sources share (csrc/mask.cu, csrc/ext.cu).
//
// Per candidate: decode the mixed-radix keyspace index into charset
// bytes (decode.cuh), place them in one padded 64-byte block at the
// core's byte positions over the job's fixed message words, run
// Core::digest, compare.  The core is a template type (cores.cuh, and
// the nested and salted cores of csrc/ext.cu), so one body serves every
// digest chain.  The TPU kernel's (8, 128) packed (count << 16) |
// (hit_lane + 1) output and its one-lane-per-tile rule exist only for
// Mosaic and are not carried over: every hit appends its lane.
//
// Multi-target compare (csrc/compare.cuh), one of three prefilters (the
// Compare mode), then an exact verify of each survivor on the card:
// - kSets: the reference's per-set Bloom prefilter, bit for bit
//   (bloom_tables / bloom_found: 8 probes of 12 digest bits per set of
//   1024 targets);
// - kProbe: the reference's blocked probe (targets/probe.bloom_fill /
//   probe_block_found), its bitmap staged in shared memory (at most
//   64 KiB);
// - kBulk: the same probe over a bulk list's bitmap in global memory,
//   any size (the reference's probe table, targets/probe.py
//   build_probe_table / probe_hits), with the host-verify layout's
//   survivors reported at position -1 when the table did not fit.
// The reference leaves every maybe of the sets and the probe to a host
// oracle hash (the probe's survivors sentinel-tagged); at 1,000 targets
// and a batch of 2^24 the sets give ~81 false maybes a launch, so here
// each maybe binary-searches digest word 0 in the sorted target table
// and compares whole digests (compare.cuh find_target).  Only real hits
// are appended, with their table position; n_maybe counts the
// prefilter's survivors.
//
// The window offset (the reference's with_offset): a launch runs the
// window lanes [args.offset, n_valid), decodes each from the base digits
// plus its window lane and appends the window lane, so `inner` launches
// of one step at offsets i * batch fill one window's buffers (the
// atomic append sums across launches) and one build serves every batch
// of a window and every shard.  Each launch gets n_valid =
// min(offset + batch, the window's valid lanes) (ops/superstep.py clips
// it, the wrapper checks it); a plain batch is offset 0.
//
// What bounds it: the INT32 issue rate, not memory.  A candidate reads
// no device memory (charset table and Bloom rows or probe bitmap sit in
// shared memory; base digits, radices, the fixed message words and the
// target are kernel parameters) and writes ~0 bytes; kBulk reads one
// 32-byte sector of its bitmap block, from L2 for a bitmap of up to
// 50 MB (10^7 targets).  ops/opcount.py
// counts the least instructions per candidate in Hopper's forms, by pipe.
//
// What the design does about it: everything in registers, and a thread
// of a 64-byte core takes a run of consecutive window lanes rather than
// one candidate:
//
// - A run lies inside one period of position L - 1, the least
//   significant digit: the lanes whose sum base[L - 1] + lane falls in
//   [j * r, (j + 1) * r) share every other position's digit (the carry
//   j into position L - 2 decides them) and step position L - 1 through
//   r consecutive digits.  A period is cut into ceil(r / DPRF_RUN)
//   runs of ceil(r / chunks) lanes (at most DPRF_RUN), clipped to the
//   launch's lanes [offset, n_valid); a grid-stride loop hands the runs
//   to the threads (ops/cuda_mask.run_count and run_lanes mirror it,
//   and the wrapper sizes the grid so every thread takes the same
//   number of runs).
// - The run's first lane decodes positions L - 2 .. 0 from the carry j
//   once, by reciprocals (decode.cuh, DPRF_DECODE_RCP: no division),
//   into the message words, which stay in registers for the run.
// - Each lane then reads one charset byte, repeats it in the four bytes
//   of a word and ORs it into every word that can hold a candidate byte
//   under a mask the host computed (args.sel: position L - 1's byte in
//   its word, zero elsewhere), one LOP3 a word with the mask a kernel
//   parameter, so no register holds it.  No lane divides; no run
//   wraps, so the lanes of a warp run the same trip count.
// - That OR touches every such word (14 for md5, ntlm and sha1), not
//   the one word position L - 1 lies in: L is a launch parameter and a
//   register array takes only compile-time indices.  A warp-uniform
//   branch into a second copy of the lane loop that ORs words 0-3 alone
//   (L <= 16 for md5) measured 6-15 % faster on md5, ntlm and the probes but
//   3.4 % slower on the ntlm list (config 2's kernel), so it is not
//   taken (PERF.md, slice K2).
// - DPRF_RUN = 32: of runs of at most 8, 16, 32 and 64 lanes, 32
//   measured fastest at ?a^7 (PERF.md, slice K2).
//
// A wide core (below) keeps one candidate a thread in a grid-stride loop
// over the lanes, each decoded in full (DPRF_DECODE): held across a
// run, its 28-36 message words raise its registers past what its
// resident blocks allow (sha512 to 97, two blocks an SM), and the runs
// measured slower there than the full decode.
//
// The rounds are fully unrolled (the SHA schedules as a rolling 16-word
// window), so message words, constants and shift counts are register or
// immediate operands.  The decode enters an unrolled run of positions
// through one warp-uniform switch on the mask length, so only the mask's
// own positions cost instructions; the byte placement of each position
// is a compile-time constant of the core.  The Bloom probes are tested
// in order and stop at the first miss (Hopper can branch; the TPU tested
// all 8), which costs ~1.3 probes per set at config 2's fill.
//
// The widths are properties of the core: kMaxLen positions, kWords
// digest words and kBlockWords message words (16, a 64-byte block,
// unless the core says otherwise).  A core of more than 16 message
// words (SHA-512's 128-byte block, a Keccak rate block of up to 144
// bytes) takes the wide parameter layout, WideMaskArgs: up to 143
// positions, 36 message words and 16 target words.  Its charset table
// (143 * 256 bytes) and the Bloom rows of 8,192 targets (32 KB) pass
// the 48 KB of dynamic shared memory a launch gets without asking, as
// does the probe bitmap of 8,192 targets (64 KB) after any charset
// table, so a wide instantiation, and any launch past 48 KB, raises its
// limit (the function attribute) before the launch and the occupancy
// query.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "compare.cuh"
#include "cores.cuh"
#include "decode.cuh"

#define DPRF_MAX_LEN 55
#define DPRF_WIDE_MAX_LEN 143
#define DPRF_K_PROBES 8
// the most lanes of a thread's run (ops/cuda_mask.RUN)
#define DPRF_RUN 32
// dynamic shared memory a launch gets without the opt-in
#define DPRF_DEFAULT_SHARED (48 * 1024)

// Kernel parameters of one job (mirrored by ops/cuda_mask.MaskArgs).
struct MaskArgs {
    int32_t length;
    int32_t radix[DPRF_MAX_LEN];
    int32_t base[DPRF_MAX_LEN];
    // the decode's reciprocals (decode.cuh, DPRF_DECODE_RCP)
    uint32_t rcp[DPRF_MAX_LEN];
    int32_t rsh[DPRF_MAX_LEN];
    // the job's fixed message words: the 0x80 marker and the bit length,
    // zero wherever a candidate byte goes
    uint32_t block[16];
    // position L - 1's byte in the message words (0xff bits), zero
    // elsewhere
    uint32_t sel[16];
    // the single target's digest words (unused by the multi compare)
    uint32_t target[8];
    // the window lane of the launch's first candidate
    uint32_t offset;
};

// The same for a wide core (mirrored by ops/cuda_mask.WideMaskArgs).
struct WideMaskArgs {
    int32_t length;
    int32_t radix[DPRF_WIDE_MAX_LEN];
    int32_t base[DPRF_WIDE_MAX_LEN];
    uint32_t block[36];
    uint32_t target[16];
    uint32_t offset;
};

// A core past the 64-byte block's 16 message words (BlockWords,
// cores.cuh).
template <class C>
constexpr bool kWideCore = BlockWords<C>::value > 16;

// The message words that can hold a candidate byte: 1 + the word of the
// core's last position.
template <class C>
constexpr int kByteWords = C::word(C::kMaxLen - 1) + 1;

// A core's kernel parameter layout.
template <class C>
using ArgsOf = std::conditional_t<kWideCore<C>, WideMaskArgs, MaskArgs>;

// ---- the multi-target compare ----------------------------------------

// The reference's bloom_found for one lane: all 8 probes of any set.
__device__ __forceinline__ bool bloom_maybe(const uint32_t* dg,
                                            const uint32_t* s_bloom,
                                            int n_sets)
{
    uint32_t bits[DPRF_K_PROBES];
#pragma unroll
    for (int p = 0; p < DPRF_K_PROBES; ++p) {
        const int j = (12 * p) >> 5, sh = (12 * p) & 31;
        uint32_t v = dg[j] >> sh;
        if (sh > 20) v |= dg[j + 1] << (32 - sh);
        bits[p] = v & 0xfffu;
    }
    for (int s = 0; s < n_sets; ++s) {
        const uint32_t* rows = s_bloom + s * DPRF_K_PROBES * 128;
        bool pass = true;
#pragma unroll
        for (int p = 0; p < DPRF_K_PROBES; ++p) {
            if (!((rows[p * 128 + (bits[p] >> 5)] >> (bits[p] & 31)) & 1u)) {
                pass = false;
                break;
            }
        }
        if (pass) return true;
    }
    return false;
}

// The prefilter of a multi-target mode.
template <Compare kMode, int W>
__device__ __forceinline__ bool prefilter(const uint32_t* dg,
                                          const uint32_t* s_filter,
                                          const MultiArgs& multi)
{
    if constexpr (kMode == kProbe)
        return probe_maybe<W>(dg, s_filter, multi.block_bits, multi.k);
    else if constexpr (kMode == kBulk)
        return probe_maybe<W, true>(dg, multi.bloom, multi.block_bits,
                                    multi.k);
    else
        return bloom_maybe(dg, s_filter, multi.n_sets);
}

// ---- the kernel --------------------------------------------------------

template <class Core, Compare kMode>
__global__ void __launch_bounds__(256, MinBlocks<Core>::value)
mask_kernel(const uint8_t* __restrict__ lut, const ArgsOf<Core> args,
            const MultiArgs multi, uint32_t n_valid,
            int32_t* __restrict__ count, int32_t* __restrict__ lanes,
            int32_t* __restrict__ tpos, int32_t* __restrict__ n_maybe,
            int32_t cap)
{
    constexpr int kBlock = BlockWords<Core>::value;
    // per-position 256-byte charset tables, uint8[length][256], then
    // (multi) the prefilter's words; length * 256 keeps them
    // word-aligned
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* s_lut = smem;
    const int L = args.length;
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    uint32_t* s_bloom = reinterpret_cast<uint32_t*>(smem + L * 256);
    if constexpr (kMode == kSets || kMode == kProbe) {
        const int n = kMode == kSets
                          ? multi.n_sets * DPRF_K_PROBES * 128
                          : DPRF_PROBE_BLOCK_WORDS << multi.block_bits;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            s_bloom[i] = multi.bloom[i];
    }
    __syncthreads();

    // the digest of message words w, its compare and its hit append
    auto hash_lane = [&](uint32_t* w, uint32_t gidx) {
        uint32_t dg[Core::kWords];
        Core::digest(w, dg);
        if constexpr (kMode == kSingle) {
            bool hit = true;
#pragma unroll
            for (int i = 0; i < Core::kWords; ++i)
                hit &= dg[i] == args.target[i];
            if (hit) {
                const int32_t slot = atomicAdd(count, 1);
                if (slot < cap) lanes[slot] = (int32_t)gidx;
            }
        } else if (prefilter<kMode, Core::kWords>(dg, s_bloom, multi)) {
            atomicAdd(n_maybe, 1);
            if constexpr (kMode == kBulk) {
                int pos;
                if (bulk_verify<Core::kWords>(dg, multi, &pos)) {
                    const int32_t slot = atomicAdd(count, 1);
                    if (slot < cap) {
                        lanes[slot] = (int32_t)gidx;
                        tpos[slot] = pos;
                    }
                }
            } else {
                const int pos = find_target<Core::kWords>(dg, multi.table,
                                                          multi.n_targets);
                if (pos >= 0) {
                    const int32_t slot = atomicAdd(count, 1);
                    if (slot < cap) {
                        lanes[slot] = (int32_t)gidx;
                        tpos[slot] = pos;
                    }
                }
            }
        }
    };
    const uint32_t stride = gridDim.x * blockDim.x;

    if constexpr (kWideCore<Core>) {
        for (uint32_t gidx = args.offset + blockIdx.x * blockDim.x
                             + threadIdx.x;
             gidx < n_valid; gidx += stride) {
            uint32_t m[kBlock];
#pragma unroll
            for (int i = 0; i < kBlock; ++i) m[i] = args.block[i];
            // decode, last (least significant) position first
            uint32_t carry = gidx;
            DPRF_DECODE(Core, Core::kMaxLen, L);
            hash_lane(m, gidx);
        }
        return;
    } else {
        // position L - 1 steps inside a run (the notes above); the sums
        // base[L - 1] + lane of the launch's lanes are [s0, s1)
        const int last = L - 1;
        const uint32_t radix = (uint32_t)args.radix[last];
        const uint32_t b = (uint32_t)args.base[last];
        const uint32_t chunks = (radix + DPRF_RUN - 1) / DPRF_RUN;
        const uint32_t run = (radix + chunks - 1) / chunks;
        const uint32_t s0 = b + args.offset, s1 = b + n_valid;
        if (s1 <= s0) return;
        const uint32_t j0 = s0 / radix;
        const uint32_t n_runs = ((s1 - 1) / radix - j0 + 1) * chunks;
        const uint8_t* lut_last = s_lut + last * 256;

        for (uint32_t g = blockIdx.x * blockDim.x + threadIdx.x; g < n_runs;
             g += stride) {
            const uint32_t jj = g / chunks;
            const uint32_t j = j0 + jj, period = j * radix;
            const uint32_t first = period + (g - jj * chunks) * run;
            const uint32_t lo = max(first, s0);
            const uint32_t hi = min(min(first + run, period + radix), s1);

            // positions L - 2 .. 0 from the carry j, once a run
            uint32_t m[kBlock];
#pragma unroll
            for (int i = 0; i < kBlock; ++i) m[i] = args.block[i];
            uint32_t carry = j;
            DPRF_DECODE_RCP(Core, Core::kMaxLen, last);

            for (uint32_t sum = lo; sum < hi; ++sum) {
                const uint32_t byte =
                    (uint32_t)lut_last[sum - period] * 0x01010101u;
                uint32_t w[kBlock];
#pragma unroll
                for (int i = 0; i < kBlock; ++i)
                    w[i] = i < kByteWords<Core> ? m[i] | (byte & args.sel[i])
                                                : m[i];
                hash_lane(w, sum - b);
            }
        }
    }
}

// ---- launching one instantiation ----------------------------------------

// Dynamic shared memory of one block: the charset table, then the
// prefilter's words (none for kBulk, whose bitmap stays in global
// memory).
static size_t shared_bytes(int length, const MultiArgs* multi, Compare mode)
{
    const size_t filter =
        mode == kSets ? (size_t)multi->n_sets * DPRF_K_PROBES * 128 * 4
        : mode == kProbe
            ? ((size_t)DPRF_PROBE_BLOCK_WORDS << multi->block_bits) * 4
            : 0;
    return (size_t)length * 256 + filter;
}

// The instantiation's dynamic shared memory limit, raised to smem: a
// wide core's always, any other's past the 48 KB default.
template <class Core, Compare kMode>
static cudaError_t allow_shared(size_t smem)
{
    if (kWideCore<Core> || smem > DPRF_DEFAULT_SHARED)
        return cudaFuncSetAttribute(
            mask_kernel<Core, kMode>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return cudaSuccess;
}

// args points to the core's layout, ArgsOf<Core>.
template <class Core, Compare kMode>
static int launch(const uint8_t* lut, const void* args,
                  const MultiArgs* multi, uint32_t n_valid, int32_t* count,
                  int32_t* lanes, int32_t* tpos, int32_t* n_maybe,
                  int32_t cap, int grid, int threads, cudaStream_t stream)
{
    const ArgsOf<Core>& a = *static_cast<const ArgsOf<Core>*>(args);
    const size_t smem = shared_bytes(a.length, multi, kMode);
    const cudaError_t err = allow_shared<Core, kMode>(smem);
    if (err != cudaSuccess) return (int)err;
    mask_kernel<Core, kMode><<<grid, threads, smem, stream>>>(
        lut, a, *multi, n_valid, count, lanes, tpos, n_maybe, cap);
    return (int)cudaGetLastError();
}

template <class Core, Compare kMode>
static int occupancy(int threads, size_t smem, int* blocks)
{
    const cudaError_t err = allow_shared<Core, kMode>(smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, mask_kernel<Core, kMode>, threads, smem);
}

// CALL(Core, mode) bodies for the sources' C entries: a launch on the
// entry's stream, and the occupancy query.
#define DPRF_LAUNCH_ONE(C, M)                                             \
    launch<C, M>(lut, args, multi, n_valid, count, lanes, tpos, n_maybe,  \
                 cap, grid, threads, (cudaStream_t)stream)

#define DPRF_OCCUPANCY_ONE(C, M) occupancy<C, M>(threads, (size_t)smem, blocks)
