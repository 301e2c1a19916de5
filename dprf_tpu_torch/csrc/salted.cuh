// salted.cuh -- the salted kernel for Hopper (sm_90a): md5, sha1,
// sha256 and sha512 over $pass.$salt ("ps") and $salt.$pass ("sp"), and
// sha1 and sha512 over the UTF-16LE candidate and the salt (MSSQL), a
// group of targets a launch.
//
// Replaces: make_salted_pallas_fn of dprf_tpu/ops/pallas_ext.py
// (pl.pallas_call at :352), which hashes every candidate for one target
// a launch, for md5, sha1 and sha256.  The sha512 variants and the
// UTF-16LE placements replace no TPU kernel: the reference runs them on
// XLA only (its salted engines, dprf_tpu/engines/device/salted.py).
//
// The variants (ops/cuda_ext.SALTED_VARIANTS) are properties of the
// core and of the candidate's placement, Place: the core itself (byte q
// at its byte q), or Utf16<Core> (byte q at message byte 2q, the odd
// bytes 0; the salt after the widened candidate, unwidened, as the
// host's salted_block writes it).  A core of a 128-byte block (sha512)
// is wide: 32 message words in a target's row beside 16 digest words
// (DPRF_SALTED_WIDE_ROW), 28 words a candidate and its salt can reach,
// up to 111 positions (WideSaltedArgs, each decoded by a division: the
// decode is once a candidate, shared by a group of pairs).  Its rows for
// a group of 256 (48 KB) and a charset table pass the 48 KB of dynamic
// shared memory a launch gets without asking, so a wide variant raises
// its limit before the launch and the occupancy query.  It keeps one
// candidate a thread, runs the whole sha512_block (cores.cuh) a pair and
// compares word 0 first.
//
// A launch serves a group of up to DPRF_SALTED_GROUP targets whose
// candidate sits at the same bytes: every "ps" target (the candidate at
// [0, L), whatever the salt), or the "sp" targets of one salt length S
// (the candidate at [S, S + L)).  Each target's row, in shared memory,
// holds its fixed message words (its salt, the 0x80 marker and the bit
// length of L + its salt, from the host's cuda_ext.salted_block) and its
// digest words.  Per candidate a thread:
//
// - decodes the keyspace index once, by reciprocals (DPRF_DECODE_RCP:
//   no division), into zeroed words at [0, L), and for "sp" moves them
//   by S bytes (a funnel shift, then a warp-uniform switch over whole
//   words: constant indices, so the words stay in registers);
// - loops over the group's targets: ORs the candidate's words into the
//   target's fixed words (the bytes never overlap), runs the core and
//   compares digest word 0.  MD5's word 0 is final after step 60, so the
//   loop runs 61 steps and the rest of the digest only for a candidate
//   whose word 0 matches; SHA-1's and SHA-256's word 0 is their last
//   step's, so they run the whole core (cores.cuh) and compare the other
//   words only after word 0 matched.
//
// Hits append (lane, target position) and count per target: count >
// cap sends the batch to the worker, which rescans exactly every target
// whose own count its recorded hits do not cover.
//
// What bounds it: the INT32 issue rate.  A (candidate, target) pair
// reads its target's row from shared memory (a broadcast: every thread
// of a warp reads the same words) and nothing from device memory.
// ops/opcount.salted_ops counts the least work: the core to word 0 and
// a compare per pair, the decode once per candidate over the group.
//
// What the design does about it: the work that does not depend on the
// target (the decode, the sp move) runs once per candidate, not once
// per pair; MD5 stops at step 60; and MD5's a + m[g] add is an IMAD on
// the FMA pipe (x * one + y, with `one` a launch parameter the compiler
// cannot fold), so a step issues three INT32 instructions (the round
// function's LOP3, the IADD3 of f and K, the LEA.HI of b + rotl) and one
// IMAD rather than four INT32 instructions.  MD5's constants are
// literals, immediates of their IADD3s: read from the __constant__ table,
// ptxas kept them in registers across the target loop, which left room
// for fewer resident blocks.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "cores.cuh"
#include "decode.cuh"
#include "place.cuh"

#define DPRF_SALTED_MAX_LEN 55
// candidate + salt in SHA-512's block (the wide core)
#define DPRF_SALTED_WIDE_MAX_LEN 111
// the most targets a launch takes (ops/cuda_ext.SALTED_GROUP)
#define DPRF_SALTED_GROUP 256
// words of a target's row: 16 fixed message words, then 8 digest words
// (md5 keeps its word 0 less the IV's in word 20, the compare after
// step 60); the wide core's: 32 message words, then 16 digest words
#define DPRF_SALTED_ROW 24
#define DPRF_SALTED_WIDE_ROW 48
// dynamic shared memory a launch gets without the opt-in
#define DPRF_SALTED_DEFAULT_SHARED (48 * 1024)

// Kernel parameters of one launch (mirrored by ops/cuda_ext.SaltedArgs).
struct SaltedArgs {
    int32_t length;
    int32_t radix[DPRF_SALTED_MAX_LEN];
    int32_t base[DPRF_SALTED_MAX_LEN];
    // the decode's reciprocals (decode.cuh, DPRF_DECODE_RCP)
    uint32_t rcp[DPRF_SALTED_MAX_LEN];
    int32_t rsh[DPRF_SALTED_MAX_LEN];
    // "sp": the group's salt length, the candidate's first byte
    int32_t shift;
    int32_t n_targets;
    // 1: the multiplier of the adds moved to the FMA pipe
    uint32_t one;
};

// The same for the wide core (mirrored by ops/cuda_ext.WideSaltedArgs).
struct WideSaltedArgs {
    int32_t length;
    int32_t radix[DPRF_SALTED_WIDE_MAX_LEN];
    int32_t base[DPRF_SALTED_WIDE_MAX_LEN];
    int32_t shift;
    int32_t n_targets;
    uint32_t one;
};

// MSSQL's placement: candidate byte q at the core's message byte 2q, as
// Md4Core widens for ntlm; the odd bytes stay 0.
template <class Core>
struct Utf16 {
    static constexpr int kMaxLen = Core::kMaxLen / 2;
    static constexpr int kBitsPerChar = 16;
    __host__ __device__ static constexpr int word(int q)
    {
        return Core::word(2 * q);
    }
    __host__ __device__ static constexpr int shift(int q)
    {
        return Core::shift(2 * q);
    }
};

// A variant's layout: its message words, the words a candidate or salt
// byte can reach, its row, its most positions and its parameters.
template <class Core, class Place>
struct SaltedLayout {
    static constexpr bool kWide = Core::kMaxLen > DPRF_SALTED_MAX_LEN;
    static constexpr int kBlock = kWide ? 32 : 16;
    static constexpr int kCand = kWide ? 28 : 14;
    static constexpr int kRow = kWide ? DPRF_SALTED_WIDE_ROW : DPRF_SALTED_ROW;
    static constexpr int kMaxPos = Place::kMaxLen;
    using Args = std::conditional_t<kWide, WideSaltedArgs, SaltedArgs>;
};

// x + y as an IMAD, x * one + y, on the FMA pipe.
__device__ __forceinline__ uint32_t fma_pipe_add(uint32_t x, uint32_t y,
                                                 uint32_t one)
{
    uint32_t r;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(one), "r"(y));
    return r;
}

// MD5's digest word 0 less the IV's: steps 0-60 of the compression from
// the IV (word 0's last update is step 60's).
__device__ __forceinline__ uint32_t md5_word0(const uint32_t* m,
                                              uint32_t one)
{
    const int S[4][4] = {{7, 12, 17, 22}, {5, 9, 14, 20},
                         {4, 11, 16, 23}, {6, 10, 15, 21}};
    // K_MD5's words as literals: each folds into its IADD3 as an
    // immediate, where the __constant__ table's would take a register
    const uint32_t K[61] = {
        0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu,
        0xf57c0fafu, 0x4787c62au, 0xa8304613u, 0xfd469501u,
        0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
        0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u,
        0xf61e2562u, 0xc040b340u, 0x265e5a51u, 0xe9b6c7aau,
        0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
        0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu,
        0xa9e3e905u, 0xfcefa3f8u, 0x676f02d9u, 0x8d2a4c8au,
        0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
        0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u,
        0x289b7ec6u, 0xeaa127fau, 0xd4ef3085u, 0x04881d05u,
        0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
        0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u,
        0x655b59c3u, 0x8f0ccc92u, 0xffeff47du, 0x85845dd1u,
        0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
        0xf7537e82u};
    uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu,
             d = 0x10325476u;
#pragma unroll
    for (int i = 0; i < 61; ++i) {
        uint32_t f;
        int g;
        if (i < 16) {
            f = d ^ (b & (c ^ d));
            g = i;
        } else if (i < 32) {
            f = c ^ (d & (b ^ c));
            g = (5 * i + 1) & 15;
        } else if (i < 48) {
            f = b ^ c ^ d;
            g = (3 * i + 5) & 15;
        } else {
            f = c ^ (b | ~d);
            g = (7 * i) & 15;
        }
        const uint32_t tmp = fma_pipe_add(m[g], a, one) + f + K[i];
        a = d;
        d = c;
        c = b;
        b = b + rotl(tmp, S[i >> 4][i & 3]);
    }
    return b;   // steps 61-63 only rotate it into a
}

// One (candidate, target) pair: the candidate's words c over the row's
// fixed words; true if the whole digest equals the row's.
template <class Core, class Lay>
__device__ __forceinline__ bool salted_match(const uint32_t* c,
                                             const uint32_t* row,
                                             uint32_t one)
{
    constexpr int kBlock = Lay::kBlock;
    uint32_t m[kBlock];
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int j = 0; j < kBlock / 4; ++j) {
        const uint4 v = r4[j];
        m[4 * j] = v.x;
        m[4 * j + 1] = v.y;
        m[4 * j + 2] = v.z;
        m[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < Lay::kCand; ++j) m[j] |= c[j];
    uint32_t dg[Core::kWords];
    if constexpr (Core::kWords == 4) {          // md5
        if (md5_word0(m, one) != row[16 + 4]) return false;
        Core::digest(m, dg);
    } else {
        Core::digest(m, dg);
        if (dg[0] != row[kBlock]) return false;
    }
    bool eq = true;
#pragma unroll
    for (int i = 0; i < Core::kWords; ++i) eq &= dg[i] == row[kBlock + i];
    return eq;
}

template <class Core, bool kSp, class Place = Core>
__global__ void __launch_bounds__(256)
salted_kernel(const uint8_t* __restrict__ lut,
              const typename SaltedLayout<Core, Place>::Args args,
              const uint32_t* __restrict__ rows, uint32_t n_valid,
              int32_t* __restrict__ count, int32_t* __restrict__ lanes,
              int32_t* __restrict__ tpos, int32_t* __restrict__ tcount,
              int32_t cap)
{
    using Lay = SaltedLayout<Core, Place>;
    // the targets' rows, then the per-position charset tables
    extern __shared__ __align__(16) uint8_t smem[];
    const int L = args.length, T = args.n_targets;
    uint32_t* s_rows = reinterpret_cast<uint32_t*>(smem);
    uint8_t* s_lut = smem + T * Lay::kRow * 4;
    for (int i = threadIdx.x; i < T * Lay::kRow; i += blockDim.x)
        s_rows[i] = rows[i];
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    __syncthreads();

    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t gidx = blockIdx.x * blockDim.x + threadIdx.x;
         gidx < n_valid; gidx += stride) {
        uint32_t m[Lay::kCand];
#pragma unroll
        for (int i = 0; i < Lay::kCand; ++i) m[i] = 0u;
        uint32_t carry = gidx;
        if constexpr (Lay::kWide)
            DPRF_DECODE(Place, Lay::kMaxPos, L);
        else
            DPRF_DECODE_RCP(Place, Lay::kMaxPos, L);
        if constexpr (kSp) move_candidate<Core, Lay::kCand>(m, args.shift);

        for (int t = 0; t < T; ++t) {
            if (salted_match<Core, Lay>(m, s_rows + t * Lay::kRow,
                                        args.one)) {
                atomicAdd(tcount + t, 1);
                const int32_t slot = atomicAdd(count, 1);
                if (slot < cap) {
                    lanes[slot] = (int32_t)gidx;
                    tpos[slot] = t;
                }
            }
        }
    }
}

// Dynamic shared memory of one block (ops/cuda_ext.salted_shared_bytes).
static size_t salted_shared_bytes(int length, int n_targets, int row)
{
    return (size_t)n_targets * row * 4 + (size_t)length * 256;
}

// The variant's dynamic shared memory limit, raised to smem: a wide
// variant's always, any other's past the 48 KB default.
template <class Core, bool kSp, class Place>
static cudaError_t salted_allow_shared(size_t smem)
{
    if (SaltedLayout<Core, Place>::kWide || smem > DPRF_SALTED_DEFAULT_SHARED)
        return cudaFuncSetAttribute(
            salted_kernel<Core, kSp, Place>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return cudaSuccess;
}

// args points to the variant's layout, SaltedLayout<Core, Place>::Args.
template <class Core, bool kSp, class Place>
static int salted_launch(const uint8_t* lut, const void* args_p,
                         const uint32_t* rows, uint32_t n_valid,
                         int32_t* count, int32_t* lanes, int32_t* tpos,
                         int32_t* tcount, int32_t cap, int grid, int threads,
                         cudaStream_t stream)
{
    using Lay = SaltedLayout<Core, Place>;
    const auto& args = *static_cast<const typename Lay::Args*>(args_p);
    if (args.length < 1 || args.length > Lay::kMaxPos
        || args.n_targets < 1 || args.n_targets > DPRF_SALTED_GROUP)
        return (int)cudaErrorInvalidValue;
    const size_t smem =
        salted_shared_bytes(args.length, args.n_targets, Lay::kRow);
    const cudaError_t err = salted_allow_shared<Core, kSp, Place>(smem);
    if (err != cudaSuccess) return (int)err;
    salted_kernel<Core, kSp, Place><<<grid, threads, smem, stream>>>(
        lut, args, rows, n_valid, count, lanes, tpos, tcount, cap);
    return (int)cudaGetLastError();
}

template <class Core, bool kSp, class Place>
static int salted_occupancy(int threads, size_t smem, int* blocks)
{
    const cudaError_t err = salted_allow_shared<Core, kSp, Place>(smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, salted_kernel<Core, kSp, Place>, threads, smem);
}
