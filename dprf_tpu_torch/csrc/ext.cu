// ext.cu -- the salted and nested fast-hash chains of the mask kernel,
// for Hopper (sm_90a).
//
// Replaces: the two TPU kernels of dprf_tpu/ops/pallas_ext.py:
//
// - make_ext_pallas_fn (_build_ext_body, _digest_chain, _hex_byts):
//   nested outer(hex(inner(p))) for md5(md5), sha1(sha1), md5(sha1),
//   sha1(md5), sha256(md5), sha256(sha1), and mysql41 (sha1 of the raw
//   sha1 digest), with one target or the multi-target Bloom compare;
// - make_salted_pallas_fn: md5, sha1 and sha256 over $pass.$salt ("ps")
//   and $salt.$pass ("sp"): salted.cuh's kernel, a group of targets a
//   launch, which also takes sha512 and MSSQL's UTF-16LE placement (the
//   reference runs those on XLA only).
//
// Every nested chain is a core type for the mask kernel template of
// mask_kernel.cuh, so the decode, the single and multi-target compares
// and the hit append are the mask kernel's own:
//
// - Nested<Outer, Inner>: the candidate is placed by the INNER core's
//   byte order; digest runs the inner core, hex-encodes its digest in
//   registers (lowercase, in the digest's canonical byte order, one
//   select per nibble), packs the 32 (md5) or 40 (sha1) hex bytes with
//   the 0x80 marker and the bit length into the OUTER core's block, and
//   runs the outer core.  kWords is the outer core's.
// - Mysql41: sha1, then sha1 over a second block of the five raw inner
//   words, 0x80000000 and the bit length 160.
//
// What bounds it: the INT32 issue rate, as for the mask kernel; a nested
// candidate costs two cores plus the hex map (~6 ALU ops a digest byte).
// ops/opcount.py counts the least work of each.

#include "mask_kernel.cuh"
#include "salted.cuh"

// ---- nested: outer(hex(inner(p))) -----------------------------------------

__device__ __forceinline__ uint32_t hex_char(uint32_t nibble)
{
    return nibble + (nibble < 10u ? (uint32_t)'0' : (uint32_t)('a' - 10));
}

// The inner digest's lowercase hex, placed by Outer's byte order, with
// its padding: the outer core's whole message block.
template <class Outer, class Inner>
__device__ __forceinline__ void hex_block(const uint32_t* d, uint32_t* m)
{
    constexpr int kHex = 8 * Inner::kWords;      // 32 or 40 bytes
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = 0u;
#pragma unroll
    for (int k = 0; k < 4 * Inner::kWords; ++k) {
        // inner digest byte k, in the digest's canonical byte order
        const uint32_t b = (d[Inner::word(k)] >> Inner::shift(k)) & 0xffu;
        m[Outer::word(2 * k)] |= hex_char(b >> 4) << Outer::shift(2 * k);
        m[Outer::word(2 * k + 1)] |= hex_char(b & 15u)
                                     << Outer::shift(2 * k + 1);
    }
    m[Outer::word(kHex)] |= 0x80u << Outer::shift(kHex);
    m[Outer::kLenWord] = 8u * kHex;
}

template <class Outer, class Inner>
struct Nested {
    static constexpr int kWords = Outer::kWords;
    static constexpr int kMaxLen = Inner::kMaxLen;
    __host__ __device__ static constexpr int word(int q)
    {
        return Inner::word(q);
    }
    __host__ __device__ static constexpr int shift(int q)
    {
        return Inner::shift(q);
    }

    __device__ __forceinline__ static void digest(uint32_t* m, uint32_t* out)
    {
        uint32_t d[Inner::kWords];
        Inner::digest(m, d);
        uint32_t m2[16];
        hex_block<Outer, Inner>(d, m2);
        Outer::digest(m2, out);
    }
};

// MySQL 4.1+ PASSWORD(): sha1(sha1(p)) over the raw inner digest.
struct Mysql41 : Sha1Core {
    __device__ __forceinline__ static void digest(uint32_t* m, uint32_t* out)
    {
        uint32_t d[5];
        Sha1Core::digest(m, d);
        uint32_t m2[16] = {d[0], d[1], d[2], d[3], d[4], 0x80000000u,
                           0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 160u};
        Sha1Core::digest(m2, out);
    }
};

// ---- the C interface ---------------------------------------------------

using Md5OfMd5 = Nested<Md5Core, Md5Core>;
using Sha1OfSha1 = Nested<Sha1Core, Sha1Core>;
using Md5OfSha1 = Nested<Md5Core, Sha1Core>;
using Sha1OfMd5 = Nested<Sha1Core, Md5Core>;
using Sha256OfMd5 = Nested<Sha256Core, Md5Core>;
using Sha256OfSha1 = Nested<Sha256Core, Sha1Core>;

// variant ids (ops/cuda_ext.VARIANTS): 0-5 the nested combos in
// NESTED_COMBOS order, 6 mysql41, each single or multi target
#define DPRF_EXT_DISPATCH(CALL)                                           \
    switch (variant * 2 + (multi_mode ? 1 : 0)) {                         \
    case 0: return CALL(Md5OfMd5, kSingle);                                 \
    case 1: return CALL(Md5OfMd5, kSets);                                  \
    case 2: return CALL(Sha1OfSha1, kSingle);                               \
    case 3: return CALL(Sha1OfSha1, kSets);                                \
    case 4: return CALL(Md5OfSha1, kSingle);                                \
    case 5: return CALL(Md5OfSha1, kSets);                                 \
    case 6: return CALL(Sha1OfMd5, kSingle);                                \
    case 7: return CALL(Sha1OfMd5, kSets);                                 \
    case 8: return CALL(Sha256OfMd5, kSingle);                              \
    case 9: return CALL(Sha256OfMd5, kSets);                               \
    case 10: return CALL(Sha256OfSha1, kSingle);                            \
    case 11: return CALL(Sha256OfSha1, kSets);                             \
    case 12: return CALL(Mysql41, kSingle);                                 \
    case 13: return CALL(Mysql41, kSets);                                  \
    default: return (int)cudaErrorInvalidValue;                           \
    }

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  count and n_maybe must hold 0
// and lanes -1 on entry (the wrapper allocates them so).
extern "C" int dprf_ext_launch(int variant, int multi_mode, int device,
                               const uint8_t* lut, const MaskArgs* args,
                               const MultiArgs* multi, uint32_t n_valid,
                               int32_t* count, int32_t* lanes,
                               int32_t* tpos, int32_t* n_maybe,
                               int32_t cap, int grid, int threads,
                               void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    DPRF_EXT_DISPATCH(DPRF_LAUNCH_ONE)
}

// Resident blocks of `threads` threads per SM for one instantiation at
// `smem` bytes of dynamic shared memory (the grid's size).
extern "C" int dprf_ext_blocks_per_sm(int variant, int multi_mode,
                                      int threads, int smem, int* blocks)
{
    DPRF_EXT_DISPATCH(DPRF_OCCUPANCY_ONE)
}

// ---- the salted kernel (salted.cuh) -------------------------------------

// salted ids (ops/cuda_ext.SALTED_VARIANTS): md5-ps, md5-sp, sha1-ps,
// sha1-sp, sha256-ps, sha256-sp, sha512-ps, sha512-sp, sha1-ps-utf16,
// sha512-ps-utf16
#define DPRF_SALTED_DISPATCH(CALL)                                        \
    switch (salted) {                                                     \
    case 0: return CALL(Md5Core, false, Md5Core);                         \
    case 1: return CALL(Md5Core, true, Md5Core);                          \
    case 2: return CALL(Sha1Core, false, Sha1Core);                       \
    case 3: return CALL(Sha1Core, true, Sha1Core);                        \
    case 4: return CALL(Sha256Core, false, Sha256Core);                   \
    case 5: return CALL(Sha256Core, true, Sha256Core);                    \
    case 6: return CALL(Sha512Core, false, Sha512Core);                   \
    case 7: return CALL(Sha512Core, true, Sha512Core);                    \
    case 8: return CALL(Sha1Core, false, Utf16<Sha1Core>);                \
    case 9: return CALL(Sha512Core, false, Utf16<Sha512Core>);            \
    default: return (int)cudaErrorInvalidValue;                           \
    }

#define DPRF_SALTED_LAUNCH(C, SP, P)                                      \
    salted_launch<C, SP, P>(lut, args, rows, n_valid, count, lanes, tpos, \
                            tcount, cap, grid, threads,                   \
                            (cudaStream_t)stream)
#define DPRF_SALTED_OCCUPANCY(C, SP, P)                                   \
    salted_occupancy<C, SP, P>(threads, (size_t)smem, blocks)

// Launch the salted kernel `salted` over a group of n_targets targets
// (args: a SaltedArgs, or a WideSaltedArgs for sha512; rows:
// uint32[n_targets][DPRF_SALTED_ROW or DPRF_SALTED_WIDE_ROW] in device
// memory) on the caller's stream without synchronising; returns the
// launch's cudaError_t.  count and tcount must hold 0 and lanes -1 on
// entry.
extern "C" int dprf_salted_launch(int salted, int device, const uint8_t* lut,
                                  const void* args,
                                  const uint32_t* rows, uint32_t n_valid,
                                  int32_t* count, int32_t* lanes,
                                  int32_t* tpos, int32_t* tcount,
                                  int32_t cap, int grid, int threads,
                                  void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    DPRF_SALTED_DISPATCH(DPRF_SALTED_LAUNCH)
}

// Resident blocks of `threads` threads per SM of the salted kernel
// `salted` at `smem` bytes of dynamic shared memory.
extern "C" int dprf_salted_blocks_per_sm(int salted, int threads, int smem,
                                         int* blocks)
{
    DPRF_SALTED_DISPATCH(DPRF_SALTED_OCCUPANCY)
}
