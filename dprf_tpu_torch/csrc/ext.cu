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
// Every nested chain is a core type of chains.cuh (Nested<Outer, Inner>,
// Mysql41) for the mask kernel template of mask_kernel.cuh, so the
// decode, the single and multi-target compares and the hit append are
// the mask kernel's own; csrc/rules_nested.cu runs the same cores under
// the rules kernel.
//
// What bounds it: the INT32 issue rate, as for the mask kernel; a nested
// candidate costs two cores plus the hex map (~6 ALU ops a digest byte).
// ops/opcount.py counts the least work of each.

#include "chains.cuh"
#include "mask_kernel.cuh"
#include "salted.cuh"

// ---- the C interface ---------------------------------------------------

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
