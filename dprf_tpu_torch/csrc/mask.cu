// mask.cu -- the fused mask -> hash -> compare kernel for Hopper (sm_90a).
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_mask.py
// (make_mask_pallas_fn / _build_kernel_body) for the md5, md4 (ntlm),
// sha1, sha256, sha512 and sha384 cores, with one target or with the
// multi-target Bloom compare, without the window offset.  The kernel
// body, its compare and its design notes are in mask_kernel.cuh, shared
// with csrc/ext.cu (the nested, mysql41 and salted chains) and
// csrc/keccak.cu (the sponges); this source instantiates it
// over the plain cores of cores.cuh: the message is the candidate alone
// (little-endian for md5/md4, big-endian for SHA, UTF-16LE widened for
// ntlm; one 128-byte block of 64-bit words for sha512 and sha384, which
// take the wide parameter layout).

#include "mask_kernel.cuh"

// ---- the C interface ---------------------------------------------------

// core ids: 0 md5, 1 md4 (ntlm), 2 sha1, 3 sha256, 4 sha512, 5 sha384
// (ops/cuda_mask.KERNEL_CORES)
#define DPRF_DISPATCH(CALL)                                               \
    switch (core * 2 + (multi_mode ? 1 : 0)) {                            \
    case 0: return CALL(Md5Core, false);                                  \
    case 1: return CALL(Md5Core, true);                                   \
    case 2: return CALL(Md4Core, false);                                  \
    case 3: return CALL(Md4Core, true);                                   \
    case 4: return CALL(Sha1Core, false);                                 \
    case 5: return CALL(Sha1Core, true);                                  \
    case 6: return CALL(Sha256Core, false);                               \
    case 7: return CALL(Sha256Core, true);                                \
    case 8: return CALL(Sha512Core, false);                               \
    case 9: return CALL(Sha512Core, true);                                \
    case 10: return CALL(Sha384Core, false);                              \
    case 11: return CALL(Sha384Core, true);                               \
    default: return (int)cudaErrorInvalidValue;                           \
    }

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  args points to a MaskArgs, or a
// WideMaskArgs for sha512 and sha384.  count and n_maybe must hold 0
// and lanes -1 on entry (the wrapper allocates them so).
extern "C" int dprf_mask_launch(int core, int multi_mode, int device,
                                const uint8_t* lut, const void* args,
                                const MultiArgs* multi, uint32_t n_valid,
                                int32_t* count, int32_t* lanes,
                                int32_t* tpos, int32_t* n_maybe,
                                int32_t cap, int grid, int threads,
                                void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    DPRF_DISPATCH(DPRF_LAUNCH_ONE)
}

// Resident blocks of `threads` threads per SM for one instantiation at
// `smem` bytes of dynamic shared memory (the grid's size).
extern "C" int dprf_mask_blocks_per_sm(int core, int multi_mode,
                                       int threads, int smem, int* blocks)
{
    DPRF_DISPATCH(DPRF_OCCUPANCY_ONE)
}
