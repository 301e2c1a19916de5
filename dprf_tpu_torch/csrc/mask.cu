// mask.cu -- the fused mask -> hash -> compare kernel for Hopper (sm_90a).
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_mask.py
// (make_mask_pallas_fn / _build_kernel_body) for the md5, md4 (ntlm),
// sha1, sha256, sha512 and sha384 cores, with one target, the
// multi-target per-set Bloom compare, the blocked probe or the bulk probe
// (compare.cuh; the reference runs bulk lists on its XLA probe table,
// dprf_tpu/targets/probe.py), each with the window offset.  Two more cores, which the reference runs on XLA only,
// take the same body: sha224 and mysql323 (cores.cuh).  The
// kernel body, its compares and its design notes are in mask_kernel.cuh,
// shared with csrc/ext.cu (the nested, mysql41 and salted chains) and
// csrc/keccak.cu (the sponges); this source instantiates it over the
// plain cores: the message is the candidate alone (little-endian for
// md5/md4, big-endian for SHA and mysql323, UTF-16LE widened for ntlm;
// one 128-byte block of 64-bit words for sha512 and sha384, which take
// the wide parameter layout).

#include "mask_kernel.cuh"

// ---- the C interface ---------------------------------------------------

// core ids: 0 md5, 1 md4 (ntlm), 2 sha1, 3 sha256, 4 sha512, 5 sha384,
// 6 sha224, 7 mysql323 (ops/cuda_mask.KERNEL_CORES); modes: 0 one
// target, 1 the per-set Bloom prefilter, 2 the blocked probe, 3 the bulk
// probe (ops/cuda_mask.MODES; mysql323 has no mode 1)
#define DPRF_DISPATCH(CALL)                                               \
    switch (core * 4 + mode) {                                            \
    case 0: return CALL(Md5Core, kSingle);                                \
    case 1: return CALL(Md5Core, kSets);                                  \
    case 2: return CALL(Md5Core, kProbe);                                 \
    case 3: return CALL(Md5Core, kBulk);                                  \
    case 4: return CALL(Md4Core, kSingle);                                \
    case 5: return CALL(Md4Core, kSets);                                  \
    case 6: return CALL(Md4Core, kProbe);                                 \
    case 7: return CALL(Md4Core, kBulk);                                  \
    case 8: return CALL(Sha1Core, kSingle);                               \
    case 9: return CALL(Sha1Core, kSets);                                 \
    case 10: return CALL(Sha1Core, kProbe);                               \
    case 11: return CALL(Sha1Core, kBulk);                                \
    case 12: return CALL(Sha256Core, kSingle);                            \
    case 13: return CALL(Sha256Core, kSets);                              \
    case 14: return CALL(Sha256Core, kProbe);                             \
    case 15: return CALL(Sha256Core, kBulk);                              \
    case 16: return CALL(Sha512Core, kSingle);                            \
    case 17: return CALL(Sha512Core, kSets);                              \
    case 18: return CALL(Sha512Core, kProbe);                             \
    case 19: return CALL(Sha512Core, kBulk);                              \
    case 20: return CALL(Sha384Core, kSingle);                            \
    case 21: return CALL(Sha384Core, kSets);                              \
    case 22: return CALL(Sha384Core, kProbe);                             \
    case 23: return CALL(Sha384Core, kBulk);                              \
    case 24: return CALL(Sha224Core, kSingle);                            \
    case 25: return CALL(Sha224Core, kSets);                              \
    case 26: return CALL(Sha224Core, kProbe);                             \
    case 27: return CALL(Sha224Core, kBulk);                              \
    case 28: return CALL(Mysql323Core, kSingle);                          \
    case 30: return CALL(Mysql323Core, kProbe);                           \
    case 31: return CALL(Mysql323Core, kBulk);                            \
    default: return (int)cudaErrorInvalidValue;                           \
    }

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  args points to a MaskArgs, or a
// WideMaskArgs for sha512 and sha384.  count and n_maybe hold 0 and
// lanes -1 on entry (the wrapper allocates them so), or the window's
// running values when launches of one window append to one set of
// buffers.
extern "C" int dprf_mask_launch(int core, int mode, int device,
                                const uint8_t* lut, const void* args,
                                const MultiArgs* multi, uint32_t n_valid,
                                int32_t* count, int32_t* lanes,
                                int32_t* tpos, int32_t* n_maybe,
                                int32_t cap, int grid, int threads,
                                void* stream)
{
    if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    DPRF_DISPATCH(DPRF_LAUNCH_ONE)
}

// Resident blocks of `threads` threads per SM for one instantiation at
// `smem` bytes of dynamic shared memory (the grid's size).
extern "C" int dprf_mask_blocks_per_sm(int core, int mode,
                                       int threads, int smem, int* blocks)
{
    if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
    DPRF_DISPATCH(DPRF_OCCUPANCY_ONE)
}
