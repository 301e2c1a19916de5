// keccak.cu -- the fused mask -> Keccak -> compare kernel for Hopper
// (sm_90a): sha3-224/256/384/512 and the original keccak-224/256/384/512.
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_keccak.py
// (make_keccak_pallas_fn / _build_keccak_body, driven by
// make_pallas_keccak_crack_step): decode, absorb, Keccak-f[1600], squeeze,
// compare.  Here the sponge is a core type of the mask kernel template
// (mask_kernel.cuh), so the decode, the one-target compare, the
// multi-target Bloom prefilter with its on-card verify and the hit
// append are the mask kernel's own.  (The reference's kernel takes one
// target and sends lists to its XLA sorted-table compare; a list here
// runs the mask kernel's multi-target compare, with the same hit set.)
//
// What bounds it: the INT32 issue rate, as for the mask kernel: per
// round ~50 LOP3 for theta, 50 funnel shifts for rho, 50 LOP3 for chi,
// on 32-bit halves.  ops/opcount.py counts the least work.

#include "mask_kernel.cuh"
#include "keccak.cuh"

// ---- the C interface ---------------------------------------------------

using Keccak224 = KeccakCore<144, 7>;
using Keccak256 = KeccakCore<136, 8>;
using Keccak384 = KeccakCore<104, 12>;
using Keccak512 = KeccakCore<72, 16>;

// variant ids (ops/cuda_keccak.VARIANTS): 0 rate 144 (224-bit digest),
// 1 rate 136 (256), 2 rate 104 (384), 3 rate 72 (512), each single or
// multi target
#define DPRF_KECCAK_DISPATCH(CALL)                                        \
    switch (variant * 2 + (multi_mode ? 1 : 0)) {                         \
    case 0: return CALL(Keccak224, kSingle);                                \
    case 1: return CALL(Keccak224, kSets);                                 \
    case 2: return CALL(Keccak256, kSingle);                                \
    case 3: return CALL(Keccak256, kSets);                                 \
    case 4: return CALL(Keccak384, kSingle);                                \
    case 5: return CALL(Keccak384, kSets);                                 \
    case 6: return CALL(Keccak512, kSingle);                                \
    case 7: return CALL(Keccak512, kSets);                                 \
    default: return (int)cudaErrorInvalidValue;                           \
    }

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  args points to a WideMaskArgs.
// count and n_maybe must hold 0 and lanes -1 on entry (the wrapper
// allocates them so).
extern "C" int dprf_keccak_launch(int variant, int multi_mode, int device,
                                  const uint8_t* lut, const void* args,
                                  const MultiArgs* multi, uint32_t n_valid,
                                  int32_t* count, int32_t* lanes,
                                  int32_t* tpos, int32_t* n_maybe,
                                  int32_t cap, int grid, int threads,
                                  void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    DPRF_KECCAK_DISPATCH(DPRF_LAUNCH_ONE)
}

// Resident blocks of `threads` threads per SM for one instantiation at
// `smem` bytes of dynamic shared memory (the grid's size).
extern "C" int dprf_keccak_blocks_per_sm(int variant, int multi_mode,
                                         int threads, int smem, int* blocks)
{
    DPRF_KECCAK_DISPATCH(DPRF_OCCUPANCY_ONE)
}
