// mask.cu -- the fused mask -> hash -> compare kernel for Hopper (sm_90a).
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_mask.py
// (make_mask_pallas_fn / _build_kernel_body) for the md5, md4 (ntlm),
// sha1, sha256, sha512 and sha384 cores, with one target, the
// multi-target per-set Bloom compare, the blocked probe or the bulk probe
// (compare.cuh; the reference runs bulk lists on its XLA probe table,
// dprf_tpu/targets/probe.py), each with the window offset.  Two more cores, which the reference runs on XLA only,
// take the same body: sha224 (cores.cuh) and mysql323 (below).  The
// kernel body, its compares and its design notes are in mask_kernel.cuh,
// shared with csrc/ext.cu (the nested, mysql41 and salted chains) and
// csrc/keccak.cu (the sponges); this source instantiates it over the
// plain cores: the message is the candidate alone (little-endian for
// md5/md4, big-endian for SHA and mysql323, UTF-16LE widened for ntlm;
// one 128-byte block of 64-bit words for sha512 and sha384, which take
// the wide parameter layout).

#include "mask_kernel.cuh"

// ---- mysql323 --------------------------------------------------------------

// MySQL pre-4.1 OLD_PASSWORD(): an add/xor/shift scan over the
// candidate's bytes, which sit big-endian in the message words as for
// SHA (the reference's digest_packed reads them back from that packing),
// to the length the bit length of word 15 gives: a launch parameter of
// a mask job, so the lanes of a warp take the same branches.  Spaces
// and tabs leave the state as it was; both 31-bit words come out.  The
// reference runs it on XLA only (no Pallas core); this core replaces no
// TPU kernel.  Its 2 digest words have no Bloom sets (their 8 probes
// read words 0-2): a list runs the blocked probe, which reuses its first
// pair of words for a core of fewer than 4 (probe_maybe).
//
// The scan walks the message words in a fully unrolled loop, each word
// and each byte behind a test of the length rather than a break out of
// the loop, so every word index is a compile-time constant: with a
// break, the probe instantiation kept the loop rolled, indexed the words
// at run time and took a stack frame.
struct Mysql323Core {
    static constexpr int kWords = 2;
    static constexpr int kMaxLen = 55;
    static constexpr int kLenWord = 15;
    static constexpr int kBitsPerChar = 8;
    __host__ __device__ static constexpr int word(int q) { return q >> 2; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 8 * (3 - (q & 3));
    }

    __device__ __forceinline__ static void digest(uint32_t* m,
                                                  uint32_t* out)
    {
        const int len = (int)(m[kLenWord] >> 3);
        uint32_t nr = 1345345333u, nr2 = 0x12345671u, add = 7u;
#pragma unroll
        for (int w = 0; w <= word(kMaxLen - 1); ++w) {
            if (4 * w < len) {
                const uint32_t x = m[w];
#pragma unroll
                for (int q = 4 * w; q < 4 * w + 4 && q < kMaxLen; ++q) {
                    if (q < len) {
                        const uint32_t c = (x >> shift(q)) & 0xffu;
                        const uint32_t nr_n =
                            nr ^ ((((nr & 63u) + add) * c) + (nr << 8));
                        const bool skip = c == 0x20u || c == 0x09u;
                        nr2 = skip ? nr2 : nr2 + ((nr2 << 8) ^ nr_n);
                        nr = skip ? nr : nr_n;
                        add = skip ? add : add + c;
                    }
                }
            }
        }
        out[0] = nr & 0x7fffffffu;
        out[1] = nr2 & 0x7fffffffu;
    }
};

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
