// pdf.cu -- the PDF standard-security-handler kernel for Hopper
// (sm_90a): mask decode -> Algorithm 2 (MD5 over pad32(password) || O,
// then the target's second block) -> for R3+ the 50-fold MD5 stretch
// over digest[:key_len] -> RC4 -> an exact compare with the stored U.
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_pdf.py
// (make_pdf_pallas_fn, pl.pallas_call at :280; its body _build_body, the
// pieces _block1_words, _stretch50 and _rc4_words; the launch scalars of
// target_scalars).  Per kind:
//   R2 (40-bit):  one key schedule under digest[:5] and 4 keystream
//                 bytes, against U[0:4] ^ PAD[0:4] (U = RC4(key, PAD));
//                 32 of U's 256 bits, so the worker confirms a hit with
//                 the oracle;
//   R3+:          20 passes, pass p keyed by digest[:key_len] ^ p, each
//                 xoring 16 keystream bytes into x (x starts as
//                 MD5(PAD || ID)), then all 16 bytes of x against U.
// One launch serves one document: its block words and U are kernel
// parameters; the kind (revision, key length) is a template parameter,
// so i % key_len is a constant in the unrolled key schedule.  Every hit
// is appended (lane) with an atomicAdd; count > cap sends that
// document's batch to the worker's exact oracle rescan.  The TPU
// kernel's packed (count << 16) | (hit + 1) tile output and its hardware
// gate on 40-bit keys are Mosaic's and are not carried over.
//
// What bounds it: shared memory and issue slots.  Per R3 candidate: 52
// MD5 compressions (the two Algorithm-2 blocks and the stretch) and 20
// RC4 runs of 256 key-schedule steps and 16 output steps, each step a
// dependent chain of shared loads and stores (ops/opcount.pdf_bound
// counts both limits); R2: two compressions and one run of 256 + 4
// steps.  It reads no device memory but its charset tables and writes
// only hits.
//
// What the design does about it: one thread per candidate in a
// grid-stride loop, the MD5 states and the key in registers, each
// thread's RC4 state in shared memory in the conflict-free layout of
// csrc/rc4.cuh (64 KB a 256-thread block, past the 48 KB a launch gets
// without asking, so the launch raises its limit).  The stretch and the
// pass loops stay rolled; the key schedule and the output steps are
// unrolled, and each pass xors the key words with p * 0x01010101 once,
// so a key byte is one extract.

#include <cstdint>
#include <cuda_runtime.h>

#include "cores.cuh"
#include "decode.cuh"
#include "rc4.cuh"

#define DPRF_PDF_MAX_LEN 32

constexpr int kThreads = 256;
// bytes of RC4 state a block keeps in shared memory
constexpr int kRc4Bytes = 256 * kThreads;

// Kernel parameters of one launch (mirrored by ops/cuda_pdf._Args).
struct PdfArgs {
    int32_t length;
    int32_t radix[DPRF_PDF_MAX_LEN];
    int32_t base[DPRF_PDF_MAX_LEN];
    // Algorithm 2's first block for an all-zero candidate: the spec's PAD
    // fill of pad32(password) for this length (words 0-7), then O (8-15)
    uint32_t block1[16];
    // the document's second block: P, ID, the R4 metadata flag, padding
    uint32_t block2[16];
    // R3+: MD5(PAD || ID), the cascade's input
    uint32_t x0[4];
    // R2: U[0:4] ^ PAD[0:4] in u[0]; R3+: U[0:16]
    uint32_t u[4];
};

// Key byte t (a compile-time constant) of the key words k.
__device__ __forceinline__ uint32_t key_byte(const uint32_t* k, int t)
{
    return (k[t >> 2] >> (8 * (t & 3))) & 0xffu;
}

// The key schedule under the kKeyLen-byte key k.
template <int kKeyLen>
__device__ __forceinline__ void ksa(uint8_t* s, const uint32_t* k)
{
    RC4_INIT(s);
    uint32_t j = 0u;
#pragma unroll
    for (int i = 0; i < 256; ++i) {
        const uint32_t kb = key_byte(k, i % kKeyLen);
        RC4_KSA_STEP(s, i, kb, j);
    }
}

template <int kRev, int kKeyLen>
__global__ void __launch_bounds__(kThreads)
pdf_kernel(const uint8_t* __restrict__ lut, const PdfArgs args,
           uint32_t n_valid, int32_t* __restrict__ count,
           int32_t* __restrict__ lanes, int32_t cap)
{
    // the RC4 states, then the per-position 256-byte charset tables
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* s_lut = smem + kRc4Bytes;
    const int L = args.length;
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    __syncthreads();
    uint8_t* s = smem + 4 * threadIdx.x;
    const uint32_t iv[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu,
                            0x10325476u};

    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t gidx = blockIdx.x * blockDim.x + threadIdx.x;
         gidx < n_valid; gidx += stride) {
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = args.block1[i];
        uint32_t carry = gidx;
        DPRF_DECODE(Md5Core, DPRF_PDF_MAX_LEN, L);

        // Algorithm 2: the file key's digest
        uint32_t st[4], d[4];
        md5_compress(iv, m, st);
        md5_compress(st, args.block2, d);
        if (kRev >= 3) {
#pragma unroll 1
            for (int r = 0; r < 50; ++r) {
                uint32_t w[16];
#pragma unroll
                for (int i = 0; i < 16; ++i) w[i] = 0u;
                if (kKeyLen == 16) {
#pragma unroll
                    for (int i = 0; i < 4; ++i) w[i] = d[i];
                    w[4] = 0x80u;
                } else {
                    w[0] = d[0];
                    w[1] = (d[1] & 0xffu) | 0x8000u;
                }
                w[14] = 8 * kKeyLen;
                md5_compress(iv, w, d);
            }
        }

        bool hit = true;
        if (kRev == 2) {
            ksa<kKeyLen>(s, d);
            uint32_t j = 0u, word = 0u;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int i = t + 1;
                RC4_OUT_STEP(s, i, j, si, sj);
                word |= (uint32_t)RC4_AT(s, (si + sj) & 0xffu) << (8 * t);
            }
            hit = word == args.u[0];
        } else {
            uint32_t x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = args.x0[i];
#pragma unroll 1
            for (uint32_t p = 0; p < 20; ++p) {
                uint32_t k[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) k[i] = d[i] ^ (p * 0x01010101u);
                ksa<kKeyLen>(s, k);
                uint32_t j = 0u;
#pragma unroll
                for (int t = 0; t < 16; ++t) {
                    const int i = t + 1;
                    RC4_OUT_STEP(s, i, j, si, sj);
                    x[t >> 2] ^= (uint32_t)RC4_AT(s, (si + sj) & 0xffu)
                                 << (8 * (t & 3));
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) hit &= x[i] == args.u[i];
        }
        if (hit) {
            const int32_t slot = atomicAdd(count, 1);
            if (slot < cap) lanes[slot] = (int32_t)gidx;
        }
    }
}

// ---- the C interface ---------------------------------------------------

// The instantiation of kind id 0 (R2, 40-bit), 1 (R3+, 40-bit) or 2
// (R3+, 128-bit), as ops/cuda_pdf.KINDS numbers them.
typedef void (*PdfKernel)(const uint8_t*, const PdfArgs, uint32_t, int32_t*,
                          int32_t*, int32_t);

static PdfKernel kernel_of(int kind)
{
    switch (kind) {
    case 0: return pdf_kernel<2, 5>;
    case 1: return pdf_kernel<3, 5>;
    case 2: return pdf_kernel<3, 16>;
    default: return nullptr;
    }
}

static cudaError_t raise_smem_limit(PdfKernel k, int smem)
{
    return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

// Dynamic shared memory of one block at `length` positions
// (ops/cuda_pdf.shared_bytes).
static int shared_bytes(int length) { return kRc4Bytes + 256 * length; }

// Launch instantiation `kind` on the caller's stream without
// synchronising; returns the launch's cudaError_t (0 = launched).  count
// must hold 0 and lanes -1 on entry (the wrapper allocates them so).
// `threads` must be kThreads.
extern "C" int dprf_pdf_launch(int kind, int device, const uint8_t* lut,
                               const PdfArgs* args, uint32_t n_valid,
                               int32_t* count, int32_t* lanes, int32_t cap,
                               int grid, int threads, void* stream)
{
    const PdfKernel k = kernel_of(kind);
    if (k == nullptr || threads != kThreads || args->length < 1
        || args->length > DPRF_PDF_MAX_LEN)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int smem = shared_bytes(args->length);
    err = raise_smem_limit(k, smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kThreads, smem, (cudaStream_t)stream>>>(lut, *args, n_valid,
                                                      count, lanes, cap);
    return (int)cudaGetLastError();
}

// Resident blocks of kThreads threads per SM of instantiation `kind` at
// `smem` bytes of dynamic shared memory (the grid's size).
extern "C" int dprf_pdf_blocks_per_sm(int kind, int smem, int* blocks)
{
    const PdfKernel k = kernel_of(kind);
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t err = raise_smem_limit(k, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, k, kThreads, (size_t)smem);
}
