// sevenzip.cu -- the 7-Zip KDF kernel for Hopper (sm_90a): mask decode
// -> SHA-256 over the 2^cycles-unit counter stream salt || UTF-16LE(pw)
// || LE64(i) -> the final padding block -> the 8 key words.
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_7z.py
// (make_7z_kdf_pallas_fn, pl.pallas_call at :134; its body _kdf_lanes).
// Output: out[lane, 0:8], the SHA-256 state words of each valid lane,
// candidate-major, the layout the TPU kernel's wrapper returns.  The
// AES-256-CBC and CRC32 verdict runs after it in torch on the card
// (engines/device/sevenzip.py), as the reference runs its verdict in XLA.
//
// What bounds it: issue slots.  A candidate is 2^cycles * unit / 64 + 1
// compressions (unit = salt + 2 * length + 8 bytes; 196,609 at 7-Zip's
// default cycles 19 for an 8-character password and no salt), each of
// them with all 16 message words and the chaining state variable
// (ops/opcount.sevenzip_ops).  It reads no device memory but its charset
// tables and writes 32 bytes a candidate.
//
// What the design does about it: one thread per candidate in a
// grid-stride loop, the chaining state and the schedule in registers.
// The TPU kernel wires every stream byte at compile time per (salt,
// length); here the salt, its length, the mask length and cycles are
// launch parameters, so one build serves every job.  Each thread keeps a
// window of the stream in shared memory, kWindowBytes bytes: its unit
// image (salt, the widened password, a zero counter) repeated from
// offset 0, in csrc/thread_bytes.cuh's layout: every access of a warp
// is at one offset and no bank conflict arises.  A block of the stream
// that starts at offset o of unit u0 is window bytes [o, o + 64): before
// it, the thread stores the 3 low counter bytes of units u0, u0 + 1, ...
// into the copies the block reaches (cycles <= 24 keeps the rest zero),
// then reads 17 aligned words and funnels them into 16 big-endian message
// words with one byte permute each, whatever o & 3 is: a few dozen
// instructions a block beside the compression's ~1,000.

#include <cstdint>
#include <cuda_runtime.h>

#include "cores.cuh"
#include "decode.cuh"
#include "thread_bytes.cuh"

#define DPRF_7Z_MAX_LEN 27
#define DPRF_7Z_MAX_SALT 16

constexpr int kThreads = 256;
// the longest unit: a 16-byte salt, 27 UTF-16LE characters, the counter
constexpr int kMaxUnit = DPRF_7Z_MAX_SALT + 2 * DPRF_7Z_MAX_LEN + 8;
// a block starts at offset o <= unit - 1 and reads 17 aligned words from
// word o >> 2
constexpr int kWindowWords = ((kMaxUnit - 1) >> 2) + 17;
constexpr int kWindowBytes = 4 * kWindowWords;

// Kernel parameters of one launch (mirrored by ops/cuda_7z._Args).
struct SevenZipArgs {
    int32_t length;
    int32_t radix[DPRF_7Z_MAX_LEN];
    int32_t base[DPRF_7Z_MAX_LEN];
    int32_t salt_len;
    uint8_t salt[DPRF_7Z_MAX_SALT];
    int32_t cycles;
};

__global__ void __launch_bounds__(kThreads)
sevenzip_kernel(const uint8_t* __restrict__ lut, const SevenZipArgs args,
                uint32_t n_valid, uint32_t* __restrict__ out)
{
    // the stream windows, the salt, then the per-position 256-byte
    // charset tables
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* s_salt = smem + kWindowBytes * kThreads;
    uint8_t* s_lut = s_salt + DPRF_7Z_MAX_SALT;
    const int L = args.length;
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    if (threadIdx.x == 0) {
        // constant indices: a parameter array indexed at run time would
        // take a stack frame
#pragma unroll
        for (int i = 0; i < DPRF_7Z_MAX_SALT; ++i) s_salt[i] = args.salt[i];
    }
    __syncthreads();
    uint8_t* win = smem + 4 * threadIdx.x;
    const uint32_t* win32 = reinterpret_cast<const uint32_t*>(win);

    const int sl = args.salt_len;
    const int ctr = sl + 2 * L;            // the counter's offset in a unit
    const int unit = ctr + 8;
    const uint32_t n_blocks =
        (uint32_t)(((uint64_t)unit << args.cycles) >> 6);
    const uint64_t bits = (uint64_t)unit << (args.cycles + 3);
    const int q64 = 64 / unit, r64 = 64 % unit;

    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t gidx = blockIdx.x * blockDim.x + threadIdx.x;
         gidx < n_valid; gidx += stride) {
        // the candidate's bytes, little-endian in m[0..6]
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = 0u;
        uint32_t carry = gidx;
        DPRF_DECODE(Md5Core, DPRF_7Z_MAX_LEN, L);

        // the unit image at offset 0, then its copies to the window's end
        for (int e = 0; e < sl; ++e) THREAD_BYTE_AT(win, e) = s_salt[e];
#pragma unroll
        for (int q = 0; q < DPRF_7Z_MAX_LEN; ++q) {
            if (q < L) {
                const uint32_t byte = m[q >> 2] >> (8 * (q & 3));
                THREAD_BYTE_AT(win, sl + 2 * q) = (uint8_t)byte;
                THREAD_BYTE_AT(win, sl + 2 * q + 1) = 0;
            }
        }
        for (int e = ctr; e < unit; ++e) THREAD_BYTE_AT(win, e) = 0;
        for (int e = unit; e < kWindowBytes; ++e)
            THREAD_BYTE_AT(win, e) = THREAD_BYTE_AT(win, e - unit);

        uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                          0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                          0x1f83d9abu, 0x5be0cd19u};
        uint32_t u0 = 0u;                  // the block's first unit
        int o = 0;                         // and its offset there
#pragma unroll 1
        for (uint32_t blk = 0; blk < n_blocks; ++blk) {
            // the counters of the units that reach into [o, o + 64)
            uint32_t c = u0;
            for (int pos = ctr; pos < o + 64; pos += unit, ++c) {
                THREAD_BYTE_AT(win, pos) = (uint8_t)c;
                THREAD_BYTE_AT(win, pos + 1) = (uint8_t)(c >> 8);
                THREAD_BYTE_AT(win, pos + 2) = (uint8_t)(c >> 16);
            }
            const int a = o >> 2, s = o & 3;
            const uint32_t sel = (s << 12) | ((s + 1) << 8) | ((s + 2) << 4)
                                 | (s + 3);
            uint32_t w[16];
            uint32_t lo = win32[a * kThreads];
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const uint32_t hi = win32[(a + i + 1) * kThreads];
                w[i] = __byte_perm(lo, hi, sel);
                lo = hi;
            }
            sha256_compress(st, w, st);
            o += r64;
            u0 += q64;
            if (o >= unit) {
                o -= unit;
                ++u0;
            }
        }
        // the stream ends on a block boundary: the padding block
        uint32_t w[16];
        w[0] = 0x80000000u;
#pragma unroll
        for (int i = 1; i < 14; ++i) w[i] = 0u;
        w[14] = (uint32_t)(bits >> 32);
        w[15] = (uint32_t)bits;
        sha256_compress(st, w, st);
        uint32_t* row = out + (size_t)gidx * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) row[i] = st[i];
    }
}

// ---- the C interface ---------------------------------------------------

static cudaError_t raise_smem_limit(int smem)
{
    return cudaFuncSetAttribute(sevenzip_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

// Dynamic shared memory of one block at `length` positions
// (ops/cuda_7z.shared_bytes).
static int shared_bytes(int length)
{
    return kWindowBytes * kThreads + DPRF_7Z_MAX_SALT + 256 * length;
}

// Launch over lanes [0, n_valid) on the caller's stream without
// synchronising; out holds n_valid rows of 8 words.  Returns the launch's
// cudaError_t (0 = launched).  The wrapper checks the job (the stream
// tiles into whole blocks); `threads` must be kThreads.
extern "C" int dprf_7z_launch(int device, const uint8_t* lut,
                              const SevenZipArgs* args, uint32_t n_valid,
                              uint32_t* out, int grid, int threads,
                              void* stream)
{
    if (threads != kThreads || args->length < 1
        || args->length > DPRF_7Z_MAX_LEN || args->salt_len < 0
        || args->salt_len > DPRF_7Z_MAX_SALT || args->cycles < 1
        || args->cycles > 24)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int smem = shared_bytes(args->length);
    err = raise_smem_limit(smem);
    if (err != cudaSuccess) return (int)err;
    sevenzip_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        lut, *args, n_valid, out);
    return (int)cudaGetLastError();
}

// Resident blocks of kThreads threads per SM at `smem` bytes of dynamic
// shared memory (the grid's size).
extern "C" int dprf_7z_blocks_per_sm(int smem, int* blocks)
{
    cudaError_t err = raise_smem_limit(smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, sevenzip_kernel, kThreads, (size_t)smem);
}
