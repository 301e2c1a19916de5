// pbkdf2.cu -- the PBKDF2-HMAC-SHA1 kernels for Hopper (sm_90a): the
// fused WPA2-PMKID kernel (mask decode -> PBKDF2-HMAC-SHA1 -> PMK ->
// PMKID for every target of one ESSID -> compare) and the generic KDF
// kernel (mask decode -> PBKDF2-HMAC-SHA1 -> the derived key's words),
// the one PBKDF2 body, pbkdf2_block, shared by both.
//
// The KDF kernel (kdf_kernel, the C entry dprf_kdf_launch) replaces the
// TPU kernel make_pbkdf2_kdf_pallas_fn of dprf_tpu/ops/pallas_pbkdf2.py
// (pl.pallas_call at :169, body pbkdf2_lanes): per candidate the key
// states, T1 and, only when n_words > 5, T2, and the first n_words
// big-endian words of T1 || T2 written to out[lane, :n_words] (4 for a
// Kerberos etype-17 key, 8 for etype 18).  The salt (1-51 bytes, its two
// first-message blocks built on the host), the iteration count and
// n_words are launch parameters, so one build serves every target.  It
// is bound by issue slots as the PMKID kernel is (ops/opcount.kdf_ops)
// and writes 4 * n_words bytes a candidate; the verdict of the Kerberos
// AES engines runs on its output in torch (engines/device/krb5aes.py),
// as the reference runs its verdict in XLA after its kernel.
//
// The PMKID kernel replaces the TPU kernel of dprf_tpu/ops/pallas_pbkdf2.py
// (make_pmkid_pallas_fn / pmkid_lanes, and the PBKDF2 body pbkdf2_lanes
// it shares with make_pbkdf2_kdf_pallas_fn).  Per candidate: decode the
// mask index into the passphrase (<= 63 bytes) as one big-endian key
// block with raw zero padding (no 0x80: the HMAC key block is a full
// block); the HMAC inner and outer states (key ^ 0x36.., key ^ 0x5c..);
// two PBKDF2 blocks, each U1 = HMAC(key, ESSID || INT(i)) and then
// iters - 1 HMAC rounds of two compressions over a 20-byte message;
// PMK = T1 || T2[:3]; the PMK's own key states, once; then for each
// target of the launch (one ESSID group) HMAC(PMK, "PMK Name" | AP |
// STA), its first four words compared with the target's PMKID.
//
// The reference has two routes: its Pallas kernel recomputes the PMK
// per target (so a job with more than 8 targets of one ESSID goes to an
// XLA step that computes it once per ESSID).  Here one launch computes
// the PMK once and compares every target of the ESSID group, which is
// what both routes compute, with no routing.  Every hit appends (lane,
// target index in the group); count > cap sends the batch to the
// worker's exact oracle rescan.  The TPU kernel's packed (count << 16)
// | (hit_lane + 1) tile output is Mosaic's and is not carried over.
//
// What bounds it: issue slots.  A candidate at 4096 iterations is
// 16,390 SHA-1 compressions with one target (2 key states, 2 x (2 + 2 x
// 4095) for the PBKDF2 blocks, 2 for the PMK's key states, 2 per
// target) with every message word of the iteration loop variable; it
// reads no device memory but the targets (a few words, cached) and
// writes ~0 bytes.
// ops/opcount.pmkid_ops counts the least instructions per candidate.
//
// What the design does about it: one thread per candidate in a
// grid-stride loop, everything in registers: the key states, U, T and
// the 16-word schedule window (about 45 live words).  The 80 rounds of
// each compression are unrolled, the iteration loop is not; the
// 20-byte blocks' padding words (0x80 marker, zeros, the bit length)
// are constants, so their terms fold.  The ESSID's two first-message
// blocks (built on the host from its bytes), the iteration count and
// n_valid are kernel parameters, and the group's targets a small table
// uploaded once per job, so a launch needs no copy and no sync, and one
// build serves every ESSID length and iteration count.

#include <cstdint>
#include <cuda_runtime.h>

#include "cores.cuh"
#include "decode.cuh"

#define DPRF_PMKID_MAX_LEN 63
// words of one target in the table: the 20-byte message, the PMKID
#define DPRF_PMKID_TARGET_WORDS 9

constexpr int kThreads = 256;

// Kernel parameters of one launch (mirrored by ops/cuda_pbkdf2._Args).
struct PmkidArgs {
    int32_t length;
    int32_t radix[DPRF_PMKID_MAX_LEN];
    int32_t base[DPRF_PMKID_MAX_LEN];
    // ESSID || INT32BE(i) padded as the block after the 64-byte key
    // block, for i = 1, 2 (ops/hmac_sha1.salt_block)
    uint32_t salt[2][16];
    int32_t iters;
    int32_t n_targets;
};

// A 20-byte message as the block that follows a 64-byte key block.
__device__ __forceinline__ void block20(const uint32_t* v, uint32_t* w)
{
#pragma unroll
    for (int i = 0; i < 5; ++i) w[i] = v[i];
    w[5] = 0x80000000u;
#pragma unroll
    for (int i = 6; i < 15; ++i) w[i] = 0u;
    w[15] = (64 + 20) * 8;
}

// HMAC-SHA1 of a 20-byte message from the keyed states; out may alias
// msg.
__device__ __forceinline__ void hmac20(const uint32_t* ist,
                                       const uint32_t* ost,
                                       const uint32_t* msg, uint32_t* out)
{
    uint32_t w[16], inner[5];
    block20(msg, w);
    sha1_compress(ist, w, inner);
    block20(inner, w);
    sha1_compress(ost, w, out);
}

// The HMAC inner and outer states of a one-block key.
__device__ __forceinline__ void key_states(const uint32_t* key,
                                           uint32_t* ist, uint32_t* ost)
{
    const uint32_t iv[5] = {0x67452301u, 0xefcdab89u, 0x98badcfeu,
                            0x10325476u, 0xc3d2e1f0u};
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = key[i] ^ 0x36363636u;
    sha1_compress(iv, w, ist);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = key[i] ^ 0x5c5c5c5cu;
    sha1_compress(iv, w, ost);
}

// One PBKDF2 output block T_i from the key states: U1 = HMAC(key, salt
// || INT(i)), its message the pre-padded block `salt`, then iters - 1
// HMAC rounds over the 20-byte U, t = U1 ^ ... ^ U_iters.
__device__ __forceinline__ void pbkdf2_block(const uint32_t* ist,
                                             const uint32_t* ost,
                                             const uint32_t* salt,
                                             int32_t iters, uint32_t* t)
{
    uint32_t w[16], u[5];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = salt[i];
    sha1_compress(ist, w, u);
    block20(u, w);
    sha1_compress(ost, w, u);
#pragma unroll
    for (int i = 0; i < 5; ++i) t[i] = u[i];
#pragma unroll 1
    for (int j = 1; j < iters; ++j) {
        hmac20(ist, ost, u, u);
#pragma unroll
        for (int i = 0; i < 5; ++i) t[i] ^= u[i];
    }
}

__global__ void __launch_bounds__(kThreads)
pmkid_kernel(const uint8_t* __restrict__ lut, const PmkidArgs args,
             const uint32_t* __restrict__ targets, uint32_t n_valid,
             int32_t* __restrict__ count, int32_t* __restrict__ lanes,
             int32_t* __restrict__ tidx, int32_t cap)
{
    // per-position 256-byte charset tables, uint8[length][256]
    extern __shared__ __align__(16) uint8_t s_lut[];
    const int L = args.length;
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    __syncthreads();

    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t gidx = blockIdx.x * blockDim.x + threadIdx.x;
         gidx < n_valid; gidx += stride) {
        // the passphrase as a raw zero-padded big-endian key block
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = 0u;
        uint32_t carry = gidx;
        DPRF_DECODE(Sha1Core, DPRF_PMKID_MAX_LEN, L);

        uint32_t ist[5], ost[5];
        key_states(m, ist, ost);

        // PMK = T1 || T2[:3]
        uint32_t pmk[16];
#pragma unroll
        for (int blk = 0; blk < 2; ++blk) {
            uint32_t t[5];
            pbkdf2_block(ist, ost, args.salt[blk], args.iters, t);
#pragma unroll
            for (int i = 0; i < 5; ++i)
                if (5 * blk + i < 8) pmk[5 * blk + i] = t[i];
        }
#pragma unroll
        for (int i = 8; i < 16; ++i) pmk[i] = 0u;

        // the PMK's key states, once; then each target of the group
        key_states(pmk, ist, ost);
        for (int k = 0; k < args.n_targets; ++k) {
            const uint32_t* tg = targets + k * DPRF_PMKID_TARGET_WORDS;
            uint32_t msg[5];
#pragma unroll
            for (int i = 0; i < 5; ++i) msg[i] = __ldg(tg + i);
            hmac20(ist, ost, msg, msg);
            bool hit = true;
#pragma unroll
            for (int i = 0; i < 4; ++i) hit &= msg[i] == __ldg(tg + 5 + i);
            if (hit) {
                const int32_t slot = atomicAdd(count, 1);
                if (slot < cap) {
                    lanes[slot] = (int32_t)gidx;
                    tidx[slot] = k;
                }
            }
        }
    }
}

// Kernel parameters of one KDF launch (mirrored by ops/cuda_pbkdf2.
// _KdfArgs).
struct KdfArgs {
    int32_t length;
    int32_t radix[DPRF_PMKID_MAX_LEN];
    int32_t base[DPRF_PMKID_MAX_LEN];
    // salt || INT32BE(i) padded as the block after the 64-byte key
    // block, for i = 1, 2
    uint32_t salt[2][16];
    int32_t iters;
    int32_t n_words;
};

__global__ void __launch_bounds__(kThreads)
kdf_kernel(const uint8_t* __restrict__ lut, const KdfArgs args,
           uint32_t n_valid, uint32_t* __restrict__ out)
{
    extern __shared__ __align__(16) uint8_t s_lut[];
    const int L = args.length;
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    __syncthreads();

    const int n = args.n_words;
    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t gidx = blockIdx.x * blockDim.x + threadIdx.x;
         gidx < n_valid; gidx += stride) {
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = 0u;
        uint32_t carry = gidx;
        DPRF_DECODE(Sha1Core, DPRF_PMKID_MAX_LEN, L);

        uint32_t ist[5], ost[5], t[5];
        key_states(m, ist, ost);
        uint32_t* row = out + (size_t)gidx * n;
        pbkdf2_block(ist, ost, args.salt[0], args.iters, t);
#pragma unroll
        for (int i = 0; i < 5; ++i)
            if (i < n) row[i] = t[i];
        if (n > 5) {
            pbkdf2_block(ist, ost, args.salt[1], args.iters, t);
#pragma unroll
            for (int i = 0; i < 5; ++i)
                if (5 + i < n) row[5 + i] = t[i];
        }
    }
}

// ---- the C interface ---------------------------------------------------

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  count must hold 0 and lanes,
// tidx -1 on entry (the wrapper allocates them so).  `threads` must be
// kThreads.
extern "C" int dprf_pmkid_launch(int device, const uint8_t* lut,
                                 const PmkidArgs* args,
                                 const uint32_t* targets, uint32_t n_valid,
                                 int32_t* count, int32_t* lanes,
                                 int32_t* tidx, int32_t cap, int grid,
                                 int threads, void* stream)
{
    if (threads != kThreads) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)args->length * 256;
    pmkid_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        lut, *args, targets, n_valid, count, lanes, tidx, cap);
    return (int)cudaGetLastError();
}

// Resident blocks of kThreads threads per SM at `smem` bytes of dynamic
// shared memory (the grid's size).
extern "C" int dprf_pmkid_blocks_per_sm(int smem, int* blocks)
{
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, pmkid_kernel, kThreads, (size_t)smem);
}

// Launch the KDF kernel over lanes [0, n_valid) on the caller's stream
// without synchronising; out holds n_valid rows of n_words words.
// Returns the launch's cudaError_t.  `threads` must be kThreads.
extern "C" int dprf_kdf_launch(int device, const uint8_t* lut,
                               const KdfArgs* args, uint32_t n_valid,
                               uint32_t* out, int grid, int threads,
                               void* stream)
{
    if (threads != kThreads || args->n_words < 1 || args->n_words > 10)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)args->length * 256;
    kdf_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        lut, *args, n_valid, out);
    return (int)cudaGetLastError();
}

// Resident blocks of the KDF kernel per SM at `smem` bytes.
extern "C" int dprf_kdf_blocks_per_sm(int smem, int* blocks)
{
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kdf_kernel, kThreads, (size_t)smem);
}
