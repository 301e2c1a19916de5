// bcrypt.cu -- the EksBlowfish kernels for Hopper (sm_90a): setup, the
// cost loop (advance) and finish, the whole bcrypt chain of a batch of
// candidates whose (P, S) state lives on the card between launches.
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_bcrypt.py
// (_advance_kernel via _advance_call, make_pallas_eks_advance), the
// ChunkedEks `advance`: each candidate's state advanced by a runtime n of
// {ExpandKey(key); ExpandKey(salt)}.  The reference computes the setup
// (eks_setup_begin) and the final 64 x 3 encryptions and compare
// (bcrypt_digest_words, compare_digest_words) as XLA ops; as torch ops
// those would be ~10^5 launches per ExpandKey, so they are kernels here
// too:
//
// - setup: the initial P and S (the hex digits of pi, a table the
//   wrapper uploads once), then the salted ExpandKey(key);
// - advance: n rounds of the cost loop, in place;
// - finish: encrypt "OrpheanBeholderScryDoubt" 64 times, write the six
//   digest words, compare 23 bytes with the target and append the lane
//   of every hit; count > cap sends the batch to the exact rescan.
//
// What bounds it: one Feistel round is 4 data-dependent reads of the
// candidate's 4 KB S-boxes and ~10 integer operations, 68.3 M rounds a
// candidate at cost 12, and the rounds of one candidate form one serial
// chain.  Shared memory serves 32 reads per SM per clock; the issue
// slots, 64 lanes of each pipe per SM per clock; and the chain's
// dependent latency (~25 cycles a read plus the adds) over the few
// chains an SM can hold (ops/opcount.bcrypt_bound reckons all three).
//
// What the design does about it: one thread per candidate, its S in
// shared memory, entry-major and interleaved across the block's threads
// (entry e of thread t at e * 32 + t): a warp's 32 data-dependent reads
// fall in 32 distinct banks whatever the entries are.  4 KB a thread
// makes a block of 32 threads take 128 KB (the opt-in above 48 KB is set
// before the first launch, and a failure to set it is an error), so an
// SM holds one block.  P (18 words), the key and the salt words stay in
// registers; the 16 Feistel rounds and the 9 P-pair writes are unrolled
// so every P index is a compile-time constant, and the 512 S-pair
// writes run two to a loop step, so the salt's alternation is constant
// too.  S moves between device memory and shared memory once per
// launch, coalesced; the state stays on the card between launches.

#include <cstdint>
#include <cuda_runtime.h>

// candidates per block: the bank stride of the interleaved S-boxes
constexpr int kThreads = 32;
constexpr int kSWords = 1024;
constexpr int kPWords = 18;
constexpr size_t kSmem = (size_t)kSWords * kThreads * 4;

struct Salt4 {
    uint32_t w[4];
};

struct Salt18 {
    uint32_t w[kPWords];
};

// The target's six digest words; word 5 keeps its top 24 bits.
struct Target6 {
    uint32_t w[6];
};

// F(x) = ((S0[a] + S1[b]) ^ S2[c]) + S3[d]; s points at the thread's
// entry 0.
__device__ __forceinline__ uint32_t feistel(const uint32_t* s, uint32_t x)
{
    const uint32_t a = s[(x >> 24) * kThreads];
    const uint32_t b = s[(256 + ((x >> 16) & 0xffu)) * kThreads];
    const uint32_t c = s[(512 + ((x >> 8) & 0xffu)) * kThreads];
    const uint32_t d = s[(768 + (x & 0xffu)) * kThreads];
    return ((a + b) ^ c) + d;
}

__device__ __forceinline__ void encrypt(const uint32_t* P, const uint32_t* s,
                                        uint32_t& l, uint32_t& r)
{
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
        l ^= P[i];
        r ^= P[i + 1] ^ feistel(s, l);
        l ^= feistel(s, r);
    }
    const uint32_t t = l;
    l = r ^ P[17];
    r = t ^ P[16];
}

// One ExpandKey: P ^= key, then P and S regenerated by chained
// encryption; kSalt perturbs step n's input with salt words (0, 1) for
// even n and (2, 3) for odd n.
template <bool kSalt>
__device__ __forceinline__ void expand_key(uint32_t* P, uint32_t* s,
                                           const uint32_t* key,
                                           const uint32_t* salt)
{
#pragma unroll
    for (int i = 0; i < kPWords; ++i) P[i] ^= key[i];
    uint32_t l = 0u, r = 0u;
#pragma unroll
    for (int n = 0; n < 9; ++n) {
        if (kSalt) {
            l ^= salt[2 * (n & 1)];
            r ^= salt[2 * (n & 1) + 1];
        }
        encrypt(P, s, l, r);
        P[2 * n] = l;
        P[2 * n + 1] = r;
    }
    // steps 9.. write the S pairs; step 9 + j is odd for even j
#pragma unroll 1
    for (int j = 0; j < kSWords / 2; j += 2) {
        if (kSalt) {
            l ^= salt[2];
            r ^= salt[3];
        }
        encrypt(P, s, l, r);
        s[(2 * j) * kThreads] = l;
        s[(2 * j + 1) * kThreads] = r;
        if (kSalt) {
            l ^= salt[0];
            r ^= salt[1];
        }
        encrypt(P, s, l, r);
        s[(2 * j + 2) * kThreads] = l;
        s[(2 * j + 3) * kThreads] = r;
    }
}

// The block's S rows from device memory into shared memory (coalesced
// reads), entry e of candidate t at e * kThreads + t.
__device__ __forceinline__ void load_s(uint32_t* sm,
                                       const uint32_t* __restrict__ S,
                                       int base, int batch)
{
    for (int i = threadIdx.x; i < kSWords * kThreads; i += kThreads) {
        const int t = i / kSWords, e = i % kSWords;
        if (base + t < batch)
            sm[e * kThreads + t] = S[(size_t)(base + t) * kSWords + e];
    }
    __syncthreads();
}

__device__ __forceinline__ void store_s(const uint32_t* sm,
                                        uint32_t* __restrict__ S,
                                        int base, int batch)
{
    __syncthreads();
    for (int i = threadIdx.x; i < kSWords * kThreads; i += kThreads) {
        const int t = i / kSWords, e = i % kSWords;
        if (base + t < batch)
            S[(size_t)(base + t) * kSWords + e] = sm[e * kThreads + t];
    }
}

__device__ __forceinline__ void load_words(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int c)
{
#pragma unroll
    for (int i = 0; i < kPWords; ++i) dst[i] = src[c * kPWords + i];
}

// init: uint32[18 + 1024], the initial P then S.  Writes P, S.
__global__ void __launch_bounds__(kThreads)
setup_kernel(uint32_t* __restrict__ P, uint32_t* __restrict__ S,
             const uint32_t* __restrict__ key,
             const uint32_t* __restrict__ init, const Salt4 salt, int batch)
{
    extern __shared__ uint32_t sm[];
    for (int i = threadIdx.x; i < kSWords * kThreads; i += kThreads)
        sm[i] = __ldg(init + kPWords + i / kThreads);
    __syncthreads();
    const int base = blockIdx.x * kThreads, c = base + threadIdx.x;
    if (c < batch) {
        uint32_t p[kPWords], k[kPWords], sw[4];
#pragma unroll
        for (int i = 0; i < kPWords; ++i) p[i] = __ldg(init + i);
        load_words(k, key, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) sw[i] = salt.w[i];
        expand_key<true>(p, sm + threadIdx.x, k, sw);
#pragma unroll
        for (int i = 0; i < kPWords; ++i) P[c * kPWords + i] = p[i];
    }
    store_s(sm, S, base, batch);
}

// n rounds of {ExpandKey(key); ExpandKey(salt18)}, P and S in place.
__global__ void __launch_bounds__(kThreads)
advance_kernel(uint32_t* __restrict__ P, uint32_t* __restrict__ S,
               const uint32_t* __restrict__ key, const Salt18 salt18, int n,
               int batch)
{
    extern __shared__ uint32_t sm[];
    const int base = blockIdx.x * kThreads, c = base + threadIdx.x;
    load_s(sm, S, base, batch);
    if (c < batch) {
        uint32_t p[kPWords], k[kPWords], s18[kPWords];
        load_words(p, P, c);
        load_words(k, key, c);
#pragma unroll
        for (int i = 0; i < kPWords; ++i) s18[i] = salt18.w[i];
#pragma unroll 1
        for (int round = 0; round < n; ++round) {
            expand_key<false>(p, sm + threadIdx.x, k, nullptr);
            expand_key<false>(p, sm + threadIdx.x, s18, nullptr);
        }
#pragma unroll
        for (int i = 0; i < kPWords; ++i) P[c * kPWords + i] = p[i];
    }
    store_s(sm, S, base, batch);
}

// The digest words of each candidate (uint32[batch][6]) and the hits: a
// lane counts if c < n_valid and (valid is null or valid[c] != 0).
__global__ void __launch_bounds__(kThreads)
finish_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ S,
              const uint8_t* __restrict__ valid, int n_valid,
              const Target6 target, int batch, uint32_t* __restrict__ digest,
              int32_t* __restrict__ count, int32_t* __restrict__ lanes,
              int32_t cap)
{
    extern __shared__ uint32_t sm[];
    const int base = blockIdx.x * kThreads, c = base + threadIdx.x;
    load_s(sm, S, base, batch);
    if (c >= batch) return;
    uint32_t p[kPWords];
    load_words(p, P, c);
    // "OrpheanBeholderScryDoubt" as six big-endian words
    const uint32_t magic[6] = {0x4f727068u, 0x65616e42u, 0x65686f6cu,
                               0x64657253u, 0x63727944u, 0x6f756274u};
    uint32_t out[6];
#pragma unroll
    for (int b = 0; b < 6; b += 2) {
        uint32_t l = magic[b], r = magic[b + 1];
#pragma unroll 1
        for (int i = 0; i < 64; ++i) encrypt(p, sm + threadIdx.x, l, r);
        out[b] = l;
        out[b + 1] = r;
    }
    bool hit = c < n_valid && (valid == nullptr || valid[c] != 0);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        digest[(size_t)c * 6 + i] = out[i];
        hit &= (i < 5 ? out[i] : out[i] & 0xffffff00u) == target.w[i];
    }
    if (hit) {
        const int32_t slot = atomicAdd(count, 1);
        if (slot < cap) lanes[slot] = c;
    }
}

// ---- the C interface ---------------------------------------------------

// The opt-in to kSmem bytes of dynamic shared memory, once per kernel
// and process; its cudaError_t.
template <class K>
static int opt_in(K kernel)
{
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
}

static int prepare(int device)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    static int rc = -1;
    if (rc < 0) {
        rc = opt_in(setup_kernel);
        if (rc == 0) rc = opt_in(advance_kernel);
        if (rc == 0) rc = opt_in(finish_kernel);
    }
    return rc;
}

static int grid_of(int batch) { return (batch + kThreads - 1) / kThreads; }

// Each launch runs on the caller's stream without synchronising and
// returns the launch's cudaError_t (0 = launched).

extern "C" int dprf_bcrypt_setup(int device, uint32_t* P, uint32_t* S,
                                 const uint32_t* key, const uint32_t* init,
                                 const Salt4* salt, int batch, void* stream)
{
    int rc = prepare(device);
    if (rc != 0) return rc;
    setup_kernel<<<grid_of(batch), kThreads, kSmem, (cudaStream_t)stream>>>(
        P, S, key, init, *salt, batch);
    return (int)cudaGetLastError();
}

extern "C" int dprf_bcrypt_advance(int device, uint32_t* P, uint32_t* S,
                                   const uint32_t* key, const Salt18* salt18,
                                   int n, int batch, void* stream)
{
    int rc = prepare(device);
    if (rc != 0) return rc;
    advance_kernel<<<grid_of(batch), kThreads, kSmem,
                     (cudaStream_t)stream>>>(P, S, key, *salt18, n, batch);
    return (int)cudaGetLastError();
}

// count must hold 0 and lanes -1 on entry (the wrapper allocates them
// so); valid may be null.
extern "C" int dprf_bcrypt_finish(int device, const uint32_t* P,
                                  const uint32_t* S, const uint8_t* valid,
                                  int n_valid, const Target6* target,
                                  int batch, uint32_t* digest,
                                  int32_t* count, int32_t* lanes,
                                  int32_t cap, void* stream)
{
    int rc = prepare(device);
    if (rc != 0) return rc;
    finish_kernel<<<grid_of(batch), kThreads, kSmem,
                    (cudaStream_t)stream>>>(P, S, valid, n_valid, *target,
                                            batch, digest, count, lanes, cap);
    return (int)cudaGetLastError();
}

// Resident blocks per SM of each kernel (0 setup, 1 advance, 2 finish)
// at kSmem bytes of shared memory, after the opt-in; and kSmem.
extern "C" int dprf_bcrypt_blocks_per_sm(int device, int which, int* blocks,
                                         int* smem)
{
    int rc = prepare(device);
    if (rc != 0) return rc;
    *smem = (int)kSmem;
    switch (which) {
    case 0:
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, setup_kernel, kThreads, kSmem);
    case 1:
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, advance_kernel, kThreads, kSmem);
    case 2:
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, finish_kernel, kThreads, kSmem);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
