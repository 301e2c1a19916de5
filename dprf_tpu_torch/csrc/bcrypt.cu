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
// shared memory, entry-major and interleaved across the candidates of
// one warp: entry e of a warp's lane t at word e * n + t of the warp's
// region, n the candidates the warp holds.  A warp holds 16 (or 8), so
// its data-dependent reads of one S-box fall in distinct banks whatever
// the entries are (entry e of lane t sits in bank t + 16 * (e & 1), or
// t + 8 * (e & 3)).  4 KB a candidate: a block of four warps holds 16 +
// 16 + 16 + 8 = 56 candidates in 224 KB, the most an SM's 228 KB take
// (the opt-in above 48 KB is set before the first launch, and a
// failure to set it is an error), one warp on each of the SM's four
// schedulers: a wave of 7,392 candidates on a 132-SM H100, where a
// block of 32 candidates (128 KB) left room for one, 32 chains.  (A
// block of one warp of 16, three an SM, 48 chains, and one of 14, four
// an SM, a stride that can conflict, were both slower: PERF.md, row 7.)
//
// The round is cut to a short dependent chain.  The encryption is the
// sequence x[n + 1] = x[n - 1] ^ P[n] ^ F(x[n]), and x[n - 1] ^ P[n] is
// known a half-round early, so with a power-of-two stride (16 and 8
// are) each read's byte offset, ((x >> 8k) & 0xff) * 4n + 4t + the
// S-box's base, is formed as (F's sum shifted and masked) ^ (the early
// word shifted and masked, ORed with 4t and the base): per S-box read
// one shift and one LOP3 after F's last add, then the read.  The chain
// from one F to the next is shift, LOP3, shared read, add, xor, add;
// the xor with the early word runs beside it.  P (18 words), the key
// and the salt words stay in registers; the 16 Feistel rounds and the 9
// P-pair writes are unrolled so every P index is a compile-time
// constant, and the 512 S-pair writes run two to a loop step, so the
// salt's alternation is constant too.  S moves between device memory
// and shared memory once per launch, coalesced; the state stays on the
// card between launches.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

// the block: kWarps warps, the first kWarps - 1 holding kLanes
// candidates each, the last kLast
constexpr int kWarps = 4;
constexpr int kLanes = 16;
constexpr int kLast = 8;
constexpr int kCands = (kWarps - 1) * kLanes + kLast;
constexpr int kThreads = 32 * kWarps;
constexpr int kSWords = 1024;
constexpr int kPWords = 18;
constexpr size_t kSmem = (size_t)kSWords * kCands * 4;
__host__ __device__ constexpr int log2_of(uint32_t x)
{
    return x > 1 ? 1 + log2_of(x >> 1) : 0;
}
static_assert(kLanes <= 32 && kLast <= kLanes, "a warp holds <= 32");
static_assert((kLanes & (kLanes - 1)) == 0 && (kLast & (kLast - 1)) == 0,
              "the offsets' pieces need power-of-two strides");

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

// A candidate's place in the block's shared memory: its warp's region,
// the warp's stride (the candidates it holds), its lane.
struct Slot {
    int cand, stride, lane;
    uint32_t region;
};

__host__ __device__ constexpr Slot slot_of_cand(int t)
{
    const int warp = t / kLanes < kWarps - 1 ? t / kLanes : kWarps - 1;
    return {t, warp < kWarps - 1 ? kLanes : kLast, t - warp * kLanes,
            (uint32_t)(warp * kLanes * kSWords * 4)};
}

// The slot of the thread tid, and whether it holds a candidate.
__device__ __forceinline__ Slot slot_of_thread(int tid, bool& active)
{
    const int warp = tid >> 5, lane = tid & 31;
    const int stride = warp < kWarps - 1 ? kLanes : kLast;
    active = lane < stride;
    return {warp * kLanes + lane, stride, lane,
            (uint32_t)(warp * kLanes * kSWords * 4)};
}

__device__ __forceinline__ int word_of(const Slot& sl, int e)
{
    return (int)(sl.region / 4) + e * sl.stride + sl.lane;
}

// What a thread's Feistel rounds read, for a warp of kStride
// candidates: the block's shared memory and the offsets' pieces.
// base[k] is the thread's entry 0 of S-box 3 - k (its warp's region +
// the S-box's base + 4 t); in a power-of-two layout their bits and a
// byte's scaled bits never overlap, so the offset of byte k of x is
// scaled(x, k) | base[k].  The stride is a template argument, so every
// shift and mask is an immediate.
template <int kStride>
struct Rows {
    static constexpr uint32_t kRow = 4u * kStride;
    static constexpr int kLog2 = log2_of(kRow);
    static constexpr uint32_t kMask = 0xffu << kLog2;
    const uint8_t* s;
    uint32_t base[4];

    __device__ __forceinline__ Rows(const uint32_t* sm, const Slot& sl)
        : s(reinterpret_cast<const uint8_t*>(sm))
    {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            base[k] = sl.region + (3 - k) * 256 * kRow + 4u * sl.lane;
    }

    // byte k of x (k = 0 the least significant) times the row: one
    // shift and the mask
    __device__ __forceinline__ static uint32_t scaled(uint32_t x, int k)
    {
        return (k == 0 ? x << kLog2 : x >> (8 * k - kLog2)) & kMask;
    }

    __device__ __forceinline__ uint32_t load(uint32_t off) const
    {
        return *reinterpret_cast<const uint32_t*>(s + off);
    }

    // F(x) = ((S0[b3] + S1[b2]) ^ S2[b1]) + S3[b0] for x = e ^ y:
    // q[k] = scaled(e, k) | base[k], so each read's offset is
    // scaled(y, k) ^ q[k]
    __device__ __forceinline__ uint32_t feistel(uint32_t y,
                                                const uint32_t* q) const
    {
        const uint32_t a = load(scaled(y, 3) ^ q[3]);
        const uint32_t b = load(scaled(y, 2) ^ q[2]);
        const uint32_t c = load(scaled(y, 1) ^ q[1]);
        const uint32_t d = load(scaled(y, 0) ^ q[0]);
        return ((a + b) ^ c) + d;
    }
};

// Call f with the thread's warp stride as a compile-time constant (a
// warp-uniform branch).
template <class F>
__device__ __forceinline__ void by_stride(int stride, F&& f)
{
    if (stride == kLanes)
        f(std::integral_constant<int, kLanes>{});
    else
        f(std::integral_constant<int, kLast>{});
}

// One Blowfish encryption of (l, r): x[0] = r, x[1] = l ^ P[0],
// x[n + 1] = x[n - 1] ^ P[n] ^ F(x[n]) for n = 1..16, out (x[16] ^
// P[17], x[17]).
template <int kStride>
__device__ __forceinline__ void encrypt(const uint32_t* P,
                                        const Rows<kStride>& rows,
                                        uint32_t& l, uint32_t& r)
{
    using R = Rows<kStride>;
    uint32_t prev = r, cur = l ^ P[0];
    // x[n] = e ^ y, the split the next F reads (e = 0 for x[1])
    uint32_t y = cur;
    uint32_t q[4] = {rows.base[0], rows.base[1], rows.base[2], rows.base[3]};
#pragma unroll
    for (int n = 1; n <= 16; ++n) {
        const uint32_t f = rows.feistel(y, q);
        const uint32_t e = prev ^ P[n];
        prev = cur;
        cur = e ^ f;
        y = f;
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = R::scaled(e, k) | rows.base[k];
    }
    l = prev ^ P[17];
    r = cur;
}

// One ExpandKey: P ^= key, then P and S regenerated by chained
// encryption; kSalt perturbs step n's input with salt words (0, 1) for
// even n and (2, 3) for odd n.  s: the thread's entry 0.
template <bool kSalt, int kStride>
__device__ __forceinline__ void expand_key(uint32_t* P,
                                           const Rows<kStride>& rows,
                                           uint32_t* s, const uint32_t* key,
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
        encrypt(P, rows, l, r);
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
        encrypt(P, rows, l, r);
        s[(2 * j) * kStride] = l;
        s[(2 * j + 1) * kStride] = r;
        if (kSalt) {
            l ^= salt[0];
            r ^= salt[1];
        }
        encrypt(P, rows, l, r);
        s[(2 * j + 2) * kStride] = l;
        s[(2 * j + 3) * kStride] = r;
    }
}

// The block's S rows from device memory into shared memory (coalesced
// reads), entry e of candidate t at word_of(slot_of_cand(t), e).
__device__ __forceinline__ void load_s(uint32_t* sm,
                                       const uint32_t* __restrict__ S,
                                       int base, int batch)
{
    for (int i = threadIdx.x; i < kSWords * kCands; i += kThreads) {
        const int t = i / kSWords, e = i % kSWords;
        if (base + t < batch)
            sm[word_of(slot_of_cand(t), e)] =
                S[(size_t)(base + t) * kSWords + e];
    }
    __syncthreads();
}

__device__ __forceinline__ void store_s(const uint32_t* sm,
                                        uint32_t* __restrict__ S,
                                        int base, int batch)
{
    __syncthreads();
    for (int i = threadIdx.x; i < kSWords * kCands; i += kThreads) {
        const int t = i / kSWords, e = i % kSWords;
        if (base + t < batch)
            S[(size_t)(base + t) * kSWords + e] =
                sm[word_of(slot_of_cand(t), e)];
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
    for (int i = threadIdx.x; i < kSWords * kCands; i += kThreads)
        sm[word_of(slot_of_cand(i / kSWords), i % kSWords)] =
            __ldg(init + kPWords + i % kSWords);
    __syncthreads();
    bool active;
    const Slot sl = slot_of_thread(threadIdx.x, active);
    const int base = blockIdx.x * kCands, c = base + sl.cand;
    if (active && c < batch) {
        uint32_t p[kPWords], k[kPWords], sw[4];
#pragma unroll
        for (int i = 0; i < kPWords; ++i) p[i] = __ldg(init + i);
        load_words(k, key, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) sw[i] = salt.w[i];
        by_stride(sl.stride, [&](auto st) {
            constexpr int kStride = decltype(st)::value;
            expand_key<true>(p, Rows<kStride>(sm, sl), sm + word_of(sl, 0),
                             k, sw);
        });
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
    bool active;
    const Slot sl = slot_of_thread(threadIdx.x, active);
    const int base = blockIdx.x * kCands, c = base + sl.cand;
    load_s(sm, S, base, batch);
    if (active && c < batch) {
        uint32_t p[kPWords], k[kPWords], s18[kPWords];
        load_words(p, P, c);
        load_words(k, key, c);
#pragma unroll
        for (int i = 0; i < kPWords; ++i) s18[i] = salt18.w[i];
        uint32_t* s = sm + word_of(sl, 0);
        by_stride(sl.stride, [&](auto st) {
            const Rows<decltype(st)::value> rows(sm, sl);
#pragma unroll 1
            for (int round = 0; round < n; ++round) {
                expand_key<false>(p, rows, s, k, nullptr);
                expand_key<false>(p, rows, s, s18, nullptr);
            }
        });
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
    bool active;
    const Slot sl = slot_of_thread(threadIdx.x, active);
    const int base = blockIdx.x * kCands, c = base + sl.cand;
    load_s(sm, S, base, batch);
    if (!active || c >= batch) return;
    uint32_t p[kPWords];
    load_words(p, P, c);
    // "OrpheanBeholderScryDoubt" as six big-endian words
    const uint32_t magic[6] = {0x4f727068u, 0x65616e42u, 0x65686f6cu,
                               0x64657253u, 0x63727944u, 0x6f756274u};
    uint32_t out[6];
    by_stride(sl.stride, [&](auto st) {
        const Rows<decltype(st)::value> rows(sm, sl);
#pragma unroll
        for (int b = 0; b < 6; b += 2) {
            uint32_t l = magic[b], r = magic[b + 1];
#pragma unroll 1
            for (int i = 0; i < 64; ++i) encrypt(p, rows, l, r);
            out[b] = l;
            out[b + 1] = r;
        }
    });
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

static int grid_of(int batch) { return (batch + kCands - 1) / kCands; }

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

// The candidates a block takes (ops/cuda_bcrypt.BLOCK).
extern "C" int dprf_bcrypt_block() { return kCands; }

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
