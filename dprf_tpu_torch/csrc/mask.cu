// mask.cu -- the fused mask -> hash -> compare kernel for Hopper (sm_90a).
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_mask.py
// (make_mask_pallas_fn / _build_kernel_body) for the md5, md4 (ntlm),
// sha1 and sha256 cores, with one target or with the multi-target Bloom
// compare, without the window offset.  Per candidate: decode the
// mixed-radix keyspace index into charset bytes, place them in one
// padded 64-byte block (little-endian for md5/md4, big-endian for SHA,
// UTF-16LE widened for ntlm), run the compression rounds and the
// feed-forward, compare.  The TPU kernel's (8, 128) packed
// (count << 16) | (hit_lane + 1) output and its one-lane-per-tile rule
// exist only for Mosaic and are not carried over: every hit appends its
// lane here.
//
// Multi-target compare: the reference's Bloom prefilter, bit for bit
// (bloom_tables / bloom_found: 8 probes of 12 digest bits per set of
// 1024 targets), then an exact verify of each survivor on the card.  The
// reference leaves every maybe to a host oracle hash; at 1,000 targets
// and a batch of 2^24 that is ~81 false maybes a launch, so here each
// maybe binary-searches digest word 0 in the sorted target table
// (ops/compare.make_target_table's layout, in device memory, small
// enough to stay in L2), walks the run of equal word-0 entries and
// compares whole digests.  Only real hits are appended, with their
// table position; n_maybe counts the prefilter's survivors.
//
// What bounds it: the INT32 issue rate, not memory.  A candidate reads
// no device memory (charset table and Bloom rows sit in shared memory;
// base digits, radices, the fixed message words and the target are
// kernel parameters) and writes ~0 bytes.  ops/opcount.py counts the
// least instructions per candidate in Hopper's forms, by pipe.
//
// What the design does about it: one thread per candidate in a
// grid-stride loop, everything in registers.  The rounds are fully
// unrolled (the SHA schedules as a rolling 16-word window), so message
// words, constants and shift counts are register or immediate operands.
// The decode enters an unrolled run of positions through one
// warp-uniform switch on the mask length, so only the mask's own
// positions cost instructions; the byte placement of each position is
// a compile-time constant of the core.  The Bloom probes are tested in
// order and stop at the first miss (Hopper can branch; the TPU tested
// all 8), which costs ~1.3 probes per set at config 2's fill.

#include <cstdint>
#include <cuda_runtime.h>

#define DPRF_MAX_LEN 55
#define DPRF_K_PROBES 8

// Kernel parameters of one job (mirrored by ops/cuda_mask._MaskArgs).
struct MaskArgs {
    int32_t length;
    int32_t radix[DPRF_MAX_LEN];
    int32_t base[DPRF_MAX_LEN];
    // the job's fixed message words: the 0x80 marker and the bit length,
    // zero wherever a candidate byte goes
    uint32_t block[16];
    // the single target's digest words (unused by the multi compare)
    uint32_t target[8];
};

// The multi-target state (mirrored by ops/cuda_mask._MultiArgs).
struct MultiArgs {
    const uint32_t* bloom;    // uint32[n_sets * 8][128], bloom_tables
    const uint32_t* table;    // uint32[n_targets][words], sorted
    int32_t n_sets;
    int32_t n_targets;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n)
{
    return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n)
{
    return __funnelshift_r(x, x, n);
}

// floor(abs(sin(i + 1)) * 2^32), RFC 1321; ops/md5.K computes the same
// table from math.sin and a test holds them equal.
__constant__ uint32_t K_MD5[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu,
    0xf57c0fafu, 0x4787c62au, 0xa8304613u, 0xfd469501u,
    0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u,
    0xf61e2562u, 0xc040b340u, 0x265e5a51u, 0xe9b6c7aau,
    0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu,
    0xa9e3e905u, 0xfcefa3f8u, 0x676f02d9u, 0x8d2a4c8au,
    0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u,
    0x289b7ec6u, 0xeaa127fau, 0xd4ef3085u, 0x04881d05u,
    0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u,
    0x655b59c3u, 0x8f0ccc92u, 0xffeff47du, 0x85845dd1u,
    0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u,
};

// the fractional cube roots of the first 64 primes, FIPS 180-4;
// ops/sha256.K computes the same table and a test holds them equal.
__constant__ uint32_t K_SHA256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
    0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
    0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
    0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u,
    0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u,
    0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// ---- the cores: byte placement, digest words, rounds -----------------
//
// word(q) / shift(q): where candidate byte q goes in the message words.
// They are called with compile-time q only, so they fold away.

struct Md5Core {
    static constexpr int kWords = 4;
    static constexpr int kMaxLen = 55;
    __host__ __device__ static constexpr int word(int q) { return q >> 2; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 8 * (q & 3);
    }

    __device__ __forceinline__ static void digest(uint32_t* m,
                                                  uint32_t* out)
    {
        const int S[4][4] = {{7, 12, 17, 22}, {5, 9, 14, 20},
                             {4, 11, 16, 23}, {6, 10, 15, 21}};
        uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu,
                 d = 0x10325476u;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            uint32_t f;
            int g;
            if (i < 16) {
                f = d ^ (b & (c ^ d));        // (b & c) | (~b & d)
                g = i;
            } else if (i < 32) {
                f = c ^ (d & (b ^ c));        // (d & b) | (~d & c)
                g = (5 * i + 1) & 15;
            } else if (i < 48) {
                f = b ^ c ^ d;
                g = (3 * i + 5) & 15;
            } else {
                f = c ^ (b | ~d);
                g = (7 * i) & 15;
            }
            const uint32_t tmp = a + f + K_MD5[i] + m[g];
            a = d;
            d = c;
            c = b;
            b = b + rotl(tmp, S[i >> 4][i & 3]);
        }
        out[0] = a + 0x67452301u;
        out[1] = b + 0xefcdab89u;
        out[2] = c + 0x98badcfeu;
        out[3] = d + 0x10325476u;
    }
};

// NTLM: MD4 over the UTF-16LE candidate, so byte q is message byte 2q.
struct Md4Core {
    static constexpr int kWords = 4;
    static constexpr int kMaxLen = 27;
    __host__ __device__ static constexpr int word(int q) { return q >> 1; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 16 * (q & 1);
    }

    __device__ __forceinline__ static void digest(uint32_t* m,
                                                  uint32_t* out)
    {
        const int R2[16] = {0, 4, 8, 12, 1, 5, 9, 13,
                            2, 6, 10, 14, 3, 7, 11, 15};
        const int R3[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                            1, 9, 5, 13, 3, 11, 7, 15};
        const int S[3][4] = {{3, 7, 11, 19}, {3, 5, 9, 13},
                             {3, 9, 11, 15}};
        uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu,
                 d = 0x10325476u;
#pragma unroll
        for (int i = 0; i < 48; ++i) {
            const int j = i & 15;
            uint32_t f, k;
            int g;
            if (i < 16) {
                f = d ^ (b & (c ^ d));
                g = j;
                k = 0u;
            } else if (i < 32) {
                f = (b & c) | (d & (b | c));  // majority
                g = R2[j];
                k = 0x5a827999u;
            } else {
                f = b ^ c ^ d;
                g = R3[j];
                k = 0x6ed9eba1u;
            }
            const uint32_t tmp = rotl(a + f + m[g] + k, S[i >> 4][j & 3]);
            a = d;
            d = c;
            c = b;
            b = tmp;
        }
        out[0] = a + 0x67452301u;
        out[1] = b + 0xefcdab89u;
        out[2] = c + 0x98badcfeu;
        out[3] = d + 0x10325476u;
    }
};

struct Sha1Core {
    static constexpr int kWords = 5;
    static constexpr int kMaxLen = 55;
    __host__ __device__ static constexpr int word(int q) { return q >> 2; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 8 * (3 - (q & 3));
    }

    __device__ __forceinline__ static void digest(uint32_t* w,
                                                  uint32_t* out)
    {
        uint32_t a = 0x67452301u, b = 0xefcdab89u, c = 0x98badcfeu,
                 d = 0x10325476u, e = 0xc3d2e1f0u;
#pragma unroll
        for (int t = 0; t < 80; ++t) {
            if (t >= 16) {
                const uint32_t x = w[(t - 3) & 15] ^ w[(t - 8) & 15]
                                   ^ w[(t - 14) & 15] ^ w[t & 15];
                w[t & 15] = rotl(x, 1);
            }
            uint32_t f, k;
            if (t < 20) {
                f = d ^ (b & (c ^ d));
                k = 0x5a827999u;
            } else if (t < 40) {
                f = b ^ c ^ d;
                k = 0x6ed9eba1u;
            } else if (t < 60) {
                f = (b & c) | (d & (b | c));
                k = 0x8f1bbcdcu;
            } else {
                f = b ^ c ^ d;
                k = 0xca62c1d6u;
            }
            const uint32_t tmp = rotl(a, 5) + f + e + k + w[t & 15];
            e = d;
            d = c;
            c = rotl(b, 30);
            b = a;
            a = tmp;
        }
        out[0] = a + 0x67452301u;
        out[1] = b + 0xefcdab89u;
        out[2] = c + 0x98badcfeu;
        out[3] = d + 0x10325476u;
        out[4] = e + 0xc3d2e1f0u;
    }
};

struct Sha256Core {
    static constexpr int kWords = 8;
    static constexpr int kMaxLen = 55;
    __host__ __device__ static constexpr int word(int q) { return q >> 2; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 8 * (3 - (q & 3));
    }

    __device__ __forceinline__ static void digest(uint32_t* w,
                                                  uint32_t* out)
    {
        const uint32_t H[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                               0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                               0x1f83d9abu, 0x5be0cd19u};
        uint32_t a = H[0], b = H[1], c = H[2], d = H[3], e = H[4],
                 f = H[5], g = H[6], h = H[7];
#pragma unroll
        for (int t = 0; t < 64; ++t) {
            if (t >= 16) {
                const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
                const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
                const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
                w[t & 15] += s0 + w[(t - 7) & 15] + s1;
            }
            const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25))
                                + (g ^ (e & (f ^ g))) + K_SHA256[t]
                                + w[t & 15];
            const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22))
                                + ((a & b) | (c & (a | b)));
            h = g;
            g = f;
            f = e;
            e = d + t1;
            d = c;
            c = b;
            b = a;
            a = t1 + t2;
        }
        out[0] = a + H[0];
        out[1] = b + H[1];
        out[2] = c + H[2];
        out[3] = d + H[3];
        out[4] = e + H[4];
        out[5] = f + H[5];
        out[6] = g + H[6];
        out[7] = h + H[7];
    }
};

// ---- the multi-target compare ----------------------------------------

// The reference's bloom_found for one lane: all 8 probes of any set.
__device__ __forceinline__ bool bloom_maybe(const uint32_t* dg,
                                            const uint32_t* s_bloom,
                                            int n_sets)
{
    uint32_t bits[DPRF_K_PROBES];
#pragma unroll
    for (int p = 0; p < DPRF_K_PROBES; ++p) {
        const int j = (12 * p) >> 5, sh = (12 * p) & 31;
        uint32_t v = dg[j] >> sh;
        if (sh > 20) v |= dg[j + 1] << (32 - sh);
        bits[p] = v & 0xfffu;
    }
    for (int s = 0; s < n_sets; ++s) {
        const uint32_t* rows = s_bloom + s * DPRF_K_PROBES * 128;
        bool pass = true;
#pragma unroll
        for (int p = 0; p < DPRF_K_PROBES; ++p) {
            if (!((rows[p * 128 + (bits[p] >> 5)] >> (bits[p] & 31)) & 1u)) {
                pass = false;
                break;
            }
        }
        if (pass) return true;
    }
    return false;
}

// Position of the digest in the sorted table, or -1: the lower bound of
// word 0, then the run of equal word-0 entries compared in full.
template <int W>
__device__ __forceinline__ int find_target(const uint32_t* dg,
                                           const uint32_t* __restrict__ table,
                                           int n)
{
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (table[mid * W] < dg[0]) lo = mid + 1;
        else hi = mid;
    }
    for (int i = lo; i < n && table[i * W] == dg[0]; ++i) {
        bool eq = true;
#pragma unroll
        for (int k = 1; k < W; ++k) eq &= table[i * W + k] == dg[k];
        if (eq) return i;
    }
    return -1;
}

// ---- the kernel --------------------------------------------------------

// One mask position q (a compile-time constant): digit = (base + carry)
// mod radix, carry = (base + carry) div radix, and the charset byte goes
// to the core's place for byte q.
#define DPRF_POS(q)                                                       \
    {                                                                     \
        const uint32_t s = (uint32_t)args.base[q] + carry;                \
        const uint32_t r = (uint32_t)args.radix[q];                       \
        carry = s / r;                                                    \
        const uint32_t digit = s - carry * r;                             \
        m[Core::word(q)] |= (uint32_t)s_lut[(q) * 256 + digit]            \
                            << Core::shift(q);                            \
    }

template <class Core, bool kMulti>
__global__ void __launch_bounds__(256)
mask_kernel(const uint8_t* __restrict__ lut, const MaskArgs args,
            const MultiArgs multi, uint32_t n_valid,
            int32_t* __restrict__ count, int32_t* __restrict__ lanes,
            int32_t* __restrict__ tpos, int32_t* __restrict__ n_maybe,
            int32_t cap)
{
    // per-position 256-byte charset tables, uint8[length][256], then
    // (multi) the Bloom rows; length * 256 keeps the rows word-aligned
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* s_lut = smem;
    const int L = args.length;
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    uint32_t* s_bloom = reinterpret_cast<uint32_t*>(smem + L * 256);
    if constexpr (kMulti) {
        const int n = multi.n_sets * DPRF_K_PROBES * 128;
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            s_bloom[i] = multi.bloom[i];
    }
    __syncthreads();

    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t gidx = blockIdx.x * blockDim.x + threadIdx.x;
         gidx < n_valid; gidx += stride) {
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = args.block[i];

        // decode, last (least significant) position first; the switch
        // enters the unrolled run at position L - 1
        uint32_t carry = gidx;
        if constexpr (Core::kMaxLen > 27) {
            switch (L) {
            case 55: DPRF_POS(54)  case 54: DPRF_POS(53)  case 53: DPRF_POS(52)
            case 52: DPRF_POS(51)  case 51: DPRF_POS(50)  case 50: DPRF_POS(49)
            case 49: DPRF_POS(48)  case 48: DPRF_POS(47)  case 47: DPRF_POS(46)
            case 46: DPRF_POS(45)  case 45: DPRF_POS(44)  case 44: DPRF_POS(43)
            case 43: DPRF_POS(42)  case 42: DPRF_POS(41)  case 41: DPRF_POS(40)
            case 40: DPRF_POS(39)  case 39: DPRF_POS(38)  case 38: DPRF_POS(37)
            case 37: DPRF_POS(36)  case 36: DPRF_POS(35)  case 35: DPRF_POS(34)
            case 34: DPRF_POS(33)  case 33: DPRF_POS(32)  case 32: DPRF_POS(31)
            case 31: DPRF_POS(30)  case 30: DPRF_POS(29)  case 29: DPRF_POS(28)
            case 28: DPRF_POS(27)
            default: break;
            }
        }
        // positions 26..0 (all of an ntlm mask)
        switch (L < 27 ? L : 27) {
        case 27: DPRF_POS(26)  case 26: DPRF_POS(25)  case 25: DPRF_POS(24)
        case 24: DPRF_POS(23)  case 23: DPRF_POS(22)  case 22: DPRF_POS(21)
        case 21: DPRF_POS(20)  case 20: DPRF_POS(19)  case 19: DPRF_POS(18)
        case 18: DPRF_POS(17)  case 17: DPRF_POS(16)  case 16: DPRF_POS(15)
        case 15: DPRF_POS(14)  case 14: DPRF_POS(13)  case 13: DPRF_POS(12)
        case 12: DPRF_POS(11)  case 11: DPRF_POS(10)  case 10: DPRF_POS(9)
        case 9: DPRF_POS(8)    case 8: DPRF_POS(7)    case 7: DPRF_POS(6)
        case 6: DPRF_POS(5)    case 5: DPRF_POS(4)    case 4: DPRF_POS(3)
        case 3: DPRF_POS(2)    case 2: DPRF_POS(1)    case 1: DPRF_POS(0)
        default: break;
        }

        uint32_t dg[Core::kWords];
        Core::digest(m, dg);

        if constexpr (!kMulti) {
            bool hit = true;
#pragma unroll
            for (int i = 0; i < Core::kWords; ++i)
                hit &= dg[i] == args.target[i];
            if (hit) {
                const int32_t slot = atomicAdd(count, 1);
                if (slot < cap) lanes[slot] = (int32_t)gidx;
            }
        } else if (bloom_maybe(dg, s_bloom, multi.n_sets)) {
            atomicAdd(n_maybe, 1);
            const int pos = find_target<Core::kWords>(dg, multi.table,
                                                      multi.n_targets);
            if (pos >= 0) {
                const int32_t slot = atomicAdd(count, 1);
                if (slot < cap) {
                    lanes[slot] = (int32_t)gidx;
                    tpos[slot] = pos;
                }
            }
        }
    }
}

// ---- the C interface ---------------------------------------------------

template <class Core, bool kMulti>
static int launch(const uint8_t* lut, const MaskArgs* args,
                  const MultiArgs* multi, uint32_t n_valid, int32_t* count,
                  int32_t* lanes, int32_t* tpos, int32_t* n_maybe,
                  int32_t cap, int grid, int threads, size_t smem,
                  cudaStream_t stream)
{
    mask_kernel<Core, kMulti><<<grid, threads, smem, stream>>>(
        lut, *args, *multi, n_valid, count, lanes, tpos, n_maybe, cap);
    return (int)cudaGetLastError();
}

template <class Core, bool kMulti>
static int occupancy(int threads, size_t smem, int* blocks)
{
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, mask_kernel<Core, kMulti>, threads, smem);
}

// core ids: 0 md5, 1 md4 (ntlm), 2 sha1, 3 sha256
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
    default: return (int)cudaErrorInvalidValue;                           \
    }

static size_t shared_bytes(const MaskArgs* args, const MultiArgs* multi,
                           int multi_mode)
{
    return (size_t)args->length * 256
           + (multi_mode ? (size_t)multi->n_sets * DPRF_K_PROBES * 128 * 4
                         : 0);
}

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  count and n_maybe must hold 0
// and lanes -1 on entry (the wrapper allocates them so).
extern "C" int dprf_mask_launch(int core, int multi_mode, int device,
                                const uint8_t* lut, const MaskArgs* args,
                                const MultiArgs* multi, uint32_t n_valid,
                                int32_t* count, int32_t* lanes,
                                int32_t* tpos, int32_t* n_maybe,
                                int32_t cap, int grid, int threads,
                                void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = shared_bytes(args, multi, multi_mode);
    const cudaStream_t st = (cudaStream_t)stream;
#define DPRF_LAUNCH(C, M)                                                 \
    launch<C, M>(lut, args, multi, n_valid, count, lanes, tpos, n_maybe,  \
                 cap, grid, threads, smem, st)
    DPRF_DISPATCH(DPRF_LAUNCH)
#undef DPRF_LAUNCH
}

// Resident blocks of `threads` threads per SM for one instantiation at
// `smem` bytes of dynamic shared memory (the grid's size).
extern "C" int dprf_mask_blocks_per_sm(int core, int multi_mode,
                                       int threads, int smem, int* blocks)
{
#define DPRF_OCCUPANCY(C, M) occupancy<C, M>(threads, (size_t)smem, blocks)
    DPRF_DISPATCH(DPRF_OCCUPANCY)
#undef DPRF_OCCUPANCY
}
