// cores.cuh -- the hash cores the port's kernels share (csrc/mask.cu,
// csrc/rules.cu, csrc/pbkdf2.cu): md5, md4 (ntlm, over UTF-16LE), sha1,
// sha256 and sha224, one 64-byte block each, fully unrolled, with everything
// in registers, and mysql323's byte scan over such a block; md5_compress,
// sha1_compress and sha256_compress, MD5, SHA-1 and SHA-256 from any
// chaining state (HMAC, the 7-Zip KDF); and sha512 / sha384 over one
// 128-byte block of 64-bit words.
//
// Each core is a struct: kWords digest words; kMaxLen, the longest
// candidate one block holds; word(q) / shift(q), where candidate byte q
// goes in the message words (called with compile-time q only, so they
// fold away); kLenWord and kBitsPerChar, where the message's bit length
// goes and how many bits a candidate byte adds to it; digest(m, out),
// the rounds and the feed-forward over the 16 message words (the SHA
// cores overwrite m as their schedule).  A core whose message is not
// the 16 words of a 64-byte block says so in kBlockWords; a sponge
// (csrc/keccak.cuh), which absorbs a rate block with a pad byte and no
// bit length, says so in kSponge.

#pragma once

#include <cstdint>
#include <type_traits>

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

// A core's message words: kBlockWords, or the 64-byte block's 16.
template <class C, class = void>
struct BlockWords : std::integral_constant<int, 16> {};
template <class C>
struct BlockWords<C, std::void_t<decltype(C::kBlockWords)>>
    : std::integral_constant<int, C::kBlockWords> {};

// The resident blocks per SM a core asks ptxas to fit (the second
// argument of __launch_bounds__): kMinBlocks, or 0, no request.
template <class C, class = void>
struct MinBlocks : std::integral_constant<int, 0> {};
template <class C>
struct MinBlocks<C, std::void_t<decltype(C::kMinBlocks)>>
    : std::integral_constant<int, C::kMinBlocks> {};

// Whether a core is a sponge (kSponge).
template <class C, class = void>
struct Sponge : std::false_type {};
template <class C>
struct Sponge<C, std::void_t<decltype(C::kSponge)>>
    : std::integral_constant<bool, C::kSponge> {};

// ---- the cores: byte placement, digest words, rounds -----------------
//
// word(q) / shift(q): where candidate byte q goes in the message words.
// They are called with compile-time q only, so they fold away.

// MD5 compression with an arbitrary chaining state: the 64 rounds over
// the 16 message words m and the feed-forward, out = st + rounds(st, m).
// Inlined with constant st or constant words of m, the constants fold
// (Md5Core::digest's IV, the HMAC blocks' padding words of csrc/krb5.cu).
__device__ __forceinline__ void md5_compress(const uint32_t* st,
                                             const uint32_t* m,
                                             uint32_t* out)
{
    const int S[4][4] = {{7, 12, 17, 22}, {5, 9, 14, 20},
                         {4, 11, 16, 23}, {6, 10, 15, 21}};
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
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
    out[0] = a + st[0];
    out[1] = b + st[1];
    out[2] = c + st[2];
    out[3] = d + st[3];
}

struct Md5Core {
    static constexpr int kWords = 4;
    static constexpr int kMaxLen = 55;
    static constexpr int kLenWord = 14;
    static constexpr int kBitsPerChar = 8;
    __host__ __device__ static constexpr int word(int q) { return q >> 2; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 8 * (q & 3);
    }

    __device__ __forceinline__ static void digest(uint32_t* m,
                                                  uint32_t* out)
    {
        const uint32_t iv[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu,
                                0x10325476u};
        md5_compress(iv, m, out);
    }
};

// NTLM: MD4 over the UTF-16LE candidate, so byte q is message byte 2q.
struct Md4Core {
    static constexpr int kWords = 4;
    static constexpr int kMaxLen = 27;
    static constexpr int kLenWord = 14;
    static constexpr int kBitsPerChar = 16;
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

// SHA-1 compression with an arbitrary chaining state: the 80 rounds
// over w (overwritten as the rolling schedule) and the feed-forward,
// out = st + rounds(st, w).  out may alias st.  Inlined with constant
// st or constant words of w, the constants fold (Sha1Core::digest's IV,
// the HMAC blocks' padding words of csrc/pbkdf2.cu).
__device__ __forceinline__ void sha1_compress(const uint32_t* st,
                                              uint32_t* w, uint32_t* out)
{
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4];
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
    out[0] = a + st[0];
    out[1] = b + st[1];
    out[2] = c + st[2];
    out[3] = d + st[3];
    out[4] = e + st[4];
}

struct Sha1Core {
    static constexpr int kWords = 5;
    static constexpr int kMaxLen = 55;
    static constexpr int kLenWord = 15;
    static constexpr int kBitsPerChar = 8;
    __host__ __device__ static constexpr int word(int q) { return q >> 2; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 8 * (3 - (q & 3));
    }

    __device__ __forceinline__ static void digest(uint32_t* w,
                                                  uint32_t* out)
    {
        const uint32_t iv[5] = {0x67452301u, 0xefcdab89u, 0x98badcfeu,
                                0x10325476u, 0xc3d2e1f0u};
        sha1_compress(iv, w, out);
    }
};

// The 64 SHA-256 rounds over w (overwritten as the rolling schedule), on
// the caller's working variables a..h.  A macro over the caller's names,
// so that Sha256Core::digest compiles to the same SASS as when the rounds
// were its own statements (chip_smoke.py's CENSUS_BEFORE), which a call
// of sha256_compress with the IV did not (an inlined function's copy of
// the same statements moved sha256-sp_mask and sha256_rules).
#define DPRF_SHA256_ROUNDS(w)                                             \
    _Pragma("unroll")                                                     \
    for (int t = 0; t < 64; ++t) {                                        \
        if (t >= 16) {                                                    \
            const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];  \
            const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);\
            const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10); \
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;                       \
        }                                                                 \
        const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25))  \
                            + (g ^ (e & (f ^ g))) + K_SHA256[t]           \
                            + w[t & 15];                                  \
        const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22))      \
                            + ((a & b) | (c & (a | b)));                  \
        h = g;                                                            \
        g = f;                                                            \
        f = e;                                                            \
        e = d + t1;                                                       \
        d = c;                                                            \
        c = b;                                                            \
        b = a;                                                            \
        a = t1 + t2;                                                      \
    }

// SHA-256 compression with an arbitrary chaining state: the 64 rounds
// over w (overwritten as the rolling schedule) and the feed-forward,
// out = st + rounds(st, w).  out may alias st.  csrc/sevenzip.cu chains
// it over the 7-Zip KDF's stream.
__device__ __forceinline__ void sha256_compress(const uint32_t* st,
                                                uint32_t* w, uint32_t* out)
{
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4],
             f = st[5], g = st[6], h = st[7];
    DPRF_SHA256_ROUNDS(w)
    out[0] = a + st[0];
    out[1] = b + st[1];
    out[2] = c + st[2];
    out[3] = d + st[3];
    out[4] = e + st[4];
    out[5] = f + st[5];
    out[6] = g + st[6];
    out[7] = h + st[7];
}

struct Sha256Core {
    static constexpr int kWords = 8;
    static constexpr int kMaxLen = 55;
    static constexpr int kLenWord = 15;
    static constexpr int kBitsPerChar = 8;
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
        DPRF_SHA256_ROUNDS(w)
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

// SHA-224: SHA-256 from its own initial state (FIPS 180-4; ops/sha256.INIT224
// computes it and a test holds them equal), the first 7 words kept.
struct Sha224Core : Sha256Core {
    static constexpr int kWords = 7;

    __device__ __forceinline__ static void digest(uint32_t* w,
                                                  uint32_t* out)
    {
        const uint32_t H[8] = {0xc1059ed8u, 0x367cd507u, 0x3070dd17u,
                               0xf70e5939u, 0xffc00b31u, 0x68581511u,
                               0x64f98fa7u, 0xbefa4fa4u};
        uint32_t a = H[0], b = H[1], c = H[2], d = H[3], e = H[4],
                 f = H[5], g = H[6], h = H[7];
        DPRF_SHA256_ROUNDS(w)
        out[0] = a + H[0];
        out[1] = b + H[1];
        out[2] = c + H[2];
        out[3] = d + H[3];
        out[4] = e + H[4];
        out[5] = f + H[5];
        out[6] = g + H[6];
    }
};

// MySQL pre-4.1 OLD_PASSWORD(): an add/xor/shift scan over the
// candidate's bytes, which sit big-endian in the message words as for
// SHA (the reference's digest_packed reads them back from that packing),
// to the length the bit length of word 15 gives: a launch parameter of
// a mask job, so the lanes of a warp take the same branches (the rules
// kernel's lanes, each of its own length, may not).  Spaces and tabs
// leave the state as it was; both 31-bit words come out.  The
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

// ---- 64-bit words: SHA-512 and SHA-384 -----------------------------------
//
// Hopper adds 64-bit words in two instructions (IADD3, then IADD3.X on
// the carry) and funnel-shifts a register pair, so a 64-bit word is a
// native uint64_t (two registers): a rotate is one SHF per half, a
// 3-input logic function one LOP3 per half.  The TPU's (hi, lo) uint32
// emulation of the reference is not needed.

// Rotate right by a compile-time n in 1..63: one funnel shift per half.
__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n)
{
    const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
    const uint32_t a = n < 32 ? lo : hi, b = n < 32 ? hi : lo;
    const int s = n & 31;
    return ((uint64_t)__funnelshift_r(b, a, s) << 32)
           | __funnelshift_r(a, b, s);
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n)
{
    return rotr64(x, 64 - n);
}

// the fractional cube roots of the first 80 primes, FIPS 180-4;
// ops/sha512.K computes the same table and a test holds them equal.
__constant__ uint64_t K_SHA512[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full,
    0xe9b5dba58189dbbcull, 0x3956c25bf348b538ull, 0x59f111f1b605d019ull,
    0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull, 0xd807aa98a3030242ull,
    0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull,
    0xc19bf174cf692694ull, 0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull,
    0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull, 0x2de92c6f592b0275ull,
    0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full,
    0xbf597fc7beef0ee4ull, 0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull,
    0x06ca6351e003826full, 0x142929670a0e6e70ull, 0x27b70a8546d22ffcull,
    0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull,
    0x92722c851482353bull, 0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull,
    0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull, 0xd192e819d6ef5218ull,
    0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull,
    0x34b0bcb5e19b48a8ull, 0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull,
    0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull, 0x748f82ee5defb2fcull,
    0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull,
    0xc67178f2e372532bull, 0xca273eceea26619cull, 0xd186b8c721c0c207ull,
    0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull, 0x06f067aa72176fbaull,
    0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull,
    0x431d67c49c100d4cull, 0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull,
    0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};

// One SHA-512 compression from the initial state H over the 32 message
// words m (big-endian halves: 64-bit word i is m[2i] << 32 | m[2i+1]),
// with a rolling 16-word schedule; out gets the first kOutWords 32-bit
// words of the digest, each 64-bit word high half first.
template <int kOutWords>
__device__ __forceinline__ void sha512_block(const uint64_t* H,
                                             const uint32_t* m,
                                             uint32_t* out)
{
    uint64_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
        w[i] = ((uint64_t)m[2 * i] << 32) | m[2 * i + 1];
    uint64_t a = H[0], b = H[1], c = H[2], d = H[3], e = H[4], f = H[5],
             g = H[6], h = H[7];
#pragma unroll
    for (int t = 0; t < 80; ++t) {
        if (t >= 16) {
            const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
            const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
            w[t & 15] += s0 + w[(t - 7) & 15] + s1;
        }
        const uint64_t t1 = h + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41))
                            + (g ^ (e & (f ^ g))) + K_SHA512[t] + w[t & 15];
        const uint64_t t2 = (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39))
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
    const uint64_t v[8] = {a + H[0], b + H[1], c + H[2], d + H[3],
                           e + H[4], f + H[5], g + H[6], h + H[7]};
#pragma unroll
    for (int i = 0; i < kOutWords; ++i)
        out[i] = (i & 1) ? (uint32_t)v[i >> 1] : (uint32_t)(v[i >> 1] >> 32);
}

// SHA-512: one 128-byte block, candidates of up to 111 bytes.
struct Sha512Core {
    static constexpr int kWords = 16;
    static constexpr int kMaxLen = 111;
    static constexpr int kBlockWords = 32;
    static constexpr int kLenWord = 31;
    static constexpr int kBitsPerChar = 8;
    __host__ __device__ static constexpr int word(int q) { return q >> 2; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 8 * (3 - (q & 3));
    }

    __device__ __forceinline__ static void digest(uint32_t* m,
                                                  uint32_t* out)
    {
        const uint64_t H[8] = {
            0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull,
            0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
            0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
            0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};
        sha512_block<kWords>(H, m, out);
    }
};

// SHA-384: SHA-512 with its own initial state, the first 12 words kept.
struct Sha384Core : Sha512Core {
    static constexpr int kWords = 12;

    __device__ __forceinline__ static void digest(uint32_t* m,
                                                  uint32_t* out)
    {
        const uint64_t H[8] = {
            0xcbbb9d5dc1059ed8ull, 0x629a292a367cd507ull,
            0x9159015a3070dd17ull, 0x152fecd8f70e5939ull,
            0x67332667ffc00b31ull, 0x8eb44a8768581511ull,
            0xdb0c2e0d64f98fa7ull, 0x47b5481dbefa4fa4ull};
        sha512_block<kWords>(H, m, out);
    }
};
