// chains.cuh -- the nested fast-hash chains as cores: outer(hex(inner(p)))
// and mysql41, for the mask kernel template (csrc/ext.cu) and the rules
// kernel (csrc/rules_nested.cu).
//
// - Nested<Outer, Inner>: the candidate is placed by the INNER core's
//   byte order (word, shift, kLenWord, kBitsPerChar); digest runs the
//   inner core, hex-encodes its digest in registers (lowercase, in the
//   digest's canonical byte order, one select per nibble), packs the 32
//   (md5) or 40 (sha1) hex bytes with the 0x80 marker and the bit length
//   into the OUTER core's block, and runs the outer core.  kWords is the
//   outer core's.
// - Mysql41: sha1, then sha1 over a second block of the five raw inner
//   words, 0x80000000 and the bit length 160.

#pragma once

#include <cstdint>

#include "cores.cuh"

// ---- nested: outer(hex(inner(p))) -----------------------------------------

__device__ __forceinline__ uint32_t hex_char(uint32_t nibble)
{
    return nibble + (nibble < 10u ? (uint32_t)'0' : (uint32_t)('a' - 10));
}

// The inner digest's lowercase hex, placed by Outer's byte order, with
// its padding: the outer core's whole message block.
template <class Outer, class Inner>
__device__ __forceinline__ void hex_block(const uint32_t* d, uint32_t* m)
{
    constexpr int kHex = 8 * Inner::kWords;      // 32 or 40 bytes
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = 0u;
#pragma unroll
    for (int k = 0; k < 4 * Inner::kWords; ++k) {
        // inner digest byte k, in the digest's canonical byte order
        const uint32_t b = (d[Inner::word(k)] >> Inner::shift(k)) & 0xffu;
        m[Outer::word(2 * k)] |= hex_char(b >> 4) << Outer::shift(2 * k);
        m[Outer::word(2 * k + 1)] |= hex_char(b & 15u)
                                     << Outer::shift(2 * k + 1);
    }
    m[Outer::word(kHex)] |= 0x80u << Outer::shift(kHex);
    m[Outer::kLenWord] = 8u * kHex;
}

template <class Outer, class Inner>
struct Nested {
    static constexpr int kWords = Outer::kWords;
    static constexpr int kMaxLen = Inner::kMaxLen;
    static constexpr int kLenWord = Inner::kLenWord;
    static constexpr int kBitsPerChar = Inner::kBitsPerChar;
    __host__ __device__ static constexpr int word(int q)
    {
        return Inner::word(q);
    }
    __host__ __device__ static constexpr int shift(int q)
    {
        return Inner::shift(q);
    }

    __device__ __forceinline__ static void digest(uint32_t* m, uint32_t* out)
    {
        uint32_t d[Inner::kWords];
        Inner::digest(m, d);
        uint32_t m2[16];
        hex_block<Outer, Inner>(d, m2);
        Outer::digest(m2, out);
    }
};

// MySQL 4.1+ PASSWORD(): sha1(sha1(p)) over the raw inner digest.
struct Mysql41 : Sha1Core {
    __device__ __forceinline__ static void digest(uint32_t* m, uint32_t* out)
    {
        uint32_t d[5];
        Sha1Core::digest(m, d);
        uint32_t m2[16] = {d[0], d[1], d[2], d[3], d[4], 0x80000000u,
                           0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u, 160u};
        Sha1Core::digest(m2, out);
    }
};

using Md5OfMd5 = Nested<Md5Core, Md5Core>;
using Sha1OfSha1 = Nested<Sha1Core, Sha1Core>;
using Md5OfSha1 = Nested<Md5Core, Sha1Core>;
using Sha1OfMd5 = Nested<Sha1Core, Md5Core>;
using Sha256OfMd5 = Nested<Sha256Core, Md5Core>;
using Sha256OfSha1 = Nested<Sha256Core, Sha1Core>;
