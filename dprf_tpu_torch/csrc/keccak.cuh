// keccak.cuh -- the Keccak sponge as a core type: Keccak-f[1600] and
// KeccakCore<kRate, kOutWords>, which the mask kernel (csrc/keccak.cu)
// and the rules kernel (csrc/rules_wide.cu) instantiate for
// sha3-224/256/384/512 and the original keccak-224/256/384/512.
//
// KeccakCore<kRate, kOutWords>:
//
// - The message is the absorbed rate block, kRate / 4 little-endian
//   words: the candidate at [0, L), and in the job's fixed words the
//   pad byte at L (0x06 SHA3, 0x01 Keccak) and 0x80 at kRate - 1,
//   merged when they meet.  So sha3-N and keccak-N share one
//   instantiation; only the fixed words differ.
// - The absorb XORs the block into the zero state: lane i = m[2i] |
//   m[2i+1] << 32 for i < kRate / 8, zero past the rate.
// - 24 fully unrolled rounds of Keccak-f[1600] on 25 named uint64_t
//   lanes: theta's column parities, rho and pi as a renaming of lanes
//   (every index a compile-time constant, so the lanes stay in
//   registers: no runtime index, no local memory), chi, iota.
// - The squeeze: digest word 2i is bswap(lo(lane i)), word 2i + 1
//   bswap(hi(lane i)), the big-endian reading of the digest bytes the
//   target table holds; a 224-bit digest ends on a half lane, its low
//   word.
//
// The mask kernel writes the pad byte and the 0x80 into the job's fixed
// words; the rules kernel's pack turns its candidate's 0x80 marker at n
// into the pad byte, a launch parameter, and ORs 0x80 into byte
// kRate - 1 (kSponge).

#pragma once

#include <cstdint>

#include "cores.cuh"

// The round constants of iota, from the specification's LFSR;
// ops/keccak.RC computes the same table and a test holds them equal.
__constant__ uint64_t RC_KECCAK[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
    0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
    0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// Keccak-f[1600] over the lanes a[x + 5y].
__device__ __forceinline__ void keccak_f(uint64_t* a)
{
#pragma unroll
    for (int r = 0; r < 24; ++r) {
        uint64_t c[5], d[5], b[25];
#pragma unroll
        for (int x = 0; x < 5; ++x)
            c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        // theta's xor, then rho and pi: lane i goes to lane PI[i]
        // rotated left by RHO[i] (ops/keccak.PI, RHO)
        b[0] = a[0] ^ d[0];
        b[10] = rotl64(a[1] ^ d[1], 1);
        b[20] = rotl64(a[2] ^ d[2], 62);
        b[5] = rotl64(a[3] ^ d[3], 28);
        b[15] = rotl64(a[4] ^ d[4], 27);
        b[16] = rotl64(a[5] ^ d[0], 36);
        b[1] = rotl64(a[6] ^ d[1], 44);
        b[11] = rotl64(a[7] ^ d[2], 6);
        b[21] = rotl64(a[8] ^ d[3], 55);
        b[6] = rotl64(a[9] ^ d[4], 20);
        b[7] = rotl64(a[10] ^ d[0], 3);
        b[17] = rotl64(a[11] ^ d[1], 10);
        b[2] = rotl64(a[12] ^ d[2], 43);
        b[12] = rotl64(a[13] ^ d[3], 25);
        b[22] = rotl64(a[14] ^ d[4], 39);
        b[23] = rotl64(a[15] ^ d[0], 41);
        b[8] = rotl64(a[16] ^ d[1], 45);
        b[18] = rotl64(a[17] ^ d[2], 15);
        b[3] = rotl64(a[18] ^ d[3], 21);
        b[13] = rotl64(a[19] ^ d[4], 8);
        b[14] = rotl64(a[20] ^ d[0], 18);
        b[24] = rotl64(a[21] ^ d[1], 2);
        b[9] = rotl64(a[22] ^ d[2], 61);
        b[19] = rotl64(a[23] ^ d[3], 56);
        b[4] = rotl64(a[24] ^ d[4], 14);
        // chi, then iota
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
#pragma unroll
            for (int x = 0; x < 5; ++x)
                a[y + x] = b[y + x]
                           ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
        }
        a[0] ^= RC_KECCAK[r];
    }
}

template <int kRate, int kOutWords>
struct KeccakCore {
    static constexpr int kWords = kOutWords;
    static constexpr int kMaxLen = kRate - 1;
    static constexpr int kBlockWords = kRate / 4;
    // the rules kernel's pack (csrc/rules_kernel.cuh): a rate block, no
    // bit length, a byte a candidate byte
    static constexpr bool kSponge = true;
    static constexpr int kBitsPerChar = 8;
    // three blocks of 256 an SM: without the request ptxas fits the
    // mask kernel's one-target instantiations in 64 registers with a
    // few bytes of spill; with it, ~71 registers and none
    static constexpr int kMinBlocks = 3;
    __host__ __device__ static constexpr int word(int q) { return q >> 2; }
    __host__ __device__ static constexpr int shift(int q)
    {
        return 8 * (q & 3);
    }

    __device__ __forceinline__ static void digest(uint32_t* m,
                                                  uint32_t* out)
    {
        uint64_t a[25];
#pragma unroll
        for (int i = 0; i < 25; ++i) {
            if (i < kRate / 8)
                a[i] = ((uint64_t)m[2 * i + 1] << 32) | m[2 * i];
            else
                a[i] = 0ull;
        }
        keccak_f(a);
#pragma unroll
        for (int w = 0; w < kOutWords; ++w) {
            const uint64_t lane = a[w >> 1];
            const uint32_t half = (w & 1) ? (uint32_t)(lane >> 32)
                                          : (uint32_t)lane;
            out[w] = __byte_perm(half, 0u, 0x0123);
        }
    }
};
