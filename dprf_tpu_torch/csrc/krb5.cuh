// krb5.cuh -- the Kerberos etype-23 (RC4-HMAC) steps that the krb5
// kernel (csrc/krb5.cu) and the rules kernel's Kerberos tail
// (csrc/rules_group.cu) share: HMAC-MD5 from a 16-byte key's states, and
// the RC4 keystream word over plaintext bytes [8, 12) in the calling
// thread's state (csrc/rc4.cuh, which needs the including source's
// kThreads).  A ticket's row: its checksum (4 little-endian words),
// edata2[8:12] little-endian, the DER mask, the masked expectation, 0
// (ops/cuda_krb5.ticket_rows).

#pragma once

#include <cstdint>

#include "cores.cuh"
#include "rc4.cuh"

#define DPRF_KRB5_MAX_LEN 27
// the most tickets a launch takes (ops/cuda_krb5.GROUP)
#define DPRF_KRB5_GROUP 128
// words of a ticket's row: the checksum (4 little-endian words),
// edata2[8:12] little-endian, the mask, the masked expectation, 0
#define DPRF_KRB5_ROW 8

// The HMAC-MD5 key states of a 16-byte key: the compressions of the
// key block xor ipad and xor opad, from the IV.
__device__ __forceinline__ void hmac_md5_keys(const uint32_t* key,
                                              uint32_t* ist, uint32_t* ost)
{
    const uint32_t iv[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu,
                            0x10325476u};
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = (i < 4 ? key[i] : 0u) ^ 0x36363636u;
    md5_compress(iv, w, ist);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = (i < 4 ? key[i] : 0u) ^ 0x5c5c5c5cu;
    md5_compress(iv, w, ost);
}

// HMAC-MD5 from the key states of a kWords-word message that fits one
// block after the key block: the padding words are constants.
template <int kWords>
__device__ __forceinline__ void hmac_md5_msg(const uint32_t* ist,
                                             const uint32_t* ost,
                                             const uint32_t* msg,
                                             uint32_t* out)
{
    uint32_t w[16], inner[4];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = i < kWords ? msg[i] : 0u;
    w[kWords] = 0x80u;
    w[14] = (64 + 4 * kWords) * 8;
    md5_compress(ist, w, inner);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = i < 4 ? inner[i] : 0u;
    w[4] = 0x80u;
    w[14] = (64 + 16) * 8;
    md5_compress(ost, w, out);
}

// Keystream bytes [8, 12) under the 16-byte key k (little-endian words),
// packed little-endian.
__device__ __forceinline__ uint32_t rc4_word2(uint8_t* s, const uint32_t* k)
{
    RC4_INIT(s);
    uint32_t j = 0u;
#pragma unroll
    for (int i = 0; i < 256; ++i) {
        const uint32_t kb = (k[(i >> 2) & 3] >> (8 * (i & 3))) & 0xffu;
        RC4_KSA_STEP(s, i, kb, j);
    }
    j = 0u;
    uint32_t word = 0u;
#pragma unroll
    for (int t = 0; t < 12; ++t) {
        const int i = t + 1;
        RC4_OUT_STEP(s, i, j, si, sj);
        if (t >= 8) word |= (uint32_t)RC4_AT(s, (si + sj) & 0xffu)
                            << (8 * (t - 8));
    }
    return word;
}
