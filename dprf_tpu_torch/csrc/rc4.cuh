// rc4.cuh -- RC4 with one state per thread in shared memory, the layout
// the port's RC4 kernels share (csrc/krb5.cu, csrc/pdf.cu).
//
// A block of kThreads threads keeps 256 bytes of state a thread in
// csrc/thread_bytes.cuh's layout, so a warp's 32 data-dependent accesses
// never conflict.  `s` below is the calling thread's base: the block's
// state plus 4 * threadIdx.x.
//
// The caller unrolls the key schedule in full, so i (and the key byte's
// position, i % key length) is a compile-time constant: S[i]'s address
// is a constant offset of the base and the key byte an extract at a
// constant position, nothing is indexed in registers and there is no
// stack frame.  A swap stores S[i] = S[j] before S[j] = S[i], both from
// values read first, which is right when j == i.
//
// The steps are macros over the caller's names, not inlined functions:
// csrc/krb5.cu compiled to the same SASS as before they moved here, which
// an inlined function's copy of the same statements did not; csrc/pdf.cu's
// instantiations are pinned (chip_smoke.py's PDF_BEFORE).

#pragma once

#include <cstdint>

#include "thread_bytes.cuh"

// Byte e of the calling thread's RC4 state.
#define RC4_AT(s, e) THREAD_BYTE_AT(s, e)

// The identity permutation S[e] = e, one word store per four bytes.
#define RC4_INIT(s)                                                       \
    do {                                                                  \
        uint32_t* rc4_s32_ = reinterpret_cast<uint32_t*>(s);              \
        _Pragma("unroll")                                                 \
        for (int rc4_w_ = 0; rc4_w_ < 64; ++rc4_w_)                       \
            rc4_s32_[rc4_w_ * kThreads] =                                 \
                0x03020100u + 0x04040404u * (uint32_t)rc4_w_;             \
    } while (0)

// One key-schedule step at position i with key byte kb; j is updated.
#define RC4_KSA_STEP(s, i, kb, j)                                         \
    do {                                                                  \
        const uint32_t rc4_si_ = RC4_AT(s, i);                            \
        j = (j + rc4_si_ + (kb)) & 0xffu;                                 \
        const uint32_t rc4_sj_ = RC4_AT(s, j);                            \
        RC4_AT(s, i) = (uint8_t)rc4_sj_;                                  \
        RC4_AT(s, j) = (uint8_t)rc4_si_;                                  \
    } while (0)

// One output step at position i (the count of output bytes so far plus
// one); declares si and sj, the swapped values, so that the keystream
// byte is RC4_AT(s, (si + sj) & 0xffu), read only where it is kept.
#define RC4_OUT_STEP(s, i, j, si, sj)                                     \
    const uint32_t si = RC4_AT(s, i);                                     \
    j = (j + si) & 0xffu;                                                 \
    const uint32_t sj = RC4_AT(s, j);                                     \
    RC4_AT(s, i) = (uint8_t)sj;                                           \
    RC4_AT(s, j) = (uint8_t)si
