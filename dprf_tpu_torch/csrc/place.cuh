// place.cuh -- a candidate's message words moved to a later byte: the
// move of an "sp" candidate past its salt that the salted kernel
// (csrc/salted.cuh) and the rules kernel's salted tail
// (csrc/rules_group.cu) share.

#pragma once

#include <cstdint>

// m[j] = t[j - K] (0 below K) over the N words a candidate can reach
// (L + S <= 55 bytes: 14; 111 bytes: 28).
template <int K, int N>
__device__ __forceinline__ void move_words(const uint32_t* t, uint32_t* m)
{
#pragma unroll
    for (int j = 0; j < N; ++j) m[j] = j >= K ? t[j - K] : 0u;
}

// The candidate's N words, decoded at [0, L), moved to [s, s + L).
template <class Core, int N>
__device__ __forceinline__ void move_candidate(uint32_t* c, int s)
{
    // byte 0 is a word's low byte (md5) or its high byte (SHA)
    constexpr bool kBigEndian = Core::shift(0) != 0;
    const uint32_t r = 8u * (uint32_t)(s & 3);
    uint32_t t[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const uint32_t prev = j ? c[j - 1] : 0u;
        t[j] = kBigEndian ? __funnelshift_r(c[j], prev, r)
                          : __funnelshift_l(prev, c[j], r);
    }
    switch (s >> 2) {
    case 0: move_words<0, N>(t, c); break;
    case 1: move_words<1, N>(t, c); break;
    case 2: move_words<2, N>(t, c); break;
    case 3: move_words<3, N>(t, c); break;
    case 4: move_words<4, N>(t, c); break;
    case 5: move_words<5, N>(t, c); break;
    case 6: move_words<6, N>(t, c); break;
    case 7: move_words<7, N>(t, c); break;
    default: move_words<8, N>(t, c); break;
    }
}
