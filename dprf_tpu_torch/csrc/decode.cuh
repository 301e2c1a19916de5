// decode.cuh -- the mask decode the port's mask-attack kernels share
// (csrc/mask.cu, csrc/pbkdf2.cu): a keyspace index to the candidate's
// bytes, placed in the message words.
//
// The index is mixed-radix: position L - 1 is the least significant
// digit.  Each position takes (base digit + carry), its remainder by the
// position's radix picks the charset byte from a 256-entry table in
// shared memory, its quotient carries to the next position.  A
// warp-uniform switch on the mask length enters an unrolled run of
// positions at L - 1, so only the mask's own positions cost
// instructions, and every byte's place in the message words is a
// compile-time constant of the caller's Place (word(q), shift(q): the
// core structs of cores.cuh).
//
// DPRF_DECODE expects in scope: `args` with int32 radix[] and base[]
// (the base digits of the launch's first candidate), `s_lut`
// (uint8[L][256] in shared memory), `carry` (uint32, the lane's offset
// on entry) and `m` (uint32[16], the message words to OR the bytes
// into).  kMax, the most positions the kernel takes (<= 63), is a
// compile-time constant: the runs past it compile away.

#pragma once

// One mask position q (a compile-time constant): digit = (base + carry)
// mod radix, carry = (base + carry) div radix, and the charset byte goes
// to Place's spot for byte q.
#define DPRF_POS(Place, q)                                                \
    {                                                                     \
        const uint32_t s = (uint32_t)args.base[q] + carry;                \
        const uint32_t r = (uint32_t)args.radix[q];                       \
        carry = s / r;                                                    \
        const uint32_t digit = s - carry * r;                             \
        m[Place::word(q)] |= (uint32_t)s_lut[(q) * 256 + digit]           \
                             << Place::shift(q);                          \
    }

// Positions L - 1 .. 0, last first.
#define DPRF_DECODE(Place, kMax, L)                                       \
    do {                                                                  \
        if constexpr ((kMax) > 55) {                                      \
            switch (L) {                                                  \
        case 63: DPRF_POS(Place, 62)  case 62: DPRF_POS(Place, 61)  case 61: DPRF_POS(Place, 60) \
        case 60: DPRF_POS(Place, 59)  case 59: DPRF_POS(Place, 58)  case 58: DPRF_POS(Place, 57) \
        case 57: DPRF_POS(Place, 56)  case 56: DPRF_POS(Place, 55) \
            default: break;                                               \
            }                                                             \
        }                                                                 \
        if constexpr ((kMax) > 27) {                                      \
            switch ((kMax) > 55 && (L) > 55 ? 55 : (L)) {                 \
        case 55: DPRF_POS(Place, 54)  case 54: DPRF_POS(Place, 53)  case 53: DPRF_POS(Place, 52) \
        case 52: DPRF_POS(Place, 51)  case 51: DPRF_POS(Place, 50)  case 50: DPRF_POS(Place, 49) \
        case 49: DPRF_POS(Place, 48)  case 48: DPRF_POS(Place, 47)  case 47: DPRF_POS(Place, 46) \
        case 46: DPRF_POS(Place, 45)  case 45: DPRF_POS(Place, 44)  case 44: DPRF_POS(Place, 43) \
        case 43: DPRF_POS(Place, 42)  case 42: DPRF_POS(Place, 41)  case 41: DPRF_POS(Place, 40) \
        case 40: DPRF_POS(Place, 39)  case 39: DPRF_POS(Place, 38)  case 38: DPRF_POS(Place, 37) \
        case 37: DPRF_POS(Place, 36)  case 36: DPRF_POS(Place, 35)  case 35: DPRF_POS(Place, 34) \
        case 34: DPRF_POS(Place, 33)  case 33: DPRF_POS(Place, 32)  case 32: DPRF_POS(Place, 31) \
        case 31: DPRF_POS(Place, 30)  case 30: DPRF_POS(Place, 29)  case 29: DPRF_POS(Place, 28) \
        case 28: DPRF_POS(Place, 27) \
            default: break;                                               \
            }                                                             \
        }                                                                 \
        switch ((L) < 27 ? (L) : 27) {                                    \
        case 27: DPRF_POS(Place, 26)  case 26: DPRF_POS(Place, 25)  case 25: DPRF_POS(Place, 24) \
        case 24: DPRF_POS(Place, 23)  case 23: DPRF_POS(Place, 22)  case 22: DPRF_POS(Place, 21) \
        case 21: DPRF_POS(Place, 20)  case 20: DPRF_POS(Place, 19)  case 19: DPRF_POS(Place, 18) \
        case 18: DPRF_POS(Place, 17)  case 17: DPRF_POS(Place, 16)  case 16: DPRF_POS(Place, 15) \
        case 15: DPRF_POS(Place, 14)  case 14: DPRF_POS(Place, 13)  case 13: DPRF_POS(Place, 12) \
        case 12: DPRF_POS(Place, 11)  case 11: DPRF_POS(Place, 10)  case 10: DPRF_POS(Place, 9) \
        case 9: DPRF_POS(Place, 8)  case 8: DPRF_POS(Place, 7)  case 7: DPRF_POS(Place, 6) \
        case 6: DPRF_POS(Place, 5)  case 5: DPRF_POS(Place, 4)  case 4: DPRF_POS(Place, 3) \
        case 3: DPRF_POS(Place, 2)  case 2: DPRF_POS(Place, 1)  case 1: DPRF_POS(Place, 0) \
        default: break;                                                   \
        }                                                                 \
    } while (0)
