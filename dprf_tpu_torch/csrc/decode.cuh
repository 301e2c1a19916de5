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
// on entry) and `m` (uint32[], the message words to OR the bytes into).
// kMax, the most positions the kernel takes (<= 143), is a compile-time
// constant: the runs past it compile away, and past 63 each position
// is guarded by it, so a core's message array is never indexed past its
// own block.  A kernel of at most 63 positions compiles as it did
// before the wide run existed.

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

// DPRF_POS for a position that exists only below kMax.
#define DPRF_POS_UPTO(Place, q, kMax)                                     \
    if constexpr ((q) < (kMax)) DPRF_POS(Place, q)

// Positions L - 1 .. 0, last first.
#define DPRF_DECODE(Place, kMax, L)                                       \
    do {                                                                  \
        if constexpr ((kMax) > 63) {                                      \
            switch (L) {                                                  \
        case 143: DPRF_POS_UPTO(Place, 142, kMax)  case 142: DPRF_POS_UPTO(Place, 141, kMax) \
        case 141: DPRF_POS_UPTO(Place, 140, kMax)  case 140: DPRF_POS_UPTO(Place, 139, kMax) \
        case 139: DPRF_POS_UPTO(Place, 138, kMax)  case 138: DPRF_POS_UPTO(Place, 137, kMax) \
        case 137: DPRF_POS_UPTO(Place, 136, kMax)  case 136: DPRF_POS_UPTO(Place, 135, kMax) \
        case 135: DPRF_POS_UPTO(Place, 134, kMax)  case 134: DPRF_POS_UPTO(Place, 133, kMax) \
        case 133: DPRF_POS_UPTO(Place, 132, kMax)  case 132: DPRF_POS_UPTO(Place, 131, kMax) \
        case 131: DPRF_POS_UPTO(Place, 130, kMax)  case 130: DPRF_POS_UPTO(Place, 129, kMax) \
        case 129: DPRF_POS_UPTO(Place, 128, kMax)  case 128: DPRF_POS_UPTO(Place, 127, kMax) \
        case 127: DPRF_POS_UPTO(Place, 126, kMax)  case 126: DPRF_POS_UPTO(Place, 125, kMax) \
        case 125: DPRF_POS_UPTO(Place, 124, kMax)  case 124: DPRF_POS_UPTO(Place, 123, kMax) \
        case 123: DPRF_POS_UPTO(Place, 122, kMax)  case 122: DPRF_POS_UPTO(Place, 121, kMax) \
        case 121: DPRF_POS_UPTO(Place, 120, kMax)  case 120: DPRF_POS_UPTO(Place, 119, kMax) \
        case 119: DPRF_POS_UPTO(Place, 118, kMax)  case 118: DPRF_POS_UPTO(Place, 117, kMax) \
        case 117: DPRF_POS_UPTO(Place, 116, kMax)  case 116: DPRF_POS_UPTO(Place, 115, kMax) \
        case 115: DPRF_POS_UPTO(Place, 114, kMax)  case 114: DPRF_POS_UPTO(Place, 113, kMax) \
        case 113: DPRF_POS_UPTO(Place, 112, kMax)  case 112: DPRF_POS_UPTO(Place, 111, kMax) \
        case 111: DPRF_POS_UPTO(Place, 110, kMax)  case 110: DPRF_POS_UPTO(Place, 109, kMax) \
        case 109: DPRF_POS_UPTO(Place, 108, kMax)  case 108: DPRF_POS_UPTO(Place, 107, kMax) \
        case 107: DPRF_POS_UPTO(Place, 106, kMax)  case 106: DPRF_POS_UPTO(Place, 105, kMax) \
        case 105: DPRF_POS_UPTO(Place, 104, kMax)  case 104: DPRF_POS_UPTO(Place, 103, kMax) \
        case 103: DPRF_POS_UPTO(Place, 102, kMax)  case 102: DPRF_POS_UPTO(Place, 101, kMax) \
        case 101: DPRF_POS_UPTO(Place, 100, kMax)  case 100: DPRF_POS_UPTO(Place, 99, kMax) \
        case 99: DPRF_POS_UPTO(Place, 98, kMax)  case 98: DPRF_POS_UPTO(Place, 97, kMax) \
        case 97: DPRF_POS_UPTO(Place, 96, kMax)  case 96: DPRF_POS_UPTO(Place, 95, kMax) \
        case 95: DPRF_POS_UPTO(Place, 94, kMax)  case 94: DPRF_POS_UPTO(Place, 93, kMax) \
        case 93: DPRF_POS_UPTO(Place, 92, kMax)  case 92: DPRF_POS_UPTO(Place, 91, kMax) \
        case 91: DPRF_POS_UPTO(Place, 90, kMax)  case 90: DPRF_POS_UPTO(Place, 89, kMax) \
        case 89: DPRF_POS_UPTO(Place, 88, kMax)  case 88: DPRF_POS_UPTO(Place, 87, kMax) \
        case 87: DPRF_POS_UPTO(Place, 86, kMax)  case 86: DPRF_POS_UPTO(Place, 85, kMax) \
        case 85: DPRF_POS_UPTO(Place, 84, kMax)  case 84: DPRF_POS_UPTO(Place, 83, kMax) \
        case 83: DPRF_POS_UPTO(Place, 82, kMax)  case 82: DPRF_POS_UPTO(Place, 81, kMax) \
        case 81: DPRF_POS_UPTO(Place, 80, kMax)  case 80: DPRF_POS_UPTO(Place, 79, kMax) \
        case 79: DPRF_POS_UPTO(Place, 78, kMax)  case 78: DPRF_POS_UPTO(Place, 77, kMax) \
        case 77: DPRF_POS_UPTO(Place, 76, kMax)  case 76: DPRF_POS_UPTO(Place, 75, kMax) \
        case 75: DPRF_POS_UPTO(Place, 74, kMax)  case 74: DPRF_POS_UPTO(Place, 73, kMax) \
        case 73: DPRF_POS_UPTO(Place, 72, kMax)  case 72: DPRF_POS_UPTO(Place, 71, kMax) \
        case 71: DPRF_POS_UPTO(Place, 70, kMax)  case 70: DPRF_POS_UPTO(Place, 69, kMax) \
        case 69: DPRF_POS_UPTO(Place, 68, kMax)  case 68: DPRF_POS_UPTO(Place, 67, kMax) \
        case 67: DPRF_POS_UPTO(Place, 66, kMax)  case 66: DPRF_POS_UPTO(Place, 65, kMax) \
        case 65: DPRF_POS_UPTO(Place, 64, kMax)  case 64: DPRF_POS_UPTO(Place, 63, kMax) \
            default: break;                                               \
            }                                                             \
        }                                                                 \
        if constexpr ((kMax) > 55) {                                      \
            switch ((kMax) > 63 && (L) > 63 ? 63 : (L)) {                 \
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

// ---- the decode by reciprocals (the grouped kernels) ----------------------
//
// DPRF_DECODE_RCP computes what DPRF_DECODE does without a division: a
// position's quotient is a multiply-high by a reciprocal the host
// computed from its radix r (ops/cuda_mask.decode_reciprocals),
//
//   sh = ceil(log2 r),  rcp = ceil(2^(31 + sh) / r),
//   s / r = umulhi(2 s, rcp) >> sh   for every s < 2^31,
//
// (2 s rcp / 2^(32 + sh) = s / r + e with 0 <= e < s / 2^(31 + sh) <
// 2^-sh <= 1 / r, so the floor is the quotient's; the lane arithmetic
// keeps s = base digit + carry below 2^31), and its remainder a
// multiply-subtract: an IMAD.HI, a shift and an IMAD where the divide
// sequence nvcc emits for a runtime radix takes a dozen instructions.
// It expects, beside DPRF_DECODE's names, uint32 rcp[] and int32 rsh[]
// in `args`.  kMax is at most 55.

#define DPRF_POS_RCP(Place, q)                                            \
    {                                                                     \
        const uint32_t s = (uint32_t)args.base[q] + carry;                \
        carry = __umulhi(s << 1, args.rcp[q]) >> args.rsh[q];             \
        const uint32_t digit = s - carry * (uint32_t)args.radix[q];       \
        m[Place::word(q)] |= (uint32_t)s_lut[(q) * 256 + digit]           \
                             << Place::shift(q);                          \
    }

// Positions L - 1 .. 0, last first.
#define DPRF_DECODE_RCP(Place, kMax, L)                                   \
    do {                                                                  \
        static_assert((kMax) <= 55, "the reciprocal decode takes 55");    \
        if constexpr ((kMax) > 27) {                                      \
            switch (L) {                                                  \
        case 55: DPRF_POS_RCP(Place, 54)  case 54: DPRF_POS_RCP(Place, 53)  case 53: DPRF_POS_RCP(Place, 52) \
        case 52: DPRF_POS_RCP(Place, 51)  case 51: DPRF_POS_RCP(Place, 50)  case 50: DPRF_POS_RCP(Place, 49) \
        case 49: DPRF_POS_RCP(Place, 48)  case 48: DPRF_POS_RCP(Place, 47)  case 47: DPRF_POS_RCP(Place, 46) \
        case 46: DPRF_POS_RCP(Place, 45)  case 45: DPRF_POS_RCP(Place, 44)  case 44: DPRF_POS_RCP(Place, 43) \
        case 43: DPRF_POS_RCP(Place, 42)  case 42: DPRF_POS_RCP(Place, 41)  case 41: DPRF_POS_RCP(Place, 40) \
        case 40: DPRF_POS_RCP(Place, 39)  case 39: DPRF_POS_RCP(Place, 38)  case 38: DPRF_POS_RCP(Place, 37) \
        case 37: DPRF_POS_RCP(Place, 36)  case 36: DPRF_POS_RCP(Place, 35)  case 35: DPRF_POS_RCP(Place, 34) \
        case 34: DPRF_POS_RCP(Place, 33)  case 33: DPRF_POS_RCP(Place, 32)  case 32: DPRF_POS_RCP(Place, 31) \
        case 31: DPRF_POS_RCP(Place, 30)  case 30: DPRF_POS_RCP(Place, 29)  case 29: DPRF_POS_RCP(Place, 28) \
        case 28: DPRF_POS_RCP(Place, 27) \
            default: break;                                               \
            }                                                             \
        }                                                                 \
        switch ((L) < 27 ? (L) : 27) {                                    \
        case 27: DPRF_POS_RCP(Place, 26)  case 26: DPRF_POS_RCP(Place, 25)  case 25: DPRF_POS_RCP(Place, 24) \
        case 24: DPRF_POS_RCP(Place, 23)  case 23: DPRF_POS_RCP(Place, 22)  case 22: DPRF_POS_RCP(Place, 21) \
        case 21: DPRF_POS_RCP(Place, 20)  case 20: DPRF_POS_RCP(Place, 19)  case 19: DPRF_POS_RCP(Place, 18) \
        case 18: DPRF_POS_RCP(Place, 17)  case 17: DPRF_POS_RCP(Place, 16)  case 16: DPRF_POS_RCP(Place, 15) \
        case 15: DPRF_POS_RCP(Place, 14)  case 14: DPRF_POS_RCP(Place, 13)  case 13: DPRF_POS_RCP(Place, 12) \
        case 12: DPRF_POS_RCP(Place, 11)  case 11: DPRF_POS_RCP(Place, 10)  case 10: DPRF_POS_RCP(Place, 9) \
        case 9: DPRF_POS_RCP(Place, 8)  case 8: DPRF_POS_RCP(Place, 7)  case 7: DPRF_POS_RCP(Place, 6) \
        case 6: DPRF_POS_RCP(Place, 5)  case 5: DPRF_POS_RCP(Place, 4)  case 4: DPRF_POS_RCP(Place, 3) \
        case 3: DPRF_POS_RCP(Place, 2)  case 2: DPRF_POS_RCP(Place, 1)  case 1: DPRF_POS_RCP(Place, 0) \
        default: break;                                                   \
        }                                                                 \
    } while (0)
