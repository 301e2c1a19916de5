// rules_wide.cu -- the fused wordlist+rules kernel (rules_kernel.cuh) over
// the wide cores: SHA-512 and SHA-384 over one 128-byte block, and the
// Keccak sponge over one rate block (sha3-N and keccak-N share the
// instantiation of their rate), one target or a list; and the sha512
// salted tails ($pass.$salt, $salt.$pass, and MSSQL 2012's UTF-16LE
// candidate with its salt after it), a group of targets a launch.
//
// Replaces no TPU kernel: the reference runs these wordlists on XLA only
// (dprf_tpu/engines/device/engines.py make_wordlist_worker, which ends in
// runtime/worker.py's DeviceWordlistWorker for sha512 and sha384;
// engines/device/salted.py's SaltedWordlistWorker for the salted names;
// engines/device/sha3.py's KeccakWordlistWorker).  Its mask path's
// counterparts are csrc/mask.cu's sha512/sha384, csrc/keccak.cu and
// csrc/salted.cuh's wide variants.
//
// The run of rules is the rules kernel's own, at the generator's max_len
// (growth past it rejects), in slots of slot_words<Core>() words: 28 for
// SHA-512's 111 bytes and the marker (57,344 bytes of slots a block), 36
// for the 143 of Keccak's rate 144 (73,728 bytes).  The pack writes the
// core's BlockWords<Core>: SHA-512's 32 big-endian words with the bit
// length in word 31 (the low word of its 128-bit length), or the sponge's
// rate / 4 little-endian words, its marker turned into the launch's pad
// byte (0x06 SHA3, 0x01 Keccak) and 0x80 ORed into the rate's last byte.
// A core's 16 target words and the pad byte do not fit RulesArgs, so
// these instantiations take WideRulesArgs, their own kernel
// (rules_wide_kernel) and their own launch overload; the compare (one
// target, the shared-memory probe, the bulk probe) is CompareTail's.
// Its own source keeps the SASS of csrc/rules.cu, rules_nested.cu and
// rules_group.cu as it was.
//
// The salted tails (WideSaltedTail): once a candidate, its 28 message
// words (big-endian; MSSQL's widened to UTF-16LE), "ps" without its
// marker, "sp" moved past the group's salt length with it.  Per target
// of the group: its salt words moved to the candidate's length, a
// funnel shift over a row that holds the salt alone (a compact row, so
// that 256 rows and the slots leave room for two blocks an SM), the bit
// length, sha512_block, digest word 0 compared first.
//
// What bounds it: issue slots, the core's rounds (SHA-512's 80 over
// 64-bit words, Keccak-f's 24 over 25 lanes) a candidate or a pair; the
// rules' interpretation and the pack count as zero in
// ops/opcount.rules_ops and rules_salted_ops.

#include "keccak.cuh"
#include "place.cuh"
#include "rules_kernel.cuh"

// ---- one target or a list -------------------------------------------------

// Kernel parameters of a wide core's launch (mirrored by
// ops/cuda_rules._WideRulesArgs): RulesArgs (its target words unused),
// the 16 target words, the sponge's pad byte.
struct WideRulesArgs : RulesArgs {
    uint32_t wide_target[16];
    uint32_t pad;
};

__device__ __forceinline__ const uint32_t* target_of(const WideRulesArgs& a)
{
    return a.wide_target;
}

__device__ __forceinline__ uint32_t pad_of(const WideRulesArgs& a)
{
    return a.pad;
}

// The sponge asks for three resident blocks an SM (KeccakCore's
// kMinBlocks, as in the mask kernel): without the request ptxas fits two
// of its one-target instantiations in 64 registers and spills.
template <class Core, Compare kMode = kSingle>
__global__ void __launch_bounds__(kThreads, MinBlocks<Core>::value)
rules_wide_kernel(const uint8_t* __restrict__ words,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ bytecode,
                  const int32_t* __restrict__ n_ops,
                  const WideRulesArgs args, int32_t* __restrict__ count,
                  int32_t* __restrict__ lanes, int32_t cap,
                  const MultiArgs multi, int32_t* __restrict__ tpos,
                  int32_t* __restrict__ n_maybe)
{
    CompareTail<Core, kMode, WideRulesArgs> tail{
        args, multi, count, lanes, cap, tpos, n_maybe, nullptr};
    rules_body<Core>(words, lens, bytecode, n_ops, args, tail);
}

template <class Core, Compare kMode>
static int launch(const uint8_t* words, const int32_t* lens,
                  const int32_t* bytecode, const int32_t* n_ops,
                  const WideRulesArgs* args, const MultiArgs* multi,
                  int32_t* count, int32_t* lanes, int32_t* tpos,
                  int32_t* n_maybe, int32_t cap, int grid, size_t smem,
                  cudaStream_t stream)
{
    const cudaError_t err = allow_shared(rules_wide_kernel<Core, kMode>,
                                         smem);
    if (err != cudaSuccess) return (int)err;
    rules_wide_kernel<Core, kMode><<<grid, kThreads, smem, stream>>>(
        words, lens, bytecode, n_ops, *args, count, lanes, cap, *multi, tpos,
        n_maybe);
    return (int)cudaGetLastError();
}

using Keccak224 = KeccakCore<144, 7>;
using Keccak256 = KeccakCore<136, 8>;
using Keccak384 = KeccakCore<104, 12>;
using Keccak512 = KeccakCore<72, 16>;

// core ids (ops/cuda_rules.KERNEL_CORES): 13 sha512, 14 sha384, 15-18 the
// sponge at rates 144, 136, 104, 72 (keccak224..keccak512)
#define DPRF_DISPATCH(CALL)                                               \
    switch (core) {                                                       \
    case 13: return CALL(Sha512Core, kSingle);                            \
    case 14: return CALL(Sha384Core, kSingle);                            \
    case 15: return CALL(Keccak224, kSingle);                             \
    case 16: return CALL(Keccak256, kSingle);                             \
    case 17: return CALL(Keccak384, kSingle);                             \
    case 18: return CALL(Keccak512, kSingle);                             \
    default: return (int)cudaErrorInvalidValue;                           \
    }

// a list's modes: 2 the shared-memory probe, 3 the bulk probe
#define DPRF_LIST_DISPATCH(CALL)                                          \
    switch (core * 4 + mode) {                                            \
    case 54: return CALL(Sha512Core, kProbe);                             \
    case 55: return CALL(Sha512Core, kBulk);                              \
    case 58: return CALL(Sha384Core, kProbe);                             \
    case 59: return CALL(Sha384Core, kBulk);                              \
    case 62: return CALL(Keccak224, kProbe);                              \
    case 63: return CALL(Keccak224, kBulk);                               \
    case 66: return CALL(Keccak256, kProbe);                              \
    case 67: return CALL(Keccak256, kBulk);                               \
    case 70: return CALL(Keccak384, kProbe);                              \
    case 71: return CALL(Keccak384, kBulk);                               \
    case 74: return CALL(Keccak512, kProbe);                              \
    case 75: return CALL(Keccak512, kBulk);                               \
    default: return (int)cudaErrorInvalidValue;                           \
    }

#define DPRF_RULES_ARGS WideRulesArgs
#define DPRF_RULES_KERNEL rules_wide_kernel
#include "rules_entry.cuh"

// ---- the sha512 salted tails ----------------------------------------------

// words of a wide salted target's row (ops/cuda_ext.salted_rule_rows'
// 128-byte layout): the salt as message words from byte 0 ("ps": with the
// 0x80 marker after it) in 9, the digest in 16, the salt's bit length, 2
// words of padding
constexpr int kWideSaltWords = 9;
constexpr int kWideSaltDigest = 9;
constexpr int kWideSaltBits = 25;
// the message words a candidate and its salt reach (111 bytes and the
// marker)
constexpr int kWideSaltedWords = 28;

// Salt word i of a row, 0 outside the salt's words (a clamped read: i
// runs from -1 to the candidate's words).
__device__ __forceinline__ uint32_t salt_word(const uint32_t* row, int i)
{
    const uint32_t x = row[min(max(i, 0), kWideSaltWords - 1)];
    return (unsigned)i < (unsigned)kWideSaltWords ? x : 0u;
}

template <class Core, bool kSp, bool kUtf16>
struct WideSaltedTail {
    // the most targets a group takes (ops/cuda_ext.SALTED_GROUP), a
    // row's words, the shared bytes the tail keeps besides its rows
    static constexpr int kGroup = 256;
    static constexpr int kRow = 28;
    static constexpr int kFixedBytes = 0;
    const GroupArgs& g;
    const uint32_t* s_rows;

    __device__ __forceinline__ void stage(uint32_t* extra)
    {
        s_rows = extra;
        for (int i = threadIdx.x; i < g.n_targets * kRow;
             i += kThreads)
            extra[i] = g.rows[i];
    }

    __device__ __forceinline__ void take(Slots W, int n, int32_t lane)
    {
        // the candidate's big-endian message words, every byte past it
        // zero: "ps" without its marker, whose place the salt takes
        uint32_t c[kWideSaltedWords];
        if constexpr (kUtf16) {
#pragma unroll
            for (int k = 0; k < kWideSaltedWords / 2; ++k) {
                const uint32_t x = W.at(k) & below(k, n);
                c[2 * k] = __byte_perm(x, 0, 0x0414);
                c[2 * k + 1] = __byte_perm(x, 0, 0x2434);
            }
        } else {
#pragma unroll
            for (int k = 0; k < kWideSaltedWords; ++k)
                c[k] = __byte_perm(kSp ? W.at(k) : W.at(k) & below(k, n), 0,
                                   0x0123);
        }
        const int w = kUtf16 ? 2 * n : n;   // the candidate's message bytes
        uint32_t bits = 0;
        if constexpr (kSp) {
            move_candidate<Core, kWideSaltedWords>(c, g.shift);
            bits = 8u * (uint32_t)(g.shift + w);
        }
        const int a = w >> 2;
        const uint32_t r = 8u * (uint32_t)(w & 3);
        for (int t = 0; t < g.n_targets; ++t) {
            const uint32_t* row = s_rows + t * kRow;
            uint32_t m[32];
#pragma unroll
            for (int j = 0; j < kWideSaltedWords; ++j) {
                if constexpr (kSp) {
                    m[j] = c[j] | (j < kWideSaltWords ? row[j] : 0u);
                } else {
                    // the salt and its marker moved to byte w: word j
                    // takes salt words j - a - 1 and j - a
                    m[j] = c[j] | __funnelshift_r(salt_word(row, j - a),
                                                  salt_word(row, j - a - 1),
                                                  r);
                }
            }
            if constexpr (!kSp) bits = row[kWideSaltBits] + 8u * (uint32_t)w;
            m[28] = 0u;
            m[29] = 0u;
            m[30] = 0u;
            m[31] = bits;
            uint32_t dg[Core::kWords];
            Core::digest(m, dg);
            if (dg[0] != row[kWideSaltDigest]) continue;
            bool hit = true;
#pragma unroll
            for (int i = 1; i < Core::kWords; ++i)
                hit &= dg[i] == row[kWideSaltDigest + i];
            if (hit) append_hit(g, t, lane);
        }
    }
};

using Sha512Ps = WideSaltedTail<Sha512Core, false, false>;
using Sha512Sp = WideSaltedTail<Sha512Core, true, false>;
using Sha512PsUtf16 = WideSaltedTail<Sha512Core, false, true>;

// tail ids (ops/cuda_rules.GROUP_TAILS): 8 sha512-ps, 9 sha512-sp,
// 10 sha512-ps-utf16, each with the core its slots hold the candidate for
#define DPRF_GROUP_DISPATCH(CALL)                                         \
    switch (tail) {                                                       \
    case 8: return CALL(Sha512Core, Sha512Ps);                            \
    case 9: return CALL(Sha512Core, Sha512Sp);                            \
    case 10: return CALL(Sha512Core, Sha512PsUtf16);                      \
    default: return (int)cudaErrorInvalidValue;                           \
    }

#include "rules_group_entry.cuh"
