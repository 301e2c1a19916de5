// rules_group.cu -- the fused wordlist+rules kernel (rules_kernel.cuh) over
// a group of targets a launch: the salted cores ($pass.$salt, "ps", and
// $salt.$pass, "sp", for md5, sha1 and sha256; sha1 over the UTF-16LE
// candidate and a salt for MSSQL) and Kerberos etype 23 (RC4-HMAC).
//
// Replaces no TPU kernel: the reference runs these wordlists on XLA only
// (engines/device/salted.py make_salted_wordlist_step, one target a
// step; engines/device/krb5.py make_krb5_wordlist_step and
// krb5_filter_batch, one ticket a step).  The mask path's counterparts
// are csrc/salted.cuh (which replaces pallas_ext.py's salted kernel) and
// csrc/krb5.cu (pallas_krb5.py's).
//
// The run of rules is the rules kernel's own (rules_body); what follows
// it is a tail, which hashes each kept candidate with every target of
// the launch's group, the work that does not depend on the target done
// once a candidate:
//
// - SaltedTail: a group is every "ps" target, or the "sp" targets of
//   one salt length (ops/cuda_ext.salted_groups).  Once a candidate: its
//   message words -- for "ps" without the 0x80 marker, whose place the
//   salt takes; MSSQL's widened to UTF-16LE, and for MSSQL 2000 (a launch
//   flag) uppercased in ASCII first, as the reference's pre_salt does --
//   and for "sp" their move past the group's salt length, the marker
//   moving with them.  Per target: its salt words ORed in ("ps": moved
//   to the candidate's length by funnel shifts over the row, whose zero
//   words around the salt make every read in range), the bit length,
//   the core, digest word 0 compared first.  The candidate's length
//   varies per lane, so its salt's offset does: the mask path's rows fix
//   it per launch, these fix it per candidate.
// - Krb5Tail: once a candidate, the NT hash of its UTF-16LE bytes, K1 =
//   HMAC-MD5(NT, msg_type) and K1's HMAC key states; per ticket of a
//   group of one msg_type, K3 = HMAC-MD5(K1, checksum), RC4's key
//   schedule and 12 keystream bytes in the thread's state in shared
//   memory (csrc/rc4.cuh), and the masked compare of plaintext bytes
//   8-11 with the ticket's predicted DER header (csrc/krb5.cu's test).
//   A survivor is a maybe that the worker confirms with the oracle.
//
// Every (lane, target) hit appends its target position and counts for
// its target, so an overflowing launch is rescanned for the targets
// whose own count its recorded hits miss, and for those only.
//
// What bounds it: issue slots, as for the salted kernel and krb5.cu: a
// pair's core (salted), or a pair's two MD5 compressions and RC4's 268
// steps, each a few dependent shared-memory accesses (krb5); the rules'
// interpretation is paid once a candidate, shared by the group.
// ops/opcount.rules_salted_ops and rules_krb5_bound count the least work.

#include "rules_kernel.cuh"

#include "krb5.cuh"
#include "place.cuh"

// words of a salted target's row (ops/cuda_rules.salted_rows): 14 zero
// words, the salt as message words from byte 0 ("ps": with the 0x80
// marker after it) in 9, 5 zero words, the digest in 8, the salt's bit
// length, 3 words of padding
constexpr int kSaltAt = 14;
constexpr int kSaltWords = 9;
constexpr int kSaltDigest = 28;
constexpr int kSaltBits = 36;
// the message words a candidate and its salt reach (55 bytes and the
// marker)
constexpr int kSaltedWords = 14;
// bytes of RC4 state a block keeps in shared memory
constexpr int kRc4Bytes = 256 * kThreads;

// ---- the salted tail -------------------------------------------------------

template <class Core, bool kSp, bool kUtf16>
struct SaltedTail {
    // the most targets a group takes (ops/cuda_ext.SALTED_GROUP), a
    // row's words, the shared bytes the tail keeps besides its rows
    static constexpr int kGroup = 256;
    static constexpr int kRow = 40;
    static constexpr int kFixedBytes = 0;
    static constexpr bool kBigEndian = Core::shift(0) != 0;
    const GroupArgs& g;
    const uint32_t* s_rows;

    __device__ __forceinline__ void stage(uint32_t* extra)
    {
        s_rows = extra;
        for (int i = threadIdx.x; i < g.n_targets * kRow;
             i += kThreads)
            extra[i] = g.rows[i];
    }

    // a word of message bytes in the slots' order (byte q at bits
    // 8 * (q & 3)) in the core's
    __device__ __forceinline__ static uint32_t message(uint32_t x)
    {
        return kBigEndian ? __byte_perm(x, 0, 0x0123) : x;
    }

    __device__ __forceinline__ void take(Slots W, int n, int32_t lane)
    {
        // the candidate's message words, every byte past it zero: "ps"
        // without its marker, whose place the salt takes
        uint32_t c[kSaltedWords];
        if constexpr (kUtf16) {
#pragma unroll
            for (int k = 0; k < kSaltedWords / 2; ++k) {
                uint32_t x = W.at(k) & below(k, n);
                if (g.upper) x = swar_upper(x);
                c[2 * k] = message(__byte_perm(x, 0, 0x4140));
                c[2 * k + 1] = message(__byte_perm(x, 0, 0x4342));
            }
        } else {
#pragma unroll
            for (int k = 0; k < kSaltedWords; ++k)
                c[k] = message(kSp ? W.at(k) : W.at(k) & below(k, n));
        }
        const int w = kUtf16 ? 2 * n : n;   // the candidate's message bytes
        uint32_t bits = 0;
        if constexpr (kSp) {
            move_candidate<Core, kSaltedWords>(c, g.shift);
            bits = 8u * (uint32_t)(g.shift + w);
        }
        const int a = w >> 2;
        const uint32_t r = 8u * (uint32_t)(w & 3);
        for (int t = 0; t < g.n_targets; ++t) {
            const uint32_t* row = s_rows + t * kRow;
            uint32_t m[16];
            if constexpr (kSp) {
#pragma unroll
                for (int j = 0; j < kSaltedWords; ++j)
                    m[j] = c[j] | (j < kSaltWords ? row[kSaltAt + j] : 0u);
            } else {
                // the salt and its marker moved to byte w
                const uint32_t* p = row + kSaltAt - a;
#pragma unroll
                for (int j = 0; j < kSaltedWords; ++j) {
                    const uint32_t lo = p[j - 1], hi = p[j];
                    m[j] = c[j] | (kBigEndian ? __funnelshift_r(hi, lo, r)
                                              : __funnelshift_l(lo, hi, r));
                }
                bits = row[kSaltBits] + 8u * (uint32_t)w;
            }
            m[14] = 0u;
            m[15] = 0u;
            m[Core::kLenWord] = bits;
            uint32_t dg[Core::kWords];
            Core::digest(m, dg);
            if (dg[0] != row[kSaltDigest]) continue;
            bool hit = true;
#pragma unroll
            for (int i = 1; i < Core::kWords; ++i)
                hit &= dg[i] == row[kSaltDigest + i];
            if (hit) append_hit(g, t, lane);
        }
    }
};

// ---- the Kerberos tail ----------------------------------------------------

struct Krb5Tail {
    static constexpr int kGroup = DPRF_KRB5_GROUP;
    static constexpr int kRow = DPRF_KRB5_ROW;
    static constexpr int kFixedBytes = kRc4Bytes;
    const GroupArgs& g;
    const uint32_t* s_rows;
    uint8_t* s;   // the thread's RC4 state

    __device__ __forceinline__ void stage(uint32_t* extra)
    {
        s = reinterpret_cast<uint8_t*>(extra) + 4 * threadIdx.x;
        uint32_t* rows = extra + kRc4Bytes / 4;
        s_rows = rows;
        for (int i = threadIdx.x; i < g.n_targets * kRow;
             i += kThreads)
            rows[i] = g.rows[i];
    }

    __device__ __forceinline__ void take(Slots W, int n, int32_t lane)
    {
        uint32_t m[16], nt[4], ist[4], ost[4], k1[4];
        pack<Md4Core, slot_words<Md4Core>()>(W, n, m);
        Md4Core::digest(m, nt);
        hmac_md5_keys(nt, ist, ost);
        hmac_md5_msg<1>(ist, ost, &g.msg_type, k1);
        hmac_md5_keys(k1, ist, ost);
        for (int t = 0; t < g.n_targets; ++t) {
            const uint32_t* row = s_rows + t * kRow;
            const uint32_t msg[4] = {row[0], row[1], row[2], row[3]};
            uint32_t k3[4];
            hmac_md5_msg<4>(ist, ost, msg, k3);
            const uint32_t plain = rc4_word2(s, k3) ^ row[4];
            if ((plain & row[5]) == row[6]) append_hit(g, t, lane);
        }
    }
};

using Md5Ps = SaltedTail<Md5Core, false, false>;
using Md5Sp = SaltedTail<Md5Core, true, false>;
using Sha1Ps = SaltedTail<Sha1Core, false, false>;
using Sha1Sp = SaltedTail<Sha1Core, true, false>;
using Sha256Ps = SaltedTail<Sha256Core, false, false>;
using Sha256Sp = SaltedTail<Sha256Core, true, false>;
using Sha1PsUtf16 = SaltedTail<Sha1Core, false, true>;

// tail ids (ops/cuda_rules.GROUP_TAILS): 0 md5-ps, 1 md5-sp, 2 sha1-ps,
// 3 sha1-sp, 4 sha256-ps, 5 sha256-sp, 6 sha1-ps-utf16, 7 krb5, each
// with the core its slots hold the candidate for
#define DPRF_GROUP_DISPATCH(CALL)                                         \
    switch (tail) {                                                       \
    case 0: return CALL(Md5Core, Md5Ps);                                  \
    case 1: return CALL(Md5Core, Md5Sp);                                  \
    case 2: return CALL(Sha1Core, Sha1Ps);                                \
    case 3: return CALL(Sha1Core, Sha1Sp);                                \
    case 4: return CALL(Sha256Core, Sha256Ps);                            \
    case 5: return CALL(Sha256Core, Sha256Sp);                            \
    case 6: return CALL(Sha1Core, Sha1PsUtf16);                           \
    case 7: return CALL(Md4Core, Krb5Tail);                               \
    default: return (int)cudaErrorInvalidValue;                           \
    }

#include "rules_group_entry.cuh"
