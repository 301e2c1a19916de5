// krb5.cu -- the Kerberos etype-23 (RC4-HMAC) prefilter kernel for
// Hopper (sm_90a): mask decode -> UTF-16LE -> MD4 (the NT hash) ->
// HMAC-MD5(NT, msg_type) -> HMAC-MD5(K1, checksum) -> RC4 key schedule
// under K3 and 12 keystream bytes -> a masked compare of plaintext bytes
// 8-11 with the ticket's predicted DER header, for a group of tickets a
// launch.
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_krb5.py
// (make_krb5_pallas_fn, pl.pallas_call at :260; its body _build_body,
// the RC4 of _rc4_word2, the HMACs of _hmac_md5), which serves one
// ticket a launch.  The plaintext of a ticket is an 8-byte random
// confounder and then the DER-encoded ticket, whose first four bytes --
// the [APPLICATION n] tag, the length's form, the SEQUENCE tag -- follow
// from len(edata2) alone (engines/device/krb5.der_filter_words).  So a
// candidate survives when (keystream[8:12] ^ edata2[8:12]) & mask ==
// expected: a 32-bit test (30 bits for AS-REP, whose tag byte is matched
// under 0xFC).  The worker confirms every survivor with the oracle's
// full RFC 4757 check.
//
// A launch serves a group of up to DPRF_KRB5_GROUP tickets of one
// msg_type (2 for krb5tgs, 8 for krb5asrep): the msg_type is a launch
// parameter, each ticket's checksum, edata2[8:12], mask and expectation
// a row in shared memory.  The work splits where it stops depending on
// the ticket.  Per candidate, once: the decode (by reciprocals,
// DPRF_DECODE_RCP), the NT hash, K1 = HMAC-MD5(NT, msg_type) and the
// ipad / opad states of K1.  Per ticket: the HMAC's inner and outer
// compressions over the checksum (K3), RC4's key schedule and 12 output
// steps, the masked compare.  Every survivor appends (lane, ticket
// position) and counts for its ticket; count > cap sends the batch to
// the worker, which rescans exactly every ticket whose own count its
// recorded lanes do not cover.
//
// What bounds it: shared memory, then issue slots.  Per (candidate,
// ticket) RC4's 256 key schedule and 12 output steps, each a dependent
// chain of a shared load of S[i], an add for j, a shared load of S[j]
// and two shared stores, and two MD5 compressions; per candidate one MD4
// block and six MD5 compressions, shared by the group.
// ops/opcount.krb5_ops and krb5_bound count both limits.  It reads no
// device memory but its charset tables and ticket rows and writes only
// hits.
//
// What the design does about it: one thread per candidate in a
// grid-stride loop, looping over the group's tickets.  The NT hash, K1
// and its HMAC states stay in registers across the tickets, and both
// HMACs' padding words (the 0x80 marker, zeros, the bit lengths (64 +
// 4) * 8 and (64 + 16) * 8) are constants, so their terms fold.  Each
// thread's RC4 state lives in shared memory, 256 bytes a thread, in the
// conflict-free layout of csrc/rc4.cuh (shared with csrc/pdf.cu).  A
// 256-thread block takes 64 KB of it, past the 48 KB a launch gets
// without asking, so the launch raises its limit; the group's rows
// (32 bytes a ticket, at most 4 KB) leave three blocks an SM.  The key
// schedule is unrolled in full: the key byte K3[i % 16] is an extract
// at a constant position and S[i]'s address a constant offset, so
// nothing is indexed in registers and there is no stack frame.

#include <cstdint>
#include <cuda_runtime.h>

#include "decode.cuh"

constexpr int kThreads = 256;

#include "krb5.cuh"

// bytes of RC4 state a block keeps in shared memory
constexpr int kRc4Bytes = 256 * kThreads;

// Kernel parameters of one launch (mirrored by ops/cuda_krb5._Args).
struct Krb5Args {
    int32_t length;
    int32_t radix[DPRF_KRB5_MAX_LEN];
    int32_t base[DPRF_KRB5_MAX_LEN];
    // the decode's reciprocals (decode.cuh, DPRF_DECODE_RCP)
    uint32_t rcp[DPRF_KRB5_MAX_LEN];
    int32_t rsh[DPRF_KRB5_MAX_LEN];
    // the widened candidate's fixed block words: the 0x80 marker and the
    // bit length (ops/cuda_mask.message_block("ntlm", length))
    uint32_t block[16];
    // the group's msg_type and its tickets
    uint32_t msg_type;
    int32_t n_targets;
};

__global__ void __launch_bounds__(kThreads)
krb5_kernel(const uint8_t* __restrict__ lut, const Krb5Args args,
            const uint32_t* __restrict__ rows, uint32_t n_valid,
            int32_t* __restrict__ count, int32_t* __restrict__ lanes,
            int32_t* __restrict__ tpos, int32_t* __restrict__ tcount,
            int32_t cap)
{
    // the RC4 states, the tickets' rows, then the per-position 256-byte
    // charset tables
    extern __shared__ __align__(16) uint8_t smem[];
    const int L = args.length, T = args.n_targets;
    uint32_t* s_rows = reinterpret_cast<uint32_t*>(smem + kRc4Bytes);
    uint8_t* s_lut = smem + kRc4Bytes + T * DPRF_KRB5_ROW * 4;
    for (int i = threadIdx.x; i < T * DPRF_KRB5_ROW; i += blockDim.x)
        s_rows[i] = rows[i];
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    __syncthreads();
    uint8_t* s = smem + 4 * threadIdx.x;

    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t gidx = blockIdx.x * blockDim.x + threadIdx.x;
         gidx < n_valid; gidx += stride) {
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = args.block[i];
        uint32_t carry = gidx;
        DPRF_DECODE_RCP(Md4Core, DPRF_KRB5_MAX_LEN, L);

        uint32_t nt[4], ist[4], ost[4], k1[4];
        Md4Core::digest(m, nt);
        hmac_md5_keys(nt, ist, ost);
        hmac_md5_msg<1>(ist, ost, &args.msg_type, k1);
        hmac_md5_keys(k1, ist, ost);

        for (int t = 0; t < T; ++t) {
            const uint32_t* row = s_rows + t * DPRF_KRB5_ROW;
            const uint4 chk = reinterpret_cast<const uint4*>(row)[0];
            const uint4 cmp = reinterpret_cast<const uint4*>(row)[1];
            const uint32_t msg[4] = {chk.x, chk.y, chk.z, chk.w};
            uint32_t k3[4];
            hmac_md5_msg<4>(ist, ost, msg, k3);
            const uint32_t plain = rc4_word2(s, k3) ^ cmp.x;
            if ((plain & cmp.y) == cmp.z) {
                atomicAdd(tcount + t, 1);
                const int32_t slot = atomicAdd(count, 1);
                if (slot < cap) {
                    lanes[slot] = (int32_t)gidx;
                    tpos[slot] = t;
                }
            }
        }
    }
}

// ---- the C interface ---------------------------------------------------

static cudaError_t raise_smem_limit(int smem)
{
    return cudaFuncSetAttribute(krb5_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
}

// Dynamic shared memory of one block at `length` positions and
// `n_targets` tickets (ops/cuda_krb5.shared_bytes).
static int shared_bytes(int length, int n_targets)
{
    return kRc4Bytes + n_targets * DPRF_KRB5_ROW * 4 + 256 * length;
}

// Launch over a group of args->n_targets tickets (rows:
// uint32[n_targets][DPRF_KRB5_ROW] in device memory) on the caller's
// stream without synchronising; returns the launch's cudaError_t (0 =
// launched).  count and tcount must hold 0 and lanes -1 on entry (the
// wrapper allocates them so).  `threads` must be kThreads.
extern "C" int dprf_krb5_launch(int device, const uint8_t* lut,
                                const Krb5Args* args, const uint32_t* rows,
                                uint32_t n_valid, int32_t* count,
                                int32_t* lanes, int32_t* tpos,
                                int32_t* tcount, int32_t cap, int grid,
                                int threads, void* stream)
{
    if (threads != kThreads) return (int)cudaErrorInvalidValue;
    if (args->length < 1 || args->length > DPRF_KRB5_MAX_LEN
        || args->n_targets < 1 || args->n_targets > DPRF_KRB5_GROUP)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int smem = shared_bytes(args->length, args->n_targets);
    err = raise_smem_limit(smem);
    if (err != cudaSuccess) return (int)err;
    krb5_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        lut, *args, rows, n_valid, count, lanes, tpos, tcount, cap);
    return (int)cudaGetLastError();
}

// Resident blocks of kThreads threads per SM at `smem` bytes of dynamic
// shared memory (the grid's size).
extern "C" int dprf_krb5_blocks_per_sm(int smem, int* blocks)
{
    cudaError_t err = raise_smem_limit(smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, krb5_kernel, kThreads, (size_t)smem);
}
