// mask_md5.cu -- the fused mask -> MD5 -> compare kernel for Hopper (sm_90a).
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_mask.py
// (make_mask_pallas_fn / _build_kernel_body) for the md5 core with one
// target and no window offset.  Per candidate: decode the mixed-radix
// keyspace index into charset bytes, pack one padded 64-byte block, run
// the 64 MD5 steps and the feed-forward, compare the digest with the
// target.  The TPU kernel's (8, 128) packed (count << 16) | (hit_lane + 1)
// output and its one-hit-lane-per-tile rule exist only for Mosaic and
// are not carried over: every hit appends its lane here.
//
// What bounds it: the INT32 issue rate, not memory.  A candidate reads
// no device memory (the charset table sits in shared memory; base
// digits, radices and the target are kernel parameters) and writes
// ~0 bytes (only a hit writes a lane), while it costs at least ~230
// 32-bit integer instructions at a 6-position mask
// (dprf_tpu_torch/ops/cuda_mask.ops_per_candidate counts them from this
// source in Hopper's instruction forms: LOP3, IADD3, LEA.HI, with the
// message words that no candidate changes folded into the constants).
//
// What the design does about it: one thread per candidate in a
// grid-stride loop, everything in registers.  The 64 MD5 steps are
// fully unrolled, so message words, constants and shift counts are
// register or immediate operands and nothing spills to local memory;
// the decode enters an unrolled run of positions through one
// warp-uniform switch on the mask length, so only the mask's own
// positions cost instructions.  Rotates are single funnel shifts.  No
// reduction: a candidate that misses spends no instruction on output.
// Left for later: odometer increments instead of the per-candidate
// div/mod, several candidates per thread, hand-written LOP3 round
// functions, the early-exit compare after step 60, and folding the
// job's constant message words and the feed-forward into constants.

#include <cstdint>
#include <cuda_runtime.h>

#define DPRF_MAX_LEN 55

// Kernel parameters of one job (mirrored by ops/cuda_mask._MaskArgs).
struct MaskArgs {
    int32_t length;
    int32_t radix[DPRF_MAX_LEN];
    int32_t base[DPRF_MAX_LEN];
};

// floor(abs(sin(i + 1)) * 2^32), RFC 1321; the PyTorch version computes
// the same table from math.sin (ops/md5.K) and a test holds them equal.
__constant__ uint32_t K_MD5[64] = {
    0xd76aa478u, 0xe8c7b756u, 0x242070dbu, 0xc1bdceeeu,
    0xf57c0fafu, 0x4787c62au, 0xa8304613u, 0xfd469501u,
    0x698098d8u, 0x8b44f7afu, 0xffff5bb1u, 0x895cd7beu,
    0x6b901122u, 0xfd987193u, 0xa679438eu, 0x49b40821u,
    0xf61e2562u, 0xc040b340u, 0x265e5a51u, 0xe9b6c7aau,
    0xd62f105du, 0x02441453u, 0xd8a1e681u, 0xe7d3fbc8u,
    0x21e1cde6u, 0xc33707d6u, 0xf4d50d87u, 0x455a14edu,
    0xa9e3e905u, 0xfcefa3f8u, 0x676f02d9u, 0x8d2a4c8au,
    0xfffa3942u, 0x8771f681u, 0x6d9d6122u, 0xfde5380cu,
    0xa4beea44u, 0x4bdecfa9u, 0xf6bb4b60u, 0xbebfbc70u,
    0x289b7ec6u, 0xeaa127fau, 0xd4ef3085u, 0x04881d05u,
    0xd9d4d039u, 0xe6db99e5u, 0x1fa27cf8u, 0xc4ac5665u,
    0xf4292244u, 0x432aff97u, 0xab9423a7u, 0xfc93a039u,
    0x655b59c3u, 0x8f0ccc92u, 0xffeff47du, 0x85845dd1u,
    0x6fa87e4fu, 0xfe2ce6e0u, 0xa3014314u, 0x4e0811a1u,
    0xf7537e82u, 0xbd3af235u, 0x2ad7d2bbu, 0xeb86d391u,
};

#define MD5_A0 0x67452301u
#define MD5_B0 0xefcdab89u
#define MD5_C0 0x98badcfeu
#define MD5_D0 0x10325476u

// One mask position q (a compile-time constant): digit = (base + carry)
// mod radix, carry = (base + carry) div radix, and the charset byte goes
// into byte q of the little-endian message block.
#define DPRF_POS(q)                                                       \
    {                                                                     \
        const uint32_t s = (uint32_t)args.base[q] + carry;                \
        const uint32_t r = (uint32_t)args.radix[q];                       \
        carry = s / r;                                                    \
        const uint32_t digit = s - carry * r;                             \
        m[(q) >> 2] |= (uint32_t)s_lut[(q) * 256 + digit]                 \
                       << (8 * ((q) & 3));                                \
    }

__global__ void __launch_bounds__(256)
mask_md5_kernel(const uint8_t* __restrict__ lut, const MaskArgs args,
                uint32_t n_valid, uint32_t t0, uint32_t t1, uint32_t t2,
                uint32_t t3, int32_t* __restrict__ count,
                int32_t* __restrict__ lanes, int32_t cap)
{
    // per-position 256-byte charset tables, uint8[length][256]
    extern __shared__ uint8_t s_lut[];
    const int L = args.length;
    for (int i = threadIdx.x; i < L * 256; i += blockDim.x)
        s_lut[i] = lut[i];
    __syncthreads();

    const uint32_t pad = 0x80u << (8 * (L & 3));
    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t gidx = blockIdx.x * blockDim.x + threadIdx.x;
         gidx < n_valid; gidx += stride) {
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = 0u;

        // decode, last (least significant) position first; the switch
        // enters the unrolled run at position L - 1
        uint32_t carry = gidx;
        switch (L) {
        case 55: DPRF_POS(54)  case 54: DPRF_POS(53)  case 53: DPRF_POS(52)
        case 52: DPRF_POS(51)  case 51: DPRF_POS(50)  case 50: DPRF_POS(49)
        case 49: DPRF_POS(48)  case 48: DPRF_POS(47)  case 47: DPRF_POS(46)
        case 46: DPRF_POS(45)  case 45: DPRF_POS(44)  case 44: DPRF_POS(43)
        case 43: DPRF_POS(42)  case 42: DPRF_POS(41)  case 41: DPRF_POS(40)
        case 40: DPRF_POS(39)  case 39: DPRF_POS(38)  case 38: DPRF_POS(37)
        case 37: DPRF_POS(36)  case 36: DPRF_POS(35)  case 35: DPRF_POS(34)
        case 34: DPRF_POS(33)  case 33: DPRF_POS(32)  case 32: DPRF_POS(31)
        case 31: DPRF_POS(30)  case 30: DPRF_POS(29)  case 29: DPRF_POS(28)
        case 28: DPRF_POS(27)  case 27: DPRF_POS(26)  case 26: DPRF_POS(25)
        case 25: DPRF_POS(24)  case 24: DPRF_POS(23)  case 23: DPRF_POS(22)
        case 22: DPRF_POS(21)  case 21: DPRF_POS(20)  case 20: DPRF_POS(19)
        case 19: DPRF_POS(18)  case 18: DPRF_POS(17)  case 17: DPRF_POS(16)
        case 16: DPRF_POS(15)  case 15: DPRF_POS(14)  case 14: DPRF_POS(13)
        case 13: DPRF_POS(12)  case 12: DPRF_POS(11)  case 11: DPRF_POS(10)
        case 10: DPRF_POS(9)   case 9: DPRF_POS(8)    case 8: DPRF_POS(7)
        case 7: DPRF_POS(6)    case 6: DPRF_POS(5)    case 5: DPRF_POS(4)
        case 4: DPRF_POS(3)    case 3: DPRF_POS(2)    case 2: DPRF_POS(1)
        case 1: DPRF_POS(0)
        default: break;
        }
        // MD padding: 0x80 at byte L, the bit length in word 14
        switch (L >> 2) {
        case 0: m[0] |= pad; break;    case 1: m[1] |= pad; break;
        case 2: m[2] |= pad; break;    case 3: m[3] |= pad; break;
        case 4: m[4] |= pad; break;    case 5: m[5] |= pad; break;
        case 6: m[6] |= pad; break;    case 7: m[7] |= pad; break;
        case 8: m[8] |= pad; break;    case 9: m[9] |= pad; break;
        case 10: m[10] |= pad; break;  case 11: m[11] |= pad; break;
        case 12: m[12] |= pad; break;  default: m[13] |= pad; break;
        }
        m[14] = 8u * (uint32_t)L;

        const int S[4][4] = {{7, 12, 17, 22}, {5, 9, 14, 20},
                             {4, 11, 16, 23}, {6, 10, 15, 21}};
        uint32_t a = MD5_A0, b = MD5_B0, c = MD5_C0, d = MD5_D0;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            uint32_t f;
            int g;
            if (i < 16) {
                f = d ^ (b & (c ^ d));        // (b & c) | (~b & d)
                g = i;
            } else if (i < 32) {
                f = c ^ (d & (b ^ c));        // (d & b) | (~d & c)
                g = (5 * i + 1) & 15;
            } else if (i < 48) {
                f = b ^ c ^ d;
                g = (3 * i + 5) & 15;
            } else {
                f = c ^ (b | ~d);
                g = (7 * i) & 15;
            }
            const uint32_t tmp = a + f + K_MD5[i] + m[g];
            a = d;
            d = c;
            c = b;
            b = b + __funnelshift_l(tmp, tmp, S[i >> 4][i & 3]);
        }
        a += MD5_A0;
        b += MD5_B0;
        c += MD5_C0;
        d += MD5_D0;
        if (a == t0 && b == t1 && c == t2 && d == t3) {
            const int32_t slot = atomicAdd(count, 1);
            if (slot < cap) lanes[slot] = (int32_t)gidx;
        }
    }
}

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  count must hold 0 and lanes -1
// on entry (the wrapper allocates them so).
extern "C" int dprf_mask_md5_launch(int device, const uint8_t* lut,
                                    const MaskArgs* args, uint32_t n_valid,
                                    uint32_t t0, uint32_t t1, uint32_t t2,
                                    uint32_t t3, int32_t* count,
                                    int32_t* lanes, int32_t cap, int grid,
                                    int threads, void* stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)args->length * 256;
    mask_md5_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        lut, *args, n_valid, t0, t1, t2, t3, count, lanes, cap);
    return (int)cudaGetLastError();
}
