// compare.cuh -- the multi-target compare that the mask kernel template
// (csrc/mask_kernel.cuh) and the rules kernel (csrc/rules.cu) share: the
// compare modes, the blocked probe and the exact verify against the
// sorted target table.
//
// The blocked probe is the reference's (dprf_tpu/targets/probe.py,
// bloom_fill / probe_block_found): each target set k bits of one 512-bit
// block, picked by dg[0] * 0x9E3779B1 >> (32 - block_bits); a candidate
// tests the k double-hashed bits of its own block, alternating the
// (dg[0], dg[1] | 1) and (dg[2], dg[3] | 1) pairs, and stops at the
// first miss -- O(1) a candidate whatever the list length.  Its bitmap
// sits in shared memory for kProbe (at most 64 KiB, staged by each
// block) and in global memory for kBulk, a bulk list's bitmap of any
// size (4 MB at 10^6 targets, 32 MB at 10^7: L2-resident up to the
// H100's 50 MB), read through the read-only data path (__ldg).  Every
// candidate reads the first word it tests (one 32-byte sector of its
// block) and most stop there: the bit is set with the bitmap's fill,
// ~0.2 at the bulk table's sizing.
//
// The exact verify: a survivor binary-searches digest word 0 in the
// sorted table (ops/compare.make_target_table's layout, in device
// memory), walks the run of equal word-0 entries and compares whole
// digests; only real hits are appended, with their table position.  A
// bulk list whose table did not fit the card's byte budget (the
// reference's host-verify layout) has no table: each survivor is
// appended with position -1, and the worker confirms it with the oracle.

#pragma once

#include <cstdint>

// the blocked probe (targets/probe.py): 16-word blocks, the most bits a
// candidate tests, the block hash's multiplier
#define DPRF_PROBE_BLOCK_WORDS 16
#define DPRF_PROBE_MAX_K 8
#define DPRF_PROBE_GOLDEN 0x9E3779B1u

// The compare of an instantiation: one target, the per-set Bloom
// prefilter, the blocked probe in shared memory, or the bulk probe in
// global memory (the last three verify on the card; mirrored by
// ops/cuda_mask.MODES).
enum Compare : int { kSingle = 0, kSets = 1, kProbe = 2, kBulk = 3 };

// The multi-target state (mirrored by ops/cuda_mask.MultiArgs).
struct MultiArgs {
    // the prefilter's words: kSets uint32[n_sets * 8][128]
    // (bloom_tables), kProbe and kBulk uint32[16 << block_bits]
    // (bloom_fill)
    const uint32_t* bloom;
    // uint32[n_targets][words], sorted; kBulk: null in the host-verify
    // layout
    const uint32_t* table;
    int32_t n_sets;           // kSets: the Bloom sets
    int32_t n_targets;
    int32_t block_bits;       // kProbe, kBulk: log2 of the bitmap's blocks
    int32_t k;                // kProbe, kBulk: bits a candidate tests, 1..8
};

// The reference's probe_block_found for one lane: all k bits of the
// lane's block, tested in bloom_fill's order, stopping at the first
// miss.  A core of fewer than 4 words reuses its first pair.  kGlobal:
// the bitmap is in global memory, read with __ldg.
template <int W, bool kGlobal = false>
__device__ __forceinline__ bool probe_maybe(const uint32_t* dg,
                                            const uint32_t* s_probe,
                                            int block_bits, int k)
{
    const uint32_t h1 = dg[0], h2 = dg[1] | 1u;
    const uint32_t h3 = dg[W > 3 ? 2 : 0], h4 = dg[W > 3 ? 3 : 1] | 1u;
    const uint32_t block =
        block_bits ? (h1 * DPRF_PROBE_GOLDEN) >> (32 - block_bits) : 0u;
    const uint32_t* words = s_probe + block * DPRF_PROBE_BLOCK_WORDS;
#pragma unroll
    for (int j = 0; j < DPRF_PROBE_MAX_K; ++j) {
        if (j >= k) break;
        const uint32_t g = (j & 1 ? h3 : h1)
                           + (uint32_t)(2 * (j >> 1) + 1) * (j & 1 ? h4 : h2);
        const uint32_t bit = g & (DPRF_PROBE_BLOCK_WORDS * 32 - 1);
        uint32_t word;
        if constexpr (kGlobal)
            word = __ldg(words + (bit >> 5));
        else
            word = words[bit >> 5];
        if (!((word >> (bit & 31)) & 1u)) return false;
    }
    return true;
}

// Position of the digest in the sorted table, or -1: the lower bound of
// word 0, then the run of equal word-0 entries compared in full.
template <int W>
__device__ __forceinline__ int find_target(const uint32_t* dg,
                                           const uint32_t* __restrict__ table,
                                           int n)
{
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (table[mid * W] < dg[0]) lo = mid + 1;
        else hi = mid;
    }
    for (int i = lo; i < n && table[i * W] == dg[0]; ++i) {
        bool eq = true;
#pragma unroll
        for (int k = 1; k < W; ++k) eq &= table[i * W + k] == dg[k];
        if (eq) return i;
    }
    return -1;
}

// A bulk survivor's table position: find_target's, or -1 with no table
// (the host-verify layout: every survivor is reported).  Returns whether
// the lane is reported.
template <int W>
__device__ __forceinline__ bool bulk_verify(const uint32_t* dg,
                                            const MultiArgs& multi,
                                            int* pos)
{
    if (multi.table == nullptr) {
        *pos = -1;
        return true;
    }
    *pos = find_target<W>(dg, multi.table, multi.n_targets);
    return *pos >= 0;
}
