// rules_group_entry.cuh -- the C interface of the rules kernel's group
// tails (ops/cuda_rules.py) over the tails that the including source
// names.  The source defines DPRF_GROUP_DISPATCH(CALL) (a switch over
// `tail` returning CALL(CoreType, TailType)), then includes this after
// rules_kernel.cuh.

#pragma once

// Dynamic shared memory of one block of tail `tail` over n_targets
// targets.
extern "C" int dprf_rules_group_shared_bytes(int tail, int n_targets,
                                             int* bytes)
{
#define DPRF_SMEM(C, T) group_smem_of<C, T>(n_targets, bytes)
    DPRF_GROUP_DISPATCH(DPRF_SMEM)
#undef DPRF_SMEM
}

// Launch tail `tail` over group->n_targets targets on the caller's
// stream without synchronising; returns the launch's cudaError_t (0 =
// launched).  count and tcount hold 0 and lanes and tpos -1 on entry
// (the wrapper allocates them so); `smem` is
// dprf_rules_group_shared_bytes' for the group.  `threads` must be
// kThreads; `grid` is ceil(n_valid / kThreads) word blocks x
// ceil(n_rules / run) runs.
extern "C" int dprf_rules_group_launch(int tail, int device,
                                       const uint8_t* words,
                                       const int32_t* lens,
                                       const int32_t* bytecode,
                                       const int32_t* n_ops,
                                       const RulesArgs* args,
                                       const GroupArgs* group, int grid,
                                       int threads, int smem, void* stream)
{
    if (threads != kThreads || args->run < 1 || args->run > kMaxRun
        || group->n_targets < 1)
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
#define DPRF_LAUNCH(C, T)                                                 \
    group_launch<C, T>(words, lens, bytecode, n_ops, args, group, grid,    \
                       (size_t)smem, (cudaStream_t)stream)
    DPRF_GROUP_DISPATCH(DPRF_LAUNCH)
#undef DPRF_LAUNCH
}

// Resident blocks of kThreads threads per SM of tail `tail` at `smem`
// bytes of dynamic shared memory.
extern "C" int dprf_rules_group_blocks_per_sm(int tail, int smem,
                                              int* blocks)
{
#define DPRF_OCCUPANCY(C, T)                                              \
    occupancy(rules_group_kernel<C, T>, (size_t)smem, blocks)
    DPRF_GROUP_DISPATCH(DPRF_OCCUPANCY)
#undef DPRF_OCCUPANCY
}
