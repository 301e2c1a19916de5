// rules_entry.cuh -- the rules kernel's C interface (ops/cuda_rules.py)
// over the instantiations that the including source names.  The source
// defines DPRF_DISPATCH(CALL) (one target: a switch over `core` returning
// CALL(CoreType, kSingle)) and DPRF_LIST_DISPATCH(CALL) (a list: a
// switch over core * 4 + mode), then includes this after
// rules_kernel.cuh.  A source whose cores take other kernel parameters
// (csrc/rules_wide.cu) defines DPRF_RULES_ARGS, their type, and
// DPRF_RULES_KERNEL, its kernel template, with a launch<Core, kMode>
// overload for them.

#pragma once

#ifndef DPRF_RULES_ARGS
#define DPRF_RULES_ARGS RulesArgs
#define DPRF_RULES_KERNEL rules_kernel
#endif

// Launch on the caller's stream without synchronising; returns the
// launch's cudaError_t (0 = launched).  count must hold 0 and lanes -1
// on entry (the wrapper allocates them so).  `threads` must be kThreads;
// `grid` is ceil(n_valid / kThreads) word blocks x ceil(n_rules / run)
// runs.
extern "C" int dprf_rules_launch(int core, int device, const uint8_t* words,
                                 const int32_t* lens,
                                 const int32_t* bytecode,
                                 const int32_t* n_ops,
                                 const DPRF_RULES_ARGS* args,
                                 int32_t* count, int32_t* lanes,
                                 int32_t cap, int grid, int threads,
                                 void* stream)
{
    if (threads != kThreads || args->run < 1 || args->run > kMaxRun)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    const MultiArgs none{};
#define DPRF_LAUNCH(C, M)                                                 \
    launch<C, M>(words, lens, bytecode, n_ops, args, &none, count, lanes,   \
                 nullptr, nullptr, cap, grid, shared_bytes<C>(), st)
    DPRF_DISPATCH(DPRF_LAUNCH)
#undef DPRF_LAUNCH
}

// A list's launch in mode 2 or 3 (DPRF_LIST_DISPATCH): as
// dprf_rules_launch, with the list's state (multi: the bitmap, the
// sorted table or null), tpos and n_maybe, which hold -1 and 0 on
// entry, and `smem`, the block's dynamic shared memory: the slots
// (dprf_rules_shared_bytes), and for mode 2 the bitmap.
extern "C" int dprf_rules_list_launch(int core, int mode, int device,
                                      const uint8_t* words,
                                      const int32_t* lens,
                                      const int32_t* bytecode,
                                      const int32_t* n_ops,
                                      const DPRF_RULES_ARGS* args,
                                      const MultiArgs* multi, int32_t* count,
                                      int32_t* lanes, int32_t* tpos,
                                      int32_t* n_maybe, int32_t cap,
                                      int grid, int threads, int smem,
                                      void* stream)
{
    if (threads != kThreads || args->run < 1 || args->run > kMaxRun)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
#define DPRF_LAUNCH(C, M)                                                 \
    launch<C, M>(words, lens, bytecode, n_ops, args, multi, count, lanes,   \
                 tpos, n_maybe, cap, grid, (size_t)smem, st)
    DPRF_LIST_DISPATCH(DPRF_LAUNCH)
#undef DPRF_LAUNCH
}

// Resident blocks of kThreads threads per SM for one instantiation (the
// wave the host partitions a launch for).
extern "C" int dprf_rules_blocks_per_sm(int core, int* blocks)
{
#define DPRF_OCCUPANCY(C, M)                                              \
    occupancy(DPRF_RULES_KERNEL<C, M>, shared_bytes<C>(), blocks)
    DPRF_DISPATCH(DPRF_OCCUPANCY)
#undef DPRF_OCCUPANCY
}

// The same for a list's instantiation at `smem` bytes of dynamic shared
// memory.
extern "C" int dprf_rules_list_blocks_per_sm(int core, int mode, int smem,
                                             int* blocks)
{
#define DPRF_OCCUPANCY(C, M)                                              \
    occupancy(DPRF_RULES_KERNEL<C, M>, (size_t)smem, blocks)
    DPRF_LIST_DISPATCH(DPRF_OCCUPANCY)
#undef DPRF_OCCUPANCY
}

// Dynamic shared memory of one block of an instantiation, its slots and
// ops (a kProbe list adds its bitmap).
extern "C" int dprf_rules_shared_bytes(int core, int* bytes)
{
#define DPRF_SMEM(C, M) smem_of<C, M>(bytes)
    DPRF_DISPATCH(DPRF_SMEM)
#undef DPRF_SMEM
}
