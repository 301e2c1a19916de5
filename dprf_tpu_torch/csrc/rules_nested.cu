// rules_nested.cu -- the fused wordlist+rules kernel (rules_kernel.cuh)
// over the nested chains of chains.cuh, one target or a list.
//
// Replaces no TPU kernel: the reference runs the nested chains' wordlists
// on XLA only (engines/device/nested.py, DeviceWordlistWorker over
// ops/rules_pipeline.expand_rules).  A candidate is placed by the inner
// core's byte order, and its digest is the chain's: the inner core, the
// hex of its digest (the raw words for mysql41), the outer core.  A
// source of its own, so that its nvcc runs beside rules.cu's.

#include "chains.cuh"
#include "rules_kernel.cuh"

// core ids (ops/cuda_rules.KERNEL_CORES): 6 md5(md5), 7 sha1(sha1),
// 8 md5(sha1), 9 sha1(md5), 10 sha256(md5), 11 sha256(sha1), 12 mysql41
#define DPRF_DISPATCH(CALL)                                               \
    switch (core) {                                                       \
    case 6: return CALL(Md5OfMd5, kSingle);                               \
    case 7: return CALL(Sha1OfSha1, kSingle);                             \
    case 8: return CALL(Md5OfSha1, kSingle);                              \
    case 9: return CALL(Sha1OfMd5, kSingle);                              \
    case 10: return CALL(Sha256OfMd5, kSingle);                           \
    case 11: return CALL(Sha256OfSha1, kSingle);                          \
    case 12: return CALL(Mysql41, kSingle);                               \
    default: return (int)cudaErrorInvalidValue;                           \
    }

// a list's modes: 2 the shared-memory probe, 3 the bulk probe
#define DPRF_LIST_DISPATCH(CALL)                                          \
    switch (core * 4 + mode) {                                            \
    case 26: return CALL(Md5OfMd5, kProbe);                               \
    case 27: return CALL(Md5OfMd5, kBulk);                                \
    case 30: return CALL(Sha1OfSha1, kProbe);                             \
    case 31: return CALL(Sha1OfSha1, kBulk);                              \
    case 34: return CALL(Md5OfSha1, kProbe);                              \
    case 35: return CALL(Md5OfSha1, kBulk);                               \
    case 38: return CALL(Sha1OfMd5, kProbe);                              \
    case 39: return CALL(Sha1OfMd5, kBulk);                               \
    case 42: return CALL(Sha256OfMd5, kProbe);                            \
    case 43: return CALL(Sha256OfMd5, kBulk);                             \
    case 46: return CALL(Sha256OfSha1, kProbe);                           \
    case 47: return CALL(Sha256OfSha1, kBulk);                            \
    case 50: return CALL(Mysql41, kProbe);                                \
    case 51: return CALL(Mysql41, kBulk);                                 \
    default: return (int)cudaErrorInvalidValue;                           \
    }

#include "rules_entry.cuh"
