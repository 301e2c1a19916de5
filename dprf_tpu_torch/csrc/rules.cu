// rules.cu -- the fused wordlist+rules kernel (rules_kernel.cuh) over
// the plain cores, one target or a list.
//
// Replaces: the TPU kernel of dprf_tpu/ops/pallas_rules.py
// (make_rules_pallas_fn, its rule VM _interp_step and
// _pack_varlen_words) for the md5, md4 (ntlm), sha1 and sha256 cores.
// Two more cores, whose wordlists the reference runs on XLA only
// (engines/device/engines.py's DeviceWordlistWorker), take the same
// kernel: sha224 and mysql323 (cores.cuh; mysql323's scan runs to each
// candidate's own length).  The nested chains are csrc/rules_nested.cu's.

#include "rules_kernel.cuh"

// core ids: 0 md5, 1 md4 (ntlm), 2 sha1, 3 sha256, 4 sha224, 5 mysql323
// (ops/cuda_rules.KERNEL_CORES)
#define DPRF_DISPATCH(CALL)                                               \
    switch (core) {                                                       \
    case 0: return CALL(Md5Core, kSingle);                                \
    case 1: return CALL(Md4Core, kSingle);                                \
    case 2: return CALL(Sha1Core, kSingle);                               \
    case 3: return CALL(Sha256Core, kSingle);                             \
    case 4: return CALL(Sha224Core, kSingle);                             \
    case 5: return CALL(Mysql323Core, kSingle);                           \
    default: return (int)cudaErrorInvalidValue;                           \
    }

// a list's modes: 2 the shared-memory probe, 3 the bulk probe
// (ops/cuda_rules.LIST_MODES)
#define DPRF_LIST_DISPATCH(CALL)                                          \
    switch (core * 4 + mode) {                                            \
    case 2: return CALL(Md5Core, kProbe);                                 \
    case 3: return CALL(Md5Core, kBulk);                                  \
    case 6: return CALL(Md4Core, kProbe);                                 \
    case 7: return CALL(Md4Core, kBulk);                                  \
    case 10: return CALL(Sha1Core, kProbe);                               \
    case 11: return CALL(Sha1Core, kBulk);                                \
    case 14: return CALL(Sha256Core, kProbe);                             \
    case 15: return CALL(Sha256Core, kBulk);                              \
    case 18: return CALL(Sha224Core, kProbe);                             \
    case 19: return CALL(Sha224Core, kBulk);                              \
    case 22: return CALL(Mysql323Core, kProbe);                           \
    case 23: return CALL(Mysql323Core, kBulk);                            \
    default: return (int)cudaErrorInvalidValue;                           \
    }

#include "rules_entry.cuh"
