// thread_bytes.cuh -- one byte array per thread in shared memory, the
// layout csrc/rc4.cuh's RC4 states and csrc/sevenzip.cu's stream windows
// share.
//
// A block of kThreads threads (a constexpr int the including source
// defines) keeps byte e of thread t at byte 4 * ((e >> 2) * kThreads + t)
// + (e & 3): the 32-bit word that holds it sits in bank t mod 32 whatever
// e is, so a warp's 32 accesses at one offset, or at 32 data-dependent
// ones, never conflict, and byte loads and stores need no
// read-modify-write.  `s` below is the calling thread's base: the
// block's arrays plus 4 * threadIdx.x.

#pragma once

// Byte e of the calling thread's array.
#define THREAD_BYTE_AT(s, e) \
    ((s)[(((e) >> 2) * (4 * kThreads)) + ((e) & 3)])
