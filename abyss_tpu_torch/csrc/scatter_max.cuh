// Per-update body of the scatter-max kernel (scatter_max.cu).
//
// counters[i] <- max(counters[i], v) for one update (i, v) on a uint8
// counter array, with i dropped when it is not in [0, S): S is the
// power-of-two prefix of the array, so its trailing sink slot passes
// through.  The hardware has no byte-wide atomic max, so the update
// runs on the aligned 32-bit word that holds the byte: read the word,
// stop if its byte is already >= v (counters only grow, so a stale read
// that is already large enough is final), else compare-and-swap the
// word with the byte raised to v, and retry with the word the swap saw.
//
// `Word` supplies the word's load and compare-and-swap: atomicCAS in
// scatter_max.cu, a plain read-compare-write in host_harness.cpp, where
// g++ compiles this header for the CPU test suite.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SM_FN __device__ __forceinline__
#else
#define SM_FN inline
#endif

namespace scatter {

// Raise byte i of counters to v; returns whether this call wrote it.
// The word is aligned on its absolute address, so a counter array that
// starts at any byte (a row of a cascade's levels) works: the swap
// rewrites the word's other bytes with the values it read, and every
// writer of those bytes during the launch goes through the same swap.
template <class Word>
SM_FN bool max_update(uint8_t* counters, int64_t S, int64_t i, uint8_t v) {
    if (i < 0 || i >= S) return false;
    const uintptr_t a = reinterpret_cast<uintptr_t>(counters + i);
    uint32_t* w = reinterpret_cast<uint32_t*>(a & ~uintptr_t(3));
    const unsigned shift = unsigned(a & 3) * 8;
    uint32_t old = Word::load(w);
    while (((old >> shift) & 0xFFu) < v) {
        const uint32_t want = (old & ~(0xFFu << shift)) | (uint32_t(v) << shift);
        const uint32_t seen = Word::cas(w, old, want);
        if (seen == old) return true;
        old = seen;
    }
    return false;
}

}  // namespace scatter
