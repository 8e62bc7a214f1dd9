// Scatter-max over a uint8 counter array, for Hopper (sm_90a): the write
// side of the counting Bloom filter's conservative insert
// (ops/bloom.CountingBloomFilter.insert_counts).
//
// Replaces the TPU kernel abyss_tpu/ops/pallas_scatter.py::
// scatter_max_u8_pallas.  That kernel sorts the update stream by counter
// index and applies each 1024-counter tile's window as a dense
// compare-broadcast max, because a TPU has no scatter and no atomics.
// Hopper has both, so the binning, its capacity plan and its overflow
// flag go: one thread takes one update (grid-stride), drops it when its
// index is not below the power-of-two size S (the masked lanes of an
// insert all point at the sink slot S, several million a batch, and
// touch no memory here), and raises its byte with a compare-and-swap
// loop on the aligned 32-bit word (scatter_max.cuh) that stops as soon
// as the byte is already at least the update's value.
//
// What bounds it: memory.  Each update streams its index (8 bytes) and
// value (1 byte); each update that is not dropped reads and writes one
// 32-byte sector of the counters at a random place.  Updates to one word
// serialise on its swap, but a hashed counter array of 2^30 bytes makes
// that rare.  Its time on the card, beside that bound, is in PERF.md.
//
// Plain C interface for ctypes: scatter_max_launch returns
// cudaGetLastError() after the launch, on the caller's stream, without
// synchronising.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scatter_max.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 132 * 16;   // 16 blocks per SM, then stride

struct DeviceWord {
    __device__ static uint32_t load(const uint32_t* w) {
        return *reinterpret_cast<const volatile uint32_t*>(w);
    }
    __device__ static uint32_t cas(uint32_t* w, uint32_t cmp, uint32_t val) {
        return atomicCAS(reinterpret_cast<unsigned int*>(w), cmp, val);
    }
};

__global__ void __launch_bounds__(THREADS)
scatter_max_kernel(uint8_t* counters, int64_t S,
                   const int64_t* __restrict__ idx,
                   const uint8_t* __restrict__ val, int64_t Q) {
    const int64_t stride = int64_t(gridDim.x) * THREADS;
    for (int64_t j = int64_t(blockIdx.x) * THREADS + threadIdx.x; j < Q;
         j += stride)
        scatter::max_update<DeviceWord>(counters, S, idx[j], val[j]);
}

}  // namespace

// counters: uint8 [>= S], updated in place; idx: int64 [Q]; val: uint8
// [Q].  The caller checks Q >= 1 and that S is a power of two no larger
// than the counter array.
extern "C" int scatter_max_launch(uint8_t* counters, int64_t S,
                                  const int64_t* idx, const uint8_t* val,
                                  int64_t Q, void* stream) {
    int64_t blocks = (Q + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    scatter_max_kernel<<<unsigned(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        counters, S, idx, val, Q);
    return int(cudaGetLastError());
}
