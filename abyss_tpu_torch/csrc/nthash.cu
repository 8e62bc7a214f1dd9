// Canonical ntHash of every k-window of a batch of reads, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel abyss_tpu/ops/pallas_kernels.py::kmer_hashes_pallas
// (reached through abyss_tpu/ops/nthash.canonical_hashes).  That kernel
// splits each 64-bit word into uint32 lane pairs and runs log-step
// lane-roll XOR scans because the TPU has no 64-bit lanes; Hopper has
// native 64-bit integer ops, so this kernel computes the same values
// from the definition instead (nthash.cuh): one block per TILE windows
// of one row, the row's codes staged in shared memory, each thread
// hashing a strip of STRIP windows — the first in O(k), the rest by the
// O(1) ntHash roll — with the `valid` (no N in the window) test fused
// into the same pass.
//
// What bounds it: memory.  At the main path's batch shape (4096 reads
// padded to L = 512, k = 31) it reads 2.1 MB of codes and writes
// 15.8 MB of canon (int64) + 2.0 MB of valid (bool) per batch, about
// 20 MB for some 30 integer operations per window.  The design moves
// those bytes once: one pass over the codes, no intermediate arrays in
// device memory, and each block's outputs written back as contiguous
// runs from shared memory.  Its time on the card is in PERF.md.
//
// Optional fwd/rev outputs (the strand hashes) serve the port's
// nthash.kmer_hashes on the GPU; the main path's counting and
// classification ask for canon/valid only.
//
// Plain C interface for ctypes: nthash_launch returns cudaGetLastError()
// after the launch, on the caller's stream, without synchronising.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nthash.cuh"

namespace {

__global__ void __launch_bounds__(nthash::THREADS)
nthash_kernel(const uint8_t* __restrict__ codes, int64_t L, int k,
              int64_t W, int64_t ntiles, int64_t* __restrict__ canon_out,
              bool* __restrict__ valid_out, int64_t* __restrict__ fwd_out,
              int64_t* __restrict__ rev_out) {
    extern __shared__ uint8_t s_codes[];  // TILE + k - 1 bases
    __shared__ nthash::Tables s_tab;
    __shared__ uint64_t s_canon[nthash::TILE];
    __shared__ uint8_t s_valid[nthash::TILE];

    const int64_t row = int64_t(blockIdx.x) / ntiles;
    const int64_t w0 = (int64_t(blockIdx.x) % ntiles) * nthash::TILE;
    const int64_t left = W - w0;
    const int nw = int(left < nthash::TILE ? left : nthash::TILE);
    const int ncodes = nw + k - 1;

    const uint8_t* src = codes + row * L + w0;
    for (int i = threadIdx.x; i < ncodes; i += nthash::THREADS)
        s_codes[i] = src[i];
    if (threadIdx.x == 0) nthash::make_tables(s_tab, k);
    __syncthreads();

    const int64_t out0 = row * W + w0;
    nthash::tile_thread(
        s_codes, nw, k, threadIdx.x, s_tab, s_canon, s_valid,
        fwd_out != nullptr ? reinterpret_cast<uint64_t*>(fwd_out + out0)
                           : nullptr,
        rev_out != nullptr ? reinterpret_cast<uint64_t*>(rev_out + out0)
                           : nullptr);
    __syncthreads();

    for (int i = threadIdx.x; i < nw; i += nthash::THREADS) {
        canon_out[out0 + i] = int64_t(s_canon[i]);
        valid_out[out0 + i] = s_valid[i] != 0;
    }
}

}  // namespace

// codes: uint8 [B, L] contiguous; outputs [B, L-k+1] contiguous;
// fwd/rev may be null.  The caller checks 1 <= k <= L, B >= 1 and
// B * ceil((L-k+1)/TILE) < 2^31.
extern "C" int nthash_launch(const uint8_t* codes, int64_t B, int64_t L,
                             int k, int64_t* canon, bool* valid,
                             int64_t* fwd, int64_t* rev, void* stream) {
    const int64_t W = L - k + 1;
    const int64_t ntiles = (W + nthash::TILE - 1) / nthash::TILE;
    const size_t shmem = size_t(nthash::TILE + k - 1);
    nthash_kernel<<<unsigned(B * ntiles), nthash::THREADS, shmem,
                    static_cast<cudaStream_t>(stream)>>>(
        codes, L, k, W, ntiles, canon, valid, fwd, rev);
    return int(cudaGetLastError());
}

extern "C" int nthash_tile() { return nthash::TILE; }
