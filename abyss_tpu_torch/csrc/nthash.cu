// Canonical ntHash of every k-window of a batch of reads, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel abyss_tpu/ops/pallas_kernels.py::kmer_hashes_pallas
// (reached through abyss_tpu/ops/nthash.canonical_hashes).  That kernel
// splits each 64-bit word into uint32 lane pairs and runs log-step
// lane-roll XOR scans because the TPU has no 64-bit lanes; here a thread
// computes the same values from the definition (nthash.cuh): the first
// window of its strip of STRIP windows in O(k), the rest by the O(1)
// ntHash roll, with the `valid` (no N in the window) test fused into the
// same pass.
//
// What bounds it.  The bytes, at the least: at the main path's batch
// shape (4096 reads padded to L = 512, k = 31) it reads 2.1 MB of codes
// and writes 15.8 MB of canon (int64) + 2.0 MB of valid (bool), once
// each.  On the card, though, the time goes to each block's chain of
// phases (stage the bases, find the strips that hold a base, hash them,
// write back) and to the integer issue of the hashing: the integer lanes
// are 32 bits wide, so each 64-bit split rotation is several
// instructions.  The design:
//   * a block of 256 threads takes 8 such rows (packed layout) or a tile
//     of up to 4096 windows of one row; rows shorter than a tile are
//     packed several to a block (hash_base's [N, k] rows, W = 1, take 256
//     a block), so every thread gets a strip;
//   * the bases are staged by 16-byte loads, all of a thread's at once;
//   * a strip whose bases are all padding is written as zeros with no
//     arithmetic (the formula's own value there), and the strips that do
//     hold a base are dealt out again to consecutive threads, so that
//     the hashing fills whole warps: 150-base reads padded to 512 leave
//     two thirds of every batch's strips so;
//   * a strip of 16 windows pays one O(k) start for 15 O(1) rolls, and
//     each rotation is a 64-bit shift with two bit moves (nthash.cuh);
//   * each strip's outputs sit in shared memory in runs of 17 entries, so
//     that a warp's stores do not all fall in one bank, and are written
//     back to device memory as contiguous runs;
//   * the seed tables are computed once per launch on the host, passed
//     by value (the constant bank) and copied to shared memory by 20
//     threads: no per-block serial table build behind a barrier.
// Its time on the card, at the shapes the main path launches, is in
// PERF.md.
//
// Optional fwd/rev outputs (the strand hashes) serve the port's
// nthash.kmer_hashes on the GPU; they are written straight from each
// thread's strip.
//
// Plain C interface for ctypes: nthash_launch returns cudaGetLastError()
// after the launch, on the caller's stream, without synchronising.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nthash.cuh"

namespace {

__global__ void __launch_bounds__(nthash::THREADS)
nthash_kernel(const uint8_t* __restrict__ codes, int64_t B, int64_t L, int k,
              int rows, int seg, int64_t ntiles,
              const __grid_constant__ nthash::Tables tab,
              int64_t* __restrict__ canon_out, bool* __restrict__ valid_out,
              int64_t* __restrict__ fwd_out, int64_t* __restrict__ rev_out) {
    extern __shared__ uint8_t s_codes[];  // rows * (seg + k - 1) bases
    __shared__ nthash::Tables s_tab;
    __shared__ uint64_t s_canon[nthash::THREADS * nthash::SLOT];
    __shared__ uint8_t s_valid[nthash::THREADS * nthash::SLOT];
    __shared__ int s_list[nthash::THREADS];   // strips that need hashing
    __shared__ int s_nlist;

    const int64_t W = L - k + 1;
    const int64_t row0 = int64_t(blockIdx.x) / ntiles * rows;
    const int64_t w0 = (int64_t(blockIdx.x) % ntiles) * seg;
    const int nrows = int(B - row0 < rows ? B - row0 : rows);
    const int nw = int(W - w0 < seg ? W - w0 : seg);
    // the block's bases are one run of the codes: a segment of one row,
    // or (packed, nw = W) whole rows of L = nw + k - 1 bases
    const int ncodes = nrows * (nw + k - 1);
    // staged by 16-byte loads of the aligned words that cover the run,
    // all of a thread's loads in flight at once
    const uint8_t* src = codes + row0 * L + w0;
    const int lead = int(reinterpret_cast<uintptr_t>(src) & 15);
    const uint4* vsrc = reinterpret_cast<const uint4*>(src - lead);
    const int nvec = (lead + ncodes + 15) / 16;
    for (int v = threadIdx.x; v < nvec; v += nthash::THREADS) {
        const uint4 word = __ldg(vsrc + v);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&word);
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            const int i = v * 16 + u - lead;
            if (i >= 0 && i < ncodes) s_codes[i] = b[u];
        }
    }
    constexpr int NTAB = sizeof(nthash::Tables) / sizeof(uint64_t);
    if (threadIdx.x < NTAB)
        reinterpret_cast<uint64_t*>(&s_tab)[threadIdx.x] =
            reinterpret_cast<const uint64_t*>(&tab)[threadIdx.x];
    if (threadIdx.x == 0) s_nlist = 0;
    __syncthreads();

    // the block's outputs are one run too: nrows * nw windows from out0
    const int64_t out0 = row0 * W + w0;
    uint64_t* fwd = fwd_out != nullptr
        ? reinterpret_cast<uint64_t*>(fwd_out + out0) : nullptr;
    uint64_t* rev = rev_out != nullptr
        ? reinterpret_cast<uint64_t*>(rev_out + out0) : nullptr;
    const bool need = nthash::scan_strip(s_codes, nrows, nw, k, threadIdx.x,
                                         s_canon, s_valid, fwd, rev);
    // append the strips that need hashing to s_list, a warp at a time
    const unsigned lane = threadIdx.x % 32;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
    int at = 0;
    if (lane == 0 && ballot != 0) at = atomicAdd(&s_nlist, __popc(ballot));
    at = __shfl_sync(0xFFFFFFFFu, at, 0);
    if (need) s_list[at + __popc(ballot & ((1u << lane) - 1))] = threadIdx.x;
    __syncthreads();
    if (int(threadIdx.x) < s_nlist)
        nthash::hash_strip(s_codes, nrows, nw, k, s_list[threadIdx.x], s_tab,
                           s_canon, s_valid, fwd, rev);
    __syncthreads();

    const int nout = nrows * nw;
    for (int i = threadIdx.x; i < nout; i += nthash::THREADS) {
        const int e = nthash::out_slot(i, nw);
        canon_out[out0 + i] = int64_t(s_canon[e]);
        valid_out[out0 + i] = s_valid[e] != 0;
    }
}

}  // namespace

// codes: uint8 [B, L] contiguous; outputs [B, L-k+1] contiguous;
// fwd/rev may be null.  Layout (ops/kernels.nthash_layout): `rows` rows
// a block with seg = W (packed), or rows = 1 and a segment of
// seg <= TILE windows a block (tile).  Returns cudaErrorInvalidValue,
// launching nothing, for a layout the kernel cannot take.  The caller
// checks 1 <= k <= L, B >= 1 and the grid's size.
extern "C" int nthash_launch(const uint8_t* codes, int64_t B, int64_t L,
                             int k, int rows, int seg, int64_t* canon,
                             bool* valid, int64_t* fwd, int64_t* rev,
                             void* stream) {
    const int64_t W = L - k + 1;
    const int spr = (seg + nthash::STRIP - 1) / nthash::STRIP;
    if (rows < 1 || seg < 1 || seg > nthash::TILE || seg > W ||
        (rows > 1 && (seg != W || int64_t(rows) * spr > nthash::THREADS ||
                      int64_t(rows) * L > nthash::PACK_CODES)))
        return int(cudaErrorInvalidValue);
    const int64_t ntiles = (W + seg - 1) / seg;
    const int64_t blocks = (B + rows - 1) / rows * ntiles;
    const size_t shmem = size_t(rows) * size_t(seg + k - 1);
    // a long k's bases can take the block past 48 KB of shared memory
    if (shmem > nthash::PACK_CODES) {
        const cudaError_t err = cudaFuncSetAttribute(
            nthash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            int(shmem));
        if (err != cudaSuccess) return int(err);
    }
    nthash::Tables tab;
    nthash::make_tables(tab, k);
    nthash_kernel<<<unsigned(blocks), nthash::THREADS, shmem,
                    static_cast<cudaStream_t>(stream)>>>(
        codes, B, L, k, rows, seg, ntiles, tab, canon, valid, fwd, rev);
    return int(cudaGetLastError());
}

// THREADS, STRIP, PACK_CODES: what ops/kernels.nthash_layout needs.
extern "C" void nthash_geometry(int* out) {
    out[0] = nthash::THREADS;
    out[1] = nthash::STRIP;
    out[2] = nthash::PACK_CODES;
}
