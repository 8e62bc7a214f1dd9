// The unitig walks of dbg/extend.py for Hopper (sm_90a), a thread per
// walk (walk.cuh):
//   * walk_kernel: the lock-step extension `fast_extend`, one thread
//     walking one lane up to max_steps steps;
//   * branch_kernel: the breadth-first look-ahead `branch_depths`, one
//     thread searching from one root up to max_depth steps.
//
// They replace no Pallas kernel: the JAX package runs both loops as
// `lax.while_loop` / `lax.scan` of jnp ops inside one jitted program
// (abyss_tpu/dbg/extend.py::fast_extend, ::branch_depths).  In PyTorch
// each loop step is some fifty to a hundred small tensor ops launched
// from the host, and walks take thousands of steps; each kernel runs a
// whole loop in one launch.  Lanes and roots are independent, so a
// thread each gives the lock-step result exactly.
//
// What bounds them: latency.  Each step probes the walk table at 4 or 8
// random places (64-byte windows), and the next step needs this step's
// answers.  The bytes the work needs (the probed windows, once each)
// would take far less time than the chains of dependent probes: a few
// thousand threads cannot keep enough loads in flight.  The design keeps
// the probes of a step independent of each other and the head state in
// registers (the look-ahead's frontier in scratch laid out so that a
// warp's accesses coalesce); their times on the card are in PERF.md.
//
// Plain C interface for ctypes: each *_launch returns cudaGetLastError()
// after the launch, on the caller's stream, without synchronising.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
walk_kernel(uint8_t* __restrict__ buf, int64_t P, int64_t BUF,
            int64_t* __restrict__ length, int64_t* __restrict__ f,
            int64_t* __restrict__ r, int8_t* __restrict__ status,
            const int64_t* __restrict__ seed_canon,
            bool* __restrict__ has_prev, const int64_t* __restrict__ tab,
            int64_t size, int k, int64_t max_steps) {
    __shared__ nthash::Tables s_tab;
    if (threadIdx.x == 0) nthash::make_tables(s_tab, k);
    __syncthreads();
    const int64_t lane = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (lane >= P || status[lane] != walk::ACTIVE) return;
    walk::Lane s{length[lane], uint64_t(f[lane]), uint64_t(r[lane]),
                 status[lane], has_prev[lane]};
    walk::walk_lane(buf + lane * BUF, BUF, s, uint64_t(seed_canon[lane]),
                    reinterpret_cast<const uint64_t*>(tab),
                    uint64_t(size - 1), k, s_tab, max_steps);
    length[lane] = s.length;
    f[lane] = int64_t(s.f);
    r[lane] = int64_t(s.r);
    status[lane] = s.status;
    has_prev[lane] = s.has_prev;
}

__global__ void __launch_bounds__(THREADS)
branch_kernel(const uint8_t* __restrict__ roots, int64_t N, int k,
              const int64_t* __restrict__ f0, const int64_t* __restrict__ r0,
              const int64_t* __restrict__ tab, int64_t size, int max_depth,
              int W, int64_t* __restrict__ fs, int64_t* __restrict__ rs,
              uint8_t* __restrict__ hist, int H, int32_t* __restrict__ depth,
              int64_t* __restrict__ probes) {
    __shared__ nthash::Tables s_tab;
    if (threadIdx.x == 0) nthash::make_tables(s_tab, k);
    __syncthreads();
    const int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= N) return;
    int64_t np = 0;
    depth[i] = walk::branch_root(
        roots + i * k, k, uint64_t(f0[i]), uint64_t(r0[i]),
        reinterpret_cast<const uint64_t*>(tab), uint64_t(size - 1), s_tab,
        max_depth, W, N, i, reinterpret_cast<uint64_t*>(fs),
        reinterpret_cast<uint64_t*>(rs), hist, H, &np);
    if (probes != nullptr) probes[i] = np;
}

}  // namespace

// buf: uint8 [P, BUF]; length/f/r/seed_canon: int64 [P]; status: int8
// [P]; has_prev: bool [P]; tab: int64 [size + 8], size a power of two.
// All contiguous and updated in place.  The caller checks P >= 1,
// k <= BUF and P < 2^31.
extern "C" int walk_launch(uint8_t* buf, int64_t P, int64_t BUF,
                           int64_t* length, int64_t* f, int64_t* r,
                           int8_t* status, const int64_t* seed_canon,
                           bool* has_prev, const int64_t* tab, int64_t size,
                           int k, int64_t max_steps, void* stream) {
    const unsigned blocks = unsigned((P + THREADS - 1) / THREADS);
    walk_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        buf, P, BUF, length, f, r, status, seed_canon, has_prev, tab, size,
        k, max_steps);
    return int(cudaGetLastError());
}

// roots: uint8 [N, k]; f0/r0: int64 [N]; tab: int64 [size + 8]; scratch
// fs/rs: int64 [2 * W * N], hist: uint8 [2 * W * H * N] (H = max_depth
// - k if positive, else 0 and hist may be null); depth: int32 [N];
// probes (may be null): int64 [N] table probes per root.  The caller
// checks N >= 1, W >= 1 and N < 2^31.
extern "C" int branch_launch(const uint8_t* roots, int64_t N, int k,
                             const int64_t* f0, const int64_t* r0,
                             const int64_t* tab, int64_t size, int max_depth,
                             int W, int64_t* fs, int64_t* rs, uint8_t* hist,
                             int H, int32_t* depth, int64_t* probes,
                             void* stream) {
    const unsigned blocks = unsigned((N + THREADS - 1) / THREADS);
    branch_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        roots, N, k, f0, r0, tab, size, max_depth, W, fs, rs, hist, H, depth,
        probes);
    return int(cudaGetLastError());
}
