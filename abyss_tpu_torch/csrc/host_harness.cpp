// Host loops over the CUDA kernels' grids, for the CPU test suite.
//
// g++ compiles the kernels' per-thread bodies (nthash.cuh, walk.cuh)
// into this library; each loop below runs them over the same blocks and
// threads, with the same shared-memory staging, as nthash.cu and walk.cu
// launch them.  tests/test_torch_kernel_host.py holds the results
// bit-identical to the plain PyTorch versions.

#include <stdint.h>

#include "nthash.cuh"
#include "walk.cuh"

// nthash.cu: block (row, tile), thread tid; canon/valid go through the
// block's shared arrays, fwd/rev straight to the outputs.
extern "C" void nthash_host(const uint8_t* codes, int64_t B, int64_t L,
                            int k, uint64_t* canon, uint8_t* valid,
                            uint64_t* fwd, uint64_t* rev) {
    const int64_t W = L - k + 1;
    const int64_t ntiles = (W + nthash::TILE - 1) / nthash::TILE;
    nthash::Tables tab;
    nthash::make_tables(tab, k);
    uint64_t s_canon[nthash::TILE];
    uint8_t s_valid[nthash::TILE];
    for (int64_t row = 0; row < B; ++row)
        for (int64_t tile = 0; tile < ntiles; ++tile) {
            const int64_t w0 = tile * nthash::TILE;
            const int nw = int(W - w0 < nthash::TILE ? W - w0 : nthash::TILE);
            const uint8_t* src = codes + row * L + w0;
            const int64_t out0 = row * W + w0;
            for (int tid = 0; tid < nthash::THREADS; ++tid)
                nthash::tile_thread(src, nw, k, tid, tab, s_canon, s_valid,
                                    fwd + out0, rev + out0);
            for (int i = 0; i < nw; ++i) {
                canon[out0 + i] = s_canon[i];
                valid[out0 + i] = s_valid[i];
            }
        }
}

// walk.cu branch_kernel: one root per thread, the same scratch layout.
extern "C" void branch_host(const uint8_t* roots, int64_t N, int k,
                            const uint64_t* f0, const uint64_t* r0,
                            const uint64_t* tab, int64_t size, int max_depth,
                            int W, uint64_t* fs, uint64_t* rs, uint8_t* hist,
                            int H, int32_t* depth, int64_t* probes) {
    nthash::Tables t;
    nthash::make_tables(t, k);
    for (int64_t i = 0; i < N; ++i)
        depth[i] = walk::branch_root(roots + i * k, k, f0[i], r0[i], tab,
                                     uint64_t(size - 1), t, max_depth, W, N,
                                     i, fs, rs, hist, H, probes + i);
}

// walk.cu walk_kernel: one lane per thread; lanes that are not ACTIVE
// are skipped.
extern "C" void walk_host(uint8_t* buf, int64_t P, int64_t BUF,
                          int64_t* length, uint64_t* f, uint64_t* r,
                          int8_t* status, const uint64_t* seed_canon,
                          uint8_t* has_prev, const uint64_t* tab,
                          int64_t size, int k, int64_t max_steps) {
    nthash::Tables t;
    nthash::make_tables(t, k);
    for (int64_t lane = 0; lane < P; ++lane) {
        if (status[lane] != walk::ACTIVE) continue;
        walk::Lane s{length[lane], f[lane], r[lane], status[lane],
                     has_prev[lane] != 0};
        walk::walk_lane(buf + lane * BUF, BUF, s, seed_canon[lane], tab,
                        uint64_t(size - 1), k, t, max_steps);
        length[lane] = s.length;
        f[lane] = s.f;
        r[lane] = s.r;
        status[lane] = s.status;
        has_prev[lane] = s.has_prev;
    }
}
