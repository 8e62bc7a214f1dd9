// Host loops over the CUDA kernels' grids, for the CPU test suite.
//
// g++ compiles the kernels' bodies (nthash.cuh, walk.cuh,
// scatter_max.cuh) into this library; each loop below runs them over the
// same blocks and threads (for the walks, the same groups of members,
// one host thread playing each member in turn), with the same
// shared-memory staging, as nthash.cu, walk.cu and scatter_max.cu launch
// them.
// tests/test_torch_kernel_host.py holds the results bit-identical to the
// plain PyTorch versions.

#include <stddef.h>
#include <stdint.h>

#include <vector>

#include "nthash.cuh"
#include "scatter_max.cuh"
#include "walk.cuh"

// nthash.cu: every block of the layout (rows, seg), each thread in turn
// through the scan, then each strip that needs hashing; the block's bases
// and its canon/valid go through arrays laid out as the kernel's shared
// memory, fwd/rev straight to the outputs.
extern "C" void nthash_host(const uint8_t* codes, int64_t B, int64_t L,
                            int k, int rows, int seg, uint64_t* canon,
                            uint8_t* valid, uint64_t* fwd, uint64_t* rev) {
    const int64_t W = L - k + 1;
    const int64_t ntiles = (W + seg - 1) / seg;
    const int64_t blocks = (B + rows - 1) / rows * ntiles;
    nthash::Tables tab;
    nthash::make_tables(tab, k);
    std::vector<uint8_t> s_codes(size_t(rows) * size_t(seg + k - 1));
    std::vector<uint64_t> s_canon(nthash::THREADS * nthash::SLOT);
    std::vector<uint8_t> s_valid(nthash::THREADS * nthash::SLOT);
    for (int64_t b = 0; b < blocks; ++b) {
        const int64_t row0 = b / ntiles * rows, w0 = b % ntiles * seg;
        const int nrows = int(B - row0 < rows ? B - row0 : rows);
        const int nw = int(W - w0 < seg ? W - w0 : seg);
        const int ncodes = nrows * (nw + k - 1);
        for (int i = 0; i < ncodes; ++i) s_codes[i] = codes[row0 * L + w0 + i];
        const int64_t out0 = row0 * W + w0;
        uint64_t* f = fwd != nullptr ? fwd + out0 : nullptr;
        uint64_t* r = rev != nullptr ? rev + out0 : nullptr;
        std::vector<int> list;
        for (int tid = 0; tid < nthash::THREADS; ++tid)
            if (nthash::scan_strip(s_codes.data(), nrows, nw, k, tid,
                                   s_canon.data(), s_valid.data(), f, r))
                list.push_back(tid);
        for (int sid : list)
            nthash::hash_strip(s_codes.data(), nrows, nw, k, sid, tab,
                               s_canon.data(), s_valid.data(), f, r);
        for (int i = 0; i < nrows * nw; ++i) {
            canon[out0 + i] = s_canon[nthash::out_slot(i, nw)];
            valid[out0 + i] = s_valid[nthash::out_slot(i, nw)];
        }
    }
}

// nthash.cu's geometry: THREADS, STRIP, PACK_CODES.
extern "C" void nthash_geometry(int* out) {
    out[0] = nthash::THREADS;
    out[1] = nthash::STRIP;
    out[2] = nthash::PACK_CODES;
}

namespace {

walk::TableSolid table_solid(const uint64_t* tab, int64_t size) {
    return walk::TableSolid{tab, uint64_t(size - 1)};
}

walk::BloomSolid bloom_solid(const uint8_t* counters, int64_t size,
                             int hash_k, int num_hashes, int threshold) {
    return walk::BloomSolid{counters, uint64_t(size - 1), hash_k, num_hashes,
                            threshold};
}

walk::CascadeSolid cascade_solid(const uint8_t* levels, int64_t size,
                                 int hash_k, int num_hashes, int depth) {
    return walk::CascadeSolid{levels, uint64_t(size - 1), size + 1, hash_k,
                              num_hashes, depth};
}

walk::ShardedSolid sharded_solid(const uint64_t* shards, int64_t size,
                                 int log2_len, int hash_k, int num_hashes,
                                 int threshold) {
    return walk::ShardedSolid{
        reinterpret_cast<const unsigned long long*>(shards),
        uint64_t(size - 1), log2_len, hash_k, num_hashes, threshold};
}

// walk.cu branch_kernel: each root searched by a group of members, the
// host thread playing each in turn, its frontier in a buffer of the
// kernel's layout.
template <class Solid>
void branch_loop(const uint8_t* roots, int64_t N, int k, const uint64_t* f0,
                 const uint64_t* r0, const Solid& solid, int max_depth,
                 int W, int H, int32_t* depth, int64_t* probes) {
    nthash::Tables t;
    nthash::make_tables(t, k);
    std::vector<uint64_t> region(walk::frontier_bytes(W, H, k) / 8);
    const walk::Frontier fr = walk::frontier_at(region.data(), W, H, k);
    for (int64_t i = 0; i < N; ++i)
        depth[i] = walk::branch_root(walk::SerialGroup{}, roots + i * k,
                                     f0[i], r0[i], solid, t, max_depth, fr,
                                     probes + i);
}

// walk.cu walk_kernel: each ACTIVE lane walked by a group of members, the
// host thread playing each in turn; lanes that are not ACTIVE are
// skipped.
template <class Solid>
void walk_loop(uint8_t* buf, int64_t P, int64_t BUF, int64_t* length,
               uint64_t* f, uint64_t* r, int8_t* status,
               const uint64_t* seed_canon, uint8_t* has_prev,
               const Solid& solid, int k, int64_t max_steps) {
    nthash::Tables t;
    nthash::make_tables(t, k);
    std::vector<uint8_t> ring(walk::ring_size(k));
    for (int64_t lane = 0; lane < P; ++lane) {
        if (status[lane] != walk::ACTIVE) continue;
        walk::Lane s{length[lane], f[lane], r[lane], status[lane],
                     has_prev[lane] != 0};
        walk::walk_lane(walk::SerialGroup{}, buf + lane * BUF, BUF, s,
                        seed_canon[lane], solid, k, t, max_steps,
                        ring.data());
        length[lane] = s.length;
        f[lane] = s.f;
        r[lane] = s.r;
        status[lane] = s.status;
        has_prev[lane] = s.has_prev;
    }
}

// scatter_max.cu's word access without atomics: one host thread.
struct HostWord {
    static uint32_t load(const uint32_t* w) { return *w; }
    static uint32_t cas(uint32_t* w, uint32_t cmp, uint32_t val) {
        const uint32_t old = *w;
        if (old == cmp) *w = val;
        return old;
    }
};

}  // namespace

// walk.cu branch_launch; H = max_depth - k if positive, else 0.
extern "C" void branch_host(const uint8_t* roots, int64_t N, int k,
                            const uint64_t* f0, const uint64_t* r0,
                            const uint64_t* tab, int64_t size, int max_depth,
                            int W, int H, int32_t* depth, int64_t* probes) {
    branch_loop(roots, N, k, f0, r0, table_solid(tab, size), max_depth, W, H,
                depth, probes);
}

// branch_host on a counting Bloom filter (walk.cu branch_bloom_launch).
extern "C" void branch_bloom_host(const uint8_t* roots, int64_t N, int k,
                                  const uint64_t* f0, const uint64_t* r0,
                                  const uint8_t* counters, int64_t size,
                                  int hash_k, int num_hashes, int threshold,
                                  int max_depth, int W, int H,
                                  int32_t* depth, int64_t* probes) {
    branch_loop(roots, N, k, f0, r0,
                bloom_solid(counters, size, hash_k, num_hashes, threshold),
                max_depth, W, H, depth, probes);
}

// walk.cu walk_launch.
extern "C" void walk_host(uint8_t* buf, int64_t P, int64_t BUF,
                          int64_t* length, uint64_t* f, uint64_t* r,
                          int8_t* status, const uint64_t* seed_canon,
                          uint8_t* has_prev, const uint64_t* tab,
                          int64_t size, int k, int64_t max_steps) {
    walk_loop(buf, P, BUF, length, f, r, status, seed_canon, has_prev,
              table_solid(tab, size), k, max_steps);
}

// walk_host on a counting Bloom filter (walk.cu walk_bloom_launch).
extern "C" void walk_bloom_host(uint8_t* buf, int64_t P, int64_t BUF,
                                int64_t* length, uint64_t* f, uint64_t* r,
                                int8_t* status, const uint64_t* seed_canon,
                                uint8_t* has_prev, const uint8_t* counters,
                                int64_t size, int hash_k, int num_hashes,
                                int threshold, int k, int64_t max_steps) {
    walk_loop(buf, P, BUF, length, f, r, status, seed_canon, has_prev,
              bloom_solid(counters, size, hash_k, num_hashes, threshold), k,
              max_steps);
}

// walk_host on a cascading Bloom filter (walk.cu walk_cascade_launch).
extern "C" void walk_cascade_host(uint8_t* buf, int64_t P, int64_t BUF,
                                  int64_t* length, uint64_t* f, uint64_t* r,
                                  int8_t* status, const uint64_t* seed_canon,
                                  uint8_t* has_prev, const uint8_t* levels,
                                  int64_t size, int hash_k, int num_hashes,
                                  int depth, int k, int64_t max_steps) {
    walk_loop(buf, P, BUF, length, f, r, status, seed_canon, has_prev,
              cascade_solid(levels, size, hash_k, num_hashes, depth), k,
              max_steps);
}

// branch_host on a cascading Bloom filter (walk.cu branch_cascade_launch).
extern "C" void branch_cascade_host(const uint8_t* roots, int64_t N, int k,
                                    const uint64_t* f0, const uint64_t* r0,
                                    const uint8_t* levels, int64_t size,
                                    int hash_k, int num_hashes, int depth,
                                    int max_depth, int W, int H,
                                    int32_t* depth_out, int64_t* probes) {
    branch_loop(roots, N, k, f0, r0,
                cascade_solid(levels, size, hash_k, num_hashes, depth),
                max_depth, W, H, depth_out, probes);
}

// walk_host on a counting filter split into shards: shards holds the
// host addresses of the shards (walk.cu walk_sharded_launch).
extern "C" void walk_sharded_host(uint8_t* buf, int64_t P, int64_t BUF,
                                  int64_t* length, uint64_t* f, uint64_t* r,
                                  int8_t* status, const uint64_t* seed_canon,
                                  uint8_t* has_prev, const uint64_t* shards,
                                  int64_t size, int log2_len, int hash_k,
                                  int num_hashes, int threshold, int k,
                                  int64_t max_steps) {
    walk_loop(buf, P, BUF, length, f, r, status, seed_canon, has_prev,
              sharded_solid(shards, size, log2_len, hash_k, num_hashes,
                            threshold),
              k, max_steps);
}

// branch_host on a counting filter split into shards (walk.cu
// branch_sharded_launch).
extern "C" void branch_sharded_host(const uint8_t* roots, int64_t N, int k,
                                    const uint64_t* f0, const uint64_t* r0,
                                    const uint64_t* shards, int64_t size,
                                    int log2_len, int hash_k, int num_hashes,
                                    int threshold, int max_depth, int W,
                                    int H, int32_t* depth, int64_t* probes) {
    branch_loop(roots, N, k, f0, r0,
                sharded_solid(shards, size, log2_len, hash_k, num_hashes,
                              threshold),
                max_depth, W, H, depth, probes);
}

// ShardedSolid's test of each of the n keys q: solid[j] = 1 when all H
// counters of q[j] reach the threshold (ShardedCountingFilter.contains).
extern "C" void sharded_solid_host(const uint64_t* q, int64_t n,
                                   uint8_t* solid, const uint64_t* shards,
                                   int64_t size, int log2_len, int hash_k,
                                   int num_hashes, int threshold) {
    const walk::ShardedSolid s = sharded_solid(shards, size, log2_len, hash_k,
                                               num_hashes, threshold);
    for (int64_t j = 0; j < n; ++j) solid[j] = s(q[j]) ? 1 : 0;
}

// scatter_max.cu: every update in order, one at a time.
extern "C" void scatter_max_host(uint8_t* counters, int64_t S,
                                 const int64_t* idx, const uint8_t* val,
                                 int64_t Q) {
    for (int64_t j = 0; j < Q; ++j)
        scatter::max_update<HostWord>(counters, S, idx[j], val[j]);
}
