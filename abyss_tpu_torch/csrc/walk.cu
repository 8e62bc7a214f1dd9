// The unitig walks of dbg/extend.py for Hopper (sm_90a), a group of
// threads per walk (walk.cuh):
//   * walk_kernel: the lock-step extension `fast_extend`, a group of 8
//     threads walking one lane up to max_steps steps;
//   * branch_kernel: the breadth-first look-ahead `branch_depths`, a warp
//     searching from one root up to max_depth steps.
//
// They replace no Pallas kernel: the JAX package runs both loops as
// `lax.while_loop` / `lax.scan` of jnp ops inside one jitted program
// (abyss_tpu/dbg/extend.py::fast_extend, ::branch_depths).  In PyTorch
// each loop step is some fifty to a hundred small tensor ops launched
// from the host, and walks take thousands of steps; each kernel runs a
// whole loop in one launch.  Lanes and roots are independent, so a
// group each gives the lock-step result exactly.
//
// Each kernel comes in four variants of its solidity test (walk.cuh):
// the walk table of the sorted filter (walk_launch, branch_launch), the
// counting Bloom filter (walk_bloom_launch, branch_bloom_launch), where
// a test reads H counters at hashed places instead of one 64-byte table
// window, the cascading Bloom filter of `konnector --cascade`
// (walk_cascade_launch, branch_cascade_launch), where it reads H bytes
// in each of the cascade's L levels, and the counting filter split into
// shards over a device mesh, `pe np=4` and up
// (walk_sharded_launch, branch_sharded_launch), where each of the H
// counters is read from its shard, through an array of the shards'
// addresses; a shard on another card is read by peer access
// (walk_enable_peer).
//
// What bounds them: the latency of chains of dependent random probes,
// not bytes.  A walk step tests 8 candidates at random places in a table
// far larger than L2, and the next step needs this step's answers; a
// look-ahead step tests up to 4 children of each of up to W frontier
// k-mers.  The bytes the work needs (each probed window or counter
// sector once) would take a tenth of the time or less.  So the design
// puts all of a step's probes in flight at once and keeps everything
// else off the chain: a lane's 8 candidates go to 8 threads, a root's
// children to the 32 threads of a warp (8 frontier slots a round), every
// test issues all of its loads (8 table slots, or H counters) before it
// looks at any, and the answers meet in a ballot (a lane's 8-bit mask
// decides its step; a root's 32-bit mask of children in (parent, base)
// order ranks the ones the frontier keeps).  A lane's head stays in
// registers and its last k bases in a ring in shared memory that each
// thread keeps for itself, so that no step reads back what an earlier
// one wrote to device memory and no step waits at a barrier; a root's
// codes and frontier live in shared memory (the frontier in device-memory
// scratch only when it does not fit).  A step then costs about one
// memory round trip; the times on the card are in PERF.md.
//
// Plain C interface for ctypes: each *_launch returns cudaGetLastError()
// after the launch, on the caller's stream, without synchronising.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROOTS_PER_BLOCK = THREADS / walk::BRANCH_GROUP;
// dynamic shared memory a block may take without opting in
constexpr int64_t SHARED_BYTES = 48 << 10;

// A group of G consecutive threads of a warp (G divides 32) acting as
// one lane's or root's members (walk.cuh).  Only the group's own lanes
// take part in its ballots and barriers, so groups of one warp may stop
// at different steps.
struct WarpGroup {
    static constexpr int LOCAL = 1;  // a member keeps its own values
    unsigned mask;  // the group's lanes of the warp
    int shift;      // its first lane
    int member;     // this thread's rank in the group

    __device__ static WarpGroup of(int G) {
        const int lane = int(threadIdx.x) & 31;
        const int shift = lane & ~(G - 1);
        const unsigned bits = G == 32 ? 0xFFFFFFFFu : (1u << G) - 1;
        return WarpGroup{bits << shift, shift, lane - shift};
    }
    __device__ int local(int) const { return 0; }
    // bit j: fn(j) of member j
    template <class Fn>
    __device__ uint32_t gather(int, Fn fn) const {
        return (__ballot_sync(mask, fn(member)) & mask) >> shift;
    }
    template <class Fn>
    __device__ void each(int, Fn fn) const {
        fn(member);
    }
    __device__ bool leader() const { return member == 0; }
    __device__ void sync() const { __syncwarp(mask); }
};

// Lanes of a walk block: 16 (128 threads), fewer when their threads'
// rings of bases (walk.cuh walk_lane) would not fit the block's shared
// memory; 0 when one lane's do not (k >= 4096).
int64_t lanes_per_block(int k) {
    const int64_t fit =
        SHARED_BYTES / (int64_t(walk::WALK_GROUP) * walk::ring_size(k));
    const int64_t most = THREADS / walk::WALK_GROUP;
    return fit < most ? fit : most;
}

template <class Solid>
__global__ void __launch_bounds__(THREADS)
walk_kernel(uint8_t* __restrict__ buf, int64_t P, int64_t BUF,
            int64_t* __restrict__ length, int64_t* __restrict__ f,
            int64_t* __restrict__ r, int8_t* __restrict__ status,
            const int64_t* __restrict__ seed_canon,
            bool* __restrict__ has_prev, Solid solid, int k,
            int64_t max_steps) {
    __shared__ nthash::Tables s_tab;
    extern __shared__ uint8_t s_rings[];
    if (threadIdx.x == 0) nthash::make_tables(s_tab, k);
    __syncthreads();
    const int in_block = int(threadIdx.x) / walk::WALK_GROUP;
    const int64_t lane =
        int64_t(blockIdx.x) * (blockDim.x / walk::WALK_GROUP) + in_block;
    // the same answer in every member of the lane's group
    if (lane >= P || status[lane] != walk::ACTIVE) return;
    const WarpGroup g = WarpGroup::of(walk::WALK_GROUP);
    walk::Lane s{length[lane], uint64_t(f[lane]), uint64_t(r[lane]),
                 status[lane], has_prev[lane]};
    walk::walk_lane(g, buf + lane * BUF, BUF, s, uint64_t(seed_canon[lane]),
                    solid, k, s_tab, max_steps,
                    s_rings + int64_t(threadIdx.x) * walk::ring_size(k));
    if (!g.leader()) return;
    length[lane] = s.length;
    f[lane] = int64_t(s.f);
    r[lane] = int64_t(s.r);
    status[lane] = s.status;
    has_prev[lane] = s.has_prev;
}

template <class Solid>
__global__ void __launch_bounds__(THREADS)
branch_kernel(const uint8_t* __restrict__ roots, int64_t N, int k,
              const int64_t* __restrict__ f0, const int64_t* __restrict__ r0,
              Solid solid, int max_depth, int W, int H,
              uint8_t* __restrict__ scratch, int32_t* __restrict__ depth,
              int64_t* __restrict__ probes) {
    __shared__ nthash::Tables s_tab;
    extern __shared__ uint64_t s_frontier[];
    if (threadIdx.x == 0) nthash::make_tables(s_tab, k);
    __syncthreads();
    const int group = int(threadIdx.x) / walk::BRANCH_GROUP;
    const int64_t i = int64_t(blockIdx.x) * ROOTS_PER_BLOCK + group;
    if (i >= N) return;
    const int64_t bytes = walk::frontier_bytes(W, H, k);
    uint8_t* region = scratch != nullptr
        ? scratch + i * bytes
        : reinterpret_cast<uint8_t*>(s_frontier) + group * bytes;
    const WarpGroup g = WarpGroup::of(walk::BRANCH_GROUP);
    int64_t np = 0;
    const int d = walk::branch_root(
        g, roots + i * k, uint64_t(f0[i]), uint64_t(r0[i]), solid, s_tab,
        max_depth, walk::frontier_at(region, W, H, k), &np);
    if (!g.leader()) return;
    depth[i] = d;
    if (probes != nullptr) probes[i] = np;
}

walk::TableSolid table_solid(const int64_t* tab, int64_t size) {
    return walk::TableSolid{reinterpret_cast<const uint64_t*>(tab),
                            uint64_t(size - 1)};
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

walk::ShardedSolid sharded_solid(const int64_t* shards, int64_t size,
                                 int log2_len, int hash_k, int num_hashes,
                                 int threshold) {
    return walk::ShardedSolid{
        reinterpret_cast<const unsigned long long*>(shards),
        uint64_t(size - 1), log2_len, hash_k, num_hashes, threshold};
}

int64_t scratch_bytes(int W, int H, int k) {
    const int64_t bytes = walk::frontier_bytes(W, H, k);
    return ROOTS_PER_BLOCK * bytes <= SHARED_BYTES ? 0 : bytes;
}

template <class Solid>
int walk_run(uint8_t* buf, int64_t P, int64_t BUF, int64_t* length,
             int64_t* f, int64_t* r, int8_t* status,
             const int64_t* seed_canon, bool* has_prev, Solid solid, int k,
             int64_t max_steps, void* stream) {
    const int64_t per = lanes_per_block(k);
    if (per < 1) return int(cudaErrorInvalidValue);
    const unsigned blocks = unsigned((P + per - 1) / per);
    walk_kernel<<<blocks, unsigned(per * walk::WALK_GROUP),
                  size_t(per * walk::WALK_GROUP * walk::ring_size(k)),
                  static_cast<cudaStream_t>(stream)>>>(
        buf, P, BUF, length, f, r, status, seed_canon, has_prev, solid, k,
        max_steps);
    return int(cudaGetLastError());
}

template <class Solid>
int branch_run(const uint8_t* roots, int64_t N, int k, const int64_t* f0,
               const int64_t* r0, Solid solid, int max_depth, int W, int H,
               uint8_t* scratch, int32_t* depth, int64_t* probes,
               void* stream) {
    const bool shared = scratch_bytes(W, H, k) == 0;
    if (!shared && scratch == nullptr) return int(cudaErrorInvalidValue);
    const size_t smem =
        shared ? size_t(ROOTS_PER_BLOCK * walk::frontier_bytes(W, H, k)) : 0;
    const unsigned blocks =
        unsigned((N + ROOTS_PER_BLOCK - 1) / ROOTS_PER_BLOCK);
    branch_kernel<<<blocks, THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        roots, N, k, f0, r0, solid, max_depth, W, H,
        shared ? nullptr : scratch, depth, probes);
    return int(cudaGetLastError());
}

}  // namespace

// Blocks of a walk launch over P lanes with k-mers of k bases, and of a
// look-ahead launch over N roots.
extern "C" int64_t walk_blocks(int64_t P, int k) {
    const int64_t per = lanes_per_block(k);
    return per < 1 ? 0 : (P + per - 1) / per;
}

extern "C" int64_t branch_blocks(int64_t N) {
    return (N + ROOTS_PER_BLOCK - 1) / ROOTS_PER_BLOCK;
}

// Device-memory scratch bytes per root that a look-ahead of frontier
// width W keeping H appended bases of k-mers of k bases needs: 0 when
// the frontiers of a block's roots fit its shared memory.
extern "C" int64_t branch_scratch_bytes(int W, int H, int k) {
    return scratch_bytes(W, H, k);
}

// buf: uint8 [P, BUF]; length/f/r/seed_canon: int64 [P]; status: int8
// [P]; has_prev: bool [P]; tab: int64 [size + 8], size a power of two.
// All contiguous and updated in place.  The caller checks P >= 1,
// k <= BUF, k < 4096 and P < 2^31.
extern "C" int walk_launch(uint8_t* buf, int64_t P, int64_t BUF,
                           int64_t* length, int64_t* f, int64_t* r,
                           int8_t* status, const int64_t* seed_canon,
                           bool* has_prev, const int64_t* tab, int64_t size,
                           int k, int64_t max_steps, void* stream) {
    return walk_run(buf, P, BUF, length, f, r, status, seed_canon, has_prev,
                    table_solid(tab, size), k, max_steps, stream);
}

// walk_launch on a counting Bloom filter: counters uint8 [size + 1],
// size a power of two; hash_k, num_hashes and threshold are the
// filter's.
extern "C" int walk_bloom_launch(uint8_t* buf, int64_t P, int64_t BUF,
                                 int64_t* length, int64_t* f, int64_t* r,
                                 int8_t* status, const int64_t* seed_canon,
                                 bool* has_prev, const uint8_t* counters,
                                 int64_t size, int hash_k, int num_hashes,
                                 int threshold, int k, int64_t max_steps,
                                 void* stream) {
    return walk_run(buf, P, BUF, length, f, r, status, seed_canon, has_prev,
                    bloom_solid(counters, size, hash_k, num_hashes,
                                threshold),
                    k, max_steps, stream);
}

// walk_launch on a cascading Bloom filter: levels uint8 [depth, size +
// 1], size a power of two; hash_k and num_hashes are the filter's.
extern "C" int walk_cascade_launch(uint8_t* buf, int64_t P, int64_t BUF,
                                   int64_t* length, int64_t* f, int64_t* r,
                                   int8_t* status, const int64_t* seed_canon,
                                   bool* has_prev, const uint8_t* levels,
                                   int64_t size, int hash_k, int num_hashes,
                                   int depth, int k, int64_t max_steps,
                                   void* stream) {
    return walk_run(buf, P, BUF, length, f, r, status, seed_canon, has_prev,
                    cascade_solid(levels, size, hash_k, num_hashes, depth),
                    k, max_steps, stream);
}

// roots: uint8 [N, k]; f0/r0: int64 [N]; tab: int64 [size + 8]; H =
// max_depth - k if positive, else 0; scratch: uint8 [N *
// branch_scratch_bytes(W, H, k)], null when that is 0; depth: int32 [N];
// probes (may be null): int64 [N] solidity tests per root.  The caller
// checks N >= 1, W >= 1 and N < 2^31.
extern "C" int branch_launch(const uint8_t* roots, int64_t N, int k,
                             const int64_t* f0, const int64_t* r0,
                             const int64_t* tab, int64_t size, int max_depth,
                             int W, int H, uint8_t* scratch, int32_t* depth,
                             int64_t* probes, void* stream) {
    return branch_run(roots, N, k, f0, r0, table_solid(tab, size), max_depth,
                      W, H, scratch, depth, probes, stream);
}

// branch_launch on a counting Bloom filter (see walk_bloom_launch).
extern "C" int branch_bloom_launch(const uint8_t* roots, int64_t N, int k,
                                   const int64_t* f0, const int64_t* r0,
                                   const uint8_t* counters, int64_t size,
                                   int hash_k, int num_hashes, int threshold,
                                   int max_depth, int W, int H,
                                   uint8_t* scratch, int32_t* depth,
                                   int64_t* probes, void* stream) {
    return branch_run(roots, N, k, f0, r0,
                      bloom_solid(counters, size, hash_k, num_hashes,
                                  threshold),
                      max_depth, W, H, scratch, depth, probes, stream);
}

// branch_launch on a cascading Bloom filter (see walk_cascade_launch).
extern "C" int branch_cascade_launch(const uint8_t* roots, int64_t N, int k,
                                     const int64_t* f0, const int64_t* r0,
                                     const uint8_t* levels, int64_t size,
                                     int hash_k, int num_hashes, int depth,
                                     int max_depth, int W, int H,
                                     uint8_t* scratch, int32_t* depth_out,
                                     int64_t* probes, void* stream) {
    return branch_run(roots, N, k, f0, r0,
                      cascade_solid(levels, size, hash_k, num_hashes, depth),
                      max_depth, W, H, scratch, depth_out, probes, stream);
}

// walk_launch on a counting filter split into shards: shards int64
// [size >> log2_len] device array of the shards' addresses, each uint8
// [1 << log2_len] on this card or on a card whose memory it can read
// (walk_enable_peer); size a power of two; hash_k, num_hashes and
// threshold are the filter's.
extern "C" int walk_sharded_launch(uint8_t* buf, int64_t P, int64_t BUF,
                                   int64_t* length, int64_t* f, int64_t* r,
                                   int8_t* status, const int64_t* seed_canon,
                                   bool* has_prev, const int64_t* shards,
                                   int64_t size, int log2_len, int hash_k,
                                   int num_hashes, int threshold, int k,
                                   int64_t max_steps, void* stream) {
    return walk_run(buf, P, BUF, length, f, r, status, seed_canon, has_prev,
                    sharded_solid(shards, size, log2_len, hash_k, num_hashes,
                                  threshold),
                    k, max_steps, stream);
}

// branch_launch on a counting filter split into shards (see
// walk_sharded_launch).
extern "C" int branch_sharded_launch(const uint8_t* roots, int64_t N, int k,
                                     const int64_t* f0, const int64_t* r0,
                                     const int64_t* shards, int64_t size,
                                     int log2_len, int hash_k,
                                     int num_hashes, int threshold,
                                     int max_depth, int W, int H,
                                     uint8_t* scratch, int32_t* depth,
                                     int64_t* probes, void* stream) {
    return branch_run(roots, N, k, f0, r0,
                      sharded_solid(shards, size, log2_len, hash_k,
                                    num_hashes, threshold),
                      max_depth, W, H, scratch, depth, probes, stream);
}

// Let the current card read card `peer`'s memory (a shard of a sharded
// filter there): 0 when it can and access is on, else the CUDA error.
extern "C" int walk_enable_peer(int peer) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return int(err);
    if (dev == peer) return 0;
    int can = 0;
    err = cudaDeviceCanAccessPeer(&can, dev, peer);
    if (err != cudaSuccess) return int(err);
    if (!can) return int(cudaErrorPeerAccessUnsupported);
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear it
        return 0;
    }
    return int(err);
}
