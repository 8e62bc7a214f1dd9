// Per-thread bodies of the walk kernels (walk.cu):
//   * walk_lane: the lock-step extension of dbg/extend.py's `_step`, run
//     for one lane until it stops or its step budget is spent;
//   * branch_root: dbg/extend.py's `branch_depths` breadth-first
//     look-ahead, run for one root.
//
// Both take the solidity test of a canonical k-mer hash as a template
// parameter: `TableSolid`, the open-addressing walk table of a sorted
// filter's solid keys (ops/hash_probe.ProbeSet), or `BloomSolid`, the
// counting Bloom filter's "min over the H counters >= threshold"
// (ops/bloom.CountingBloomFilter.contains).
//
// Like nthash.cuh, every function is `__host__ __device__` and plain C++
// otherwise, so g++ compiles it too: the CPU test suite runs both over
// every lane or root in a host loop and holds the results bit-identical
// to the plain PyTorch versions (extend.fast_extend_plain,
// extend.branch_depths_plain).
//
// Lanes never read each other's state, and a step leaves a lane that is
// no longer ACTIVE untouched, so walking each lane on its own for up to
// max_steps steps gives exactly the state that max_steps lock steps of
// the whole batch give.
//
// One step of an ACTIVE lane whose head k-mer ends at buf[length-1]:
//   * roll the head's (fwd, rev) hash to its 4 successors (append base
//     c, drop buf[length-k]) and its 4 predecessors (prepend c, drop
//     buf[length-1]); test the 8 canonical hashes for solidity;
//   * >= 2 solid predecessors after a known predecessor -> NEED_B;
//     no solid successor -> DEAD_END; >= 2 -> NEED_F; the one successor
//     is the seed again -> CYCLE; the buffer is full -> CHUNK_LIMIT;
//   * else append the successor's base and take its hashes.

#pragma once

#include <stdint.h>

#include "nthash.cuh"

namespace walk {

// path status codes (dbg/extend.py)
constexpr int8_t ACTIVE = 0;
constexpr int8_t DEAD_END = 1;
constexpr int8_t CYCLE = 4;
constexpr int8_t CHUNK_LIMIT = 5;
constexpr int8_t NEED_B = 6;
constexpr int8_t NEED_F = 7;

// slots scanned per probe (ops/hash_probe.py B)
constexpr int PROBE = 8;

// splitmix64 finalizer (ops/hash_probe.mix64)
NT_HD uint64_t mix64(uint64_t z) {
    z += 0x9E3779B97F4A7C15ULL;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

// Membership of q in the open-addressing table tab[size + PROBE]
// (ops/hash_probe.contains): any of the PROBE slots from mix64(q) & mask
// holds q.
NT_HD bool probe(const uint64_t* tab, uint64_t mask, uint64_t q) {
    const uint64_t* w = tab + (mix64(q) & mask);
    bool hit = false;
    for (int b = 0; b < PROBE; ++b) hit |= w[b] == q;
    return hit;
}

// Solid = held in the walk table.
struct TableSolid {
    const uint64_t* tab;  // [size + PROBE]
    uint64_t mask;        // size - 1
    NT_HD bool operator()(uint64_t q) const { return probe(tab, mask, q); }
};

// Solid = each of the H counters at nte64(q, k, i) & mask, i < H, is at
// least threshold (their minimum is, as CountingBloomFilter.count
// takes it); stops at the first counter below it.
struct BloomSolid {
    const uint8_t* counters;  // [size + 1], the last slot the sink
    uint64_t mask;            // size - 1
    int k;                    // the filter's k, which seeds its extra hashes
    int num_hashes;
    int threshold;
    NT_HD bool operator()(uint64_t q) const {
        for (int i = 0; i < num_hashes; ++i) {
            const uint64_t h = i == 0 ? q : nthash::nte64(q, k, i);
            if (int(counters[h & mask]) < threshold) return false;
        }
        return true;
    }
};

struct Lane {
    int64_t length;   // bases in buf
    uint64_t f, r;    // forward / reverse hash of the head k-mer
    int8_t status;
    bool has_prev;    // buf[length-k-1] is a known predecessor
};

// Run lane `s` (its buffer row `buf` of BUF bytes) for up to max_steps
// steps; returns the steps taken, the last of them the one that stopped
// the lane if it stopped.
template <class Solid>
NT_HD int64_t walk_lane(uint8_t* buf, int64_t BUF, Lane& s,
                        uint64_t seed_canon, const Solid& solid, int k,
                        const nthash::Tables& t, int64_t max_steps) {
    int64_t n = 0;
    while (n < max_steps && s.status == ACTIVE) {
        ++n;
        const int co = nthash::clamp_code(buf[s.length - k]);   // leaving
        const int cb = nthash::clamp_code(buf[s.length - 1]);   // head end
        const uint64_t fl = nthash::srol1(s.f), rl = nthash::srol1(s.r);
        uint64_t fc[4], rc[4];
        int n_fwd = 0, n_back = 0, base = -1;
        for (int c = 0; c < 4; ++c) {
            fc[c] = fl ^ t.f[c] ^ t.fk[co];
            rc[c] = nthash::sror1(s.r ^ t.rk[c] ^ t.r[co]);
            if (solid(fc[c] < rc[c] ? fc[c] : rc[c])) {
                ++n_fwd;
                if (base < 0) base = c;
            }
            const uint64_t fb = nthash::sror1(s.f ^ t.fk[c] ^ t.f[cb]);
            const uint64_t rb = rl ^ t.r[c] ^ t.rk[cb];
            n_back += solid(fb < rb ? fb : rb);
        }
        if (s.has_prev && n_back >= 2) { s.status = NEED_B; break; }
        if (n_fwd == 0) { s.status = DEAD_END; break; }
        if (n_fwd >= 2) { s.status = NEED_F; break; }
        const uint64_t nf = fc[base], nr = rc[base];
        if ((nf < nr ? nf : nr) == seed_canon) { s.status = CYCLE; break; }
        if (s.length >= BUF) { s.status = CHUNK_LIMIT; break; }
        buf[s.length] = uint8_t(base);
        ++s.length;
        s.f = nf;
        s.r = nr;
        s.has_prev = true;
    }
    return n;
}

// Forward look-ahead depth of one root k-mer (branch_depths): a
// breadth-first search whose frontier keeps at most W live k-mers, the
// first W solid children in (parent, base) order, as the plain version's
// stable compaction keeps them.  Returns the number of steps, up to
// max_depth, after which the frontier still holds a live k-mer; *probes
// receives the number of solidity tests made.
//
// A frontier k-mer is its hashes plus the bases it will drop: at step
// `step` it drops root[step] while step < k, else the base its path
// appended at step - k.  Only those appended bases are kept (H =
// max_depth - k of them, none when max_depth <= k).  Scratch, written
// by the caller's thread only, in two ping-pong halves b = 0, 1, with
// the root index i innermost so that a warp's accesses coalesce:
//   fs, rs:  [2][W][N] hashes;   hist: [2][W][H][N] appended bases.
template <class Solid>
NT_HD int branch_root(const uint8_t* root, int k, uint64_t f0, uint64_t r0,
                      const Solid& solid, const nthash::Tables& t,
                      int max_depth, int W,
                      int64_t N, int64_t i, uint64_t* fs, uint64_t* rs,
                      uint8_t* hist, int H, int64_t* probes) {
#define BR_F(b, w) ((int64_t(b) * W + (w)) * N + i)
#define BR_H(b, w, s) (((int64_t(b) * W + (w)) * H + (s)) * N + i)
    int n = 1, cur = 0, depth = 0;
    int64_t np = 0;
    fs[BR_F(0, 0)] = f0;
    rs[BR_F(0, 0)] = r0;
    for (int step = 0; step < max_depth; ++step) {
        const int nxt = cur ^ 1;
        const int keep = step < H ? step : H;  // parent bases to copy
        int m = 0;
        for (int w = 0; w < n && m < W; ++w) {
            const int co = step < k ? nthash::clamp_code(root[step])
                                    : int(hist[BR_H(cur, w, step - k)]);
            const uint64_t f = fs[BR_F(cur, w)], r = rs[BR_F(cur, w)];
            const uint64_t fl = nthash::srol1(f);
            for (int c = 0; c < 4 && m < W; ++c) {
                const uint64_t fc = fl ^ t.f[c] ^ t.fk[co];
                const uint64_t rc = nthash::sror1(r ^ t.rk[c] ^ t.r[co]);
                ++np;
                if (!solid(fc < rc ? fc : rc)) continue;
                fs[BR_F(nxt, m)] = fc;
                rs[BR_F(nxt, m)] = rc;
                for (int s = 0; s < keep; ++s)
                    hist[BR_H(nxt, m, s)] = hist[BR_H(cur, w, s)];
                if (step < H) hist[BR_H(nxt, m, step)] = uint8_t(c);
                ++m;
            }
        }
        if (m == 0) break;  // no live k-mer: depth stops growing
        ++depth;
        n = m;
        cur = nxt;
    }
#undef BR_F
#undef BR_H
    *probes = np;
    return depth;
}

}  // namespace walk
