// Bodies of the walk kernels (walk.cu), run by a group of members:
//   * walk_lane: the lock-step extension of dbg/extend.py's `_step`, run
//     for one lane until it stops or its step budget is spent, by
//     WALK_GROUP = 8 members: member j rolls and tests candidate j of a
//     step (walk_member), and the group's 8-bit mask of answers decides
//     the step (walk_advance);
//   * branch_root: dbg/extend.py's `branch_depths` breadth-first
//     look-ahead, run for one root by BRANCH_GROUP = 32 members: member
//     j tests child j % 4 of frontier slot j / 4 (of the next 8 slots, a
//     round; branch_member), and the group's 32-bit mask of children in
//     (parent, base) order ranks the ones the frontier keeps
//     (branch_keep).
//
// A group is a template parameter.  On the card it is a warp-aligned
// group of threads whose answers meet in a ballot (walk.cu WarpGroup);
// on the host it is SerialGroup below, one thread playing every member
// in turn.  Either way the same functions run in the same order, and the
// group's state (a lane's head, a root's frontier size) is the same in
// every member.
//
// Both take the solidity test of a canonical k-mer hash as a template
// parameter: `TableSolid`, the open-addressing walk table of a sorted
// filter's solid keys (ops/hash_probe.ProbeSet), `BloomSolid`, the
// counting Bloom filter's "min over the H counters >= threshold"
// (ops/bloom.CountingBloomFilter.contains), `CascadeSolid`, the cascading
// Bloom filter's, or `ShardedSolid`, BloomSolid's test on counters split
// into shards (parallel/distributed.ShardedCountingFilter).  Each issues
// all of its loads before it looks at any of them, so a test costs one
// memory round trip (two for ShardedSolid: shard address, then counter).
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

#ifdef __CUDA_ARCH__
#define WALK_LDG(p) __ldg(p)  // read-only inputs: the non-coherent path
#else
#define WALK_LDG(p) (*(p))
#endif

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
// counting-filter counters loaded together (the filter's default H)
constexpr int BLOOM_BATCH = 4;

// members of a lane's group (4 successors, 4 predecessors) and of a
// root's group (a child each: 8 frontier slots a round)
constexpr int WALK_GROUP = 8;
constexpr int BRANCH_GROUP = 32;

NT_HD int popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

// index of set bit number j (from 0, lowest first) of x; x has > j
NT_HD int nth_set(uint32_t x, int j) {
    for (; j > 0; --j) x &= x - 1;
#ifdef __CUDA_ARCH__
    return __ffs(int(x)) - 1;
#else
    return __builtin_ctz(x);
#endif
}

// One thread playing every member of a group in turn (the host loops).
// A member's own values live in slot local(j) of arrays of LOCAL.
struct SerialGroup {
    static constexpr int LOCAL = 32;
    int local(int j) const { return j; }
    // bit j: fn(j) for the n <= 32 members j
    template <class Fn>
    uint32_t gather(int n, Fn fn) const {
        uint32_t m = 0;
        for (int j = 0; j < n; ++j) m |= uint32_t(bool(fn(j))) << j;
        return m;
    }
    // fn(j) for every member j
    template <class Fn>
    void each(int n, Fn fn) const {
        for (int j = 0; j < n; ++j) fn(j);
    }
    bool leader() const { return true; }
    void sync() const {}
};

// splitmix64 finalizer (ops/hash_probe.mix64)
NT_HD uint64_t mix64(uint64_t z) {
    z += 0x9E3779B97F4A7C15ULL;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

// Membership of q in the open-addressing table tab[size + PROBE]
// (ops/hash_probe.contains): any of the PROBE slots from mix64(q) & mask
// holds q.  All slots are loaded before any is compared.
NT_HD bool probe(const uint64_t* tab, uint64_t mask, uint64_t q) {
    const uint64_t* w = tab + (mix64(q) & mask);
    uint64_t s[PROBE];
    for (int b = 0; b < PROBE; ++b) s[b] = WALK_LDG(w + b);
    bool hit = false;
    for (int b = 0; b < PROBE; ++b) hit |= s[b] == q;
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
// takes it).  The counters are loaded BLOOM_BATCH at a time, with no
// early exit, and give the same answer as a test that stops at the
// first counter below the threshold.
struct BloomSolid {
    const uint8_t* counters;  // [size + 1], the last slot the sink
    uint64_t mask;            // size - 1
    int k;                    // the filter's k, which seeds its extra hashes
    int num_hashes;
    int threshold;
    NT_HD bool operator()(uint64_t q) const {
        bool ok = true;
        for (int i0 = 0; i0 < num_hashes; i0 += BLOOM_BATCH) {
            int c[BLOOM_BATCH];
            for (int j = 0; j < BLOOM_BATCH; ++j) {
                const int i = i0 + j;
                const uint64_t h = i == 0 ? q : nthash::nte64(q, k, i);
                c[j] = i < num_hashes ? int(WALK_LDG(counters + (h & mask)))
                                      : threshold;
            }
            for (int j = 0; j < BLOOM_BATCH; ++j) ok &= c[j] >= threshold;
        }
        return ok;
    }
};

// Solid = held in every level of a cascading Bloom filter, as
// CascadingBloomFilter.contains tests it: a key's level is the number of
// consecutive levels from the bottom whose H bytes at nte64(q, k, i) &
// mask, i < H, are all set, and it is solid when that reaches the
// depth L, that is when all L x H bytes are set.  Level l starts at
// levels + l * stride (stride = size + 1, the sink included).  The bytes
// are loaded BLOOM_BATCH hashes a level at a time, with no early exit.
struct CascadeSolid {
    const uint8_t* levels;  // [depth, size + 1]
    uint64_t mask;          // size - 1
    int64_t stride;         // size + 1
    int k;                  // the filter's k, which seeds its extra hashes
    int num_hashes;
    int depth;
    NT_HD bool operator()(uint64_t q) const {
        bool ok = true;
        for (int i0 = 0; i0 < num_hashes; i0 += BLOOM_BATCH) {
            uint64_t h[BLOOM_BATCH];
            for (int j = 0; j < BLOOM_BATCH; ++j) {
                const int i = i0 + j;
                h[j] = (i == 0 ? q : nthash::nte64(q, k, i)) & mask;
            }
            for (int l = 0; l < depth; ++l) {
                const uint8_t* level = levels + l * stride;
                int c[BLOOM_BATCH];
                for (int j = 0; j < BLOOM_BATCH; ++j)
                    c[j] = i0 + j < num_hashes ? int(WALK_LDG(level + h[j]))
                                               : 1;
                for (int j = 0; j < BLOOM_BATCH; ++j) ok &= c[j] > 0;
            }
        }
        return ok;
    }
};

// Solid = BloomSolid's test on a counting filter whose counters are split
// by index range into shards (parallel/distributed.ShardedCountingFilter):
// counter idx lies at shards[idx >> log2_len][idx & (shard_len - 1)].
// `shards` holds the shards' base addresses (device memory on the card,
// read through the read-only cache; a shard on another card is read by
// peer access).  Each counter's shard address is loaded before its
// counter, all BLOOM_BATCH of them before any counter.
struct ShardedSolid {
    const unsigned long long* shards;  // [size >> log2_len] addresses
    uint64_t mask;                     // size - 1
    int log2_len;                      // log2(shard_len)
    int k;                             // the filter's k (its extra hashes)
    int num_hashes;
    int threshold;
    NT_HD bool operator()(uint64_t q) const {
        const uint64_t in_shard = (uint64_t(1) << log2_len) - 1;
        bool ok = true;
        for (int i0 = 0; i0 < num_hashes; i0 += BLOOM_BATCH) {
            uint64_t idx[BLOOM_BATCH];
            const uint8_t* base[BLOOM_BATCH];
            for (int j = 0; j < BLOOM_BATCH; ++j) {
                const int i = i0 + j;
                idx[j] = (i == 0 ? q : nthash::nte64(q, k, i)) & mask;
                base[j] = reinterpret_cast<const uint8_t*>(
                    WALK_LDG(shards + (idx[j] >> log2_len)));
            }
            int c[BLOOM_BATCH];
            for (int j = 0; j < BLOOM_BATCH; ++j)
                c[j] = i0 + j < num_hashes
                           ? int(WALK_LDG(base[j] + (idx[j] & in_shard)))
                           : threshold;
            for (int j = 0; j < BLOOM_BATCH; ++j) ok &= c[j] >= threshold;
        }
        return ok;
    }
};

struct Lane {
    int64_t length;   // bases in buf
    uint64_t f, r;    // forward / reverse hash of the head k-mer
    int8_t status;
    bool has_prev;    // buf[length-k-1] is a known predecessor
};

// (fwd, rev) hash of candidate j of the head (f, r): successor j (append
// base j, drop base co) for j < 4, else predecessor j - 4 (prepend base
// j - 4, drop the head's last base cb).
NT_HD void candidate(int j, uint64_t f, uint64_t r, int co, int cb,
                     const nthash::Tables& t, uint64_t& cf, uint64_t& cr) {
    const int c = j & 3;
    if (j < 4) {
        cf = nthash::srol1(f) ^ t.f[c] ^ t.fk[co];
        cr = nthash::sror1(r ^ t.rk[c] ^ t.r[co]);
    } else {
        cf = nthash::sror1(f ^ t.fk[c] ^ t.f[cb]);
        cr = nthash::srol1(r) ^ t.r[c] ^ t.rk[cb];
    }
}

// Member j's share of a step: is candidate j solid?
template <class Solid>
NT_HD bool walk_member(int j, const Lane& s, int co, int cb,
                       const Solid& solid, const nthash::Tables& t) {
    uint64_t cf, cr;
    candidate(j, s.f, s.r, co, cb, t, cf, cr);
    return solid(cf < cr ? cf : cr);
}

NT_HD uint64_t pick4(const uint64_t* a, int i) {
    return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// The step that the group's answers m (bit j: candidate j solid) decide,
// in `_step`'s order, given the head's successor hashes (sf, sr)[c]:
// returns the base to append at buf[s.length - 1] after advancing s, or
// -1 after setting s.status.
NT_HD int walk_advance(unsigned m, Lane& s, const uint64_t* sf,
                       const uint64_t* sr, uint64_t seed_canon,
                       int64_t BUF) {
    const unsigned fwd = m & 0xF, back = (m >> 4) & 0xF;
    if (s.has_prev && (back & (back - 1))) { s.status = NEED_B; return -1; }
    if (fwd == 0) { s.status = DEAD_END; return -1; }
    if (fwd & (fwd - 1)) { s.status = NEED_F; return -1; }
    const int base = fwd == 1 ? 0 : fwd == 2 ? 1 : fwd == 4 ? 2 : 3;
    const uint64_t nf = pick4(sf, base), nr = pick4(sr, base);
    if ((nf < nr ? nf : nr) == seed_canon) { s.status = CYCLE; return -1; }
    if (s.length >= BUF) { s.status = CHUNK_LIMIT; return -1; }
    ++s.length;
    s.f = nf;
    s.r = nr;
    s.has_prev = true;
    return base;
}

// Bases a lane's ring holds: the least power of two above k, so that
// the base a step appends never takes the slot of the one it drops.
NT_HD int ring_size(int k) {
    int R = 1;
    while (R <= k) R <<= 1;
    return R;
}

// Run lane `s` (its buffer row `buf` of BUF bytes) for up to max_steps
// steps with group g; returns the steps taken, the last of them the one
// that stopped the lane if it stopped.  `ring` (ring_size(k) bytes)
// holds the codes of the lane's last k bases, buf[i] at ring[i % R], so
// that no step reads buf back.  Each member keeps its own ring: every
// member learns each step's base from the group's answers, so no member
// reads what another wrote and a step needs no barrier.  The leader
// appends the bases to buf.
template <class Solid, class Group>
NT_HD int64_t walk_lane(const Group& g, uint8_t* buf, int64_t BUF, Lane& s,
                        uint64_t seed_canon, const Solid& solid, int k,
                        const nthash::Tables& t, int64_t max_steps,
                        uint8_t* ring) {
    const int64_t R = ring_size(k), head = s.length - k;
    for (int i = 0; i < k; ++i)
        ring[(head + i) & (R - 1)] =
            uint8_t(nthash::clamp_code(buf[head + i]));
    int64_t n = 0;
    while (n < max_steps && s.status == ACTIVE) {
        ++n;
        const int co = ring[(s.length - k) & (R - 1)];   // leaving
        const int cb = ring[(s.length - 1) & (R - 1)];   // head end
        const unsigned m = g.gather(WALK_GROUP, [&](int j) {
            return walk_member(j, s, co, cb, solid, t);
        });
        // after the probes: work before them would delay them
        uint64_t sf[4], sr[4];
        for (int c = 0; c < 4; ++c)
            candidate(c, s.f, s.r, co, cb, t, sf[c], sr[c]);
        const int base = walk_advance(m, s, sf, sr, seed_canon, BUF);
        if (base < 0) break;
        ring[(s.length - 1) & (R - 1)] = uint8_t(base);
        if (g.leader()) buf[s.length - 1] = uint8_t(base);
    }
    return n;
}

// A root's frontier: hashes and appended bases of at most W live k-mers,
// in two ping-pong halves b = 0, 1, and the root's codes:
//   f, r:  [2][W] hashes;   hist: [2][W][H] appended bases;   root: [k].
struct Frontier {
    uint64_t* f;
    uint64_t* r;
    uint8_t* hist;
    uint8_t* root;
    int W, H, k;
};

// Bytes of one root's frontier (a multiple of 8).
NT_HD int64_t frontier_bytes(int W, int H, int k) {
    return (int64_t(32) * W + int64_t(2) * W * H + k + 7) / 8 * 8;
}

// The frontier laid out at `region` (8-byte aligned, frontier_bytes).
NT_HD Frontier frontier_at(void* region, int W, int H, int k) {
    uint64_t* p = static_cast<uint64_t*>(region);
    uint8_t* hist = reinterpret_cast<uint8_t*>(p + 4 * int64_t(W));
    return Frontier{p, p + 2 * int64_t(W), hist,
                    hist + int64_t(2) * W * H, W, H, k};
}

NT_HD int64_t slot(const Frontier& fr, int b, int w) {
    return int64_t(b) * fr.W + w;
}

// The base that frontier k-mer (b, w) drops at step `step`: root[step]
// while step < k, else the base its path appended at step - k.
NT_HD int branch_drop(const Frontier& fr, int b, int w, int step) {
    return step < fr.k ? int(fr.root[step])
                       : int(fr.hist[slot(fr, b, w) * fr.H + (step - fr.k)]);
}

// Member share of a round: is child c of frontier k-mer (cur, w) solid?
// (cf, cr) receive its hashes.
template <class Solid>
NT_HD bool branch_member(const Frontier& fr, int cur, int w, int c, int step,
                         const Solid& solid, const nthash::Tables& t,
                         uint64_t& cf, uint64_t& cr) {
    const int64_t p = slot(fr, cur, w);
    candidate(c, fr.f[p], fr.r[p], branch_drop(fr, cur, w, step), 0, t, cf,
              cr);
    return solid(cf < cr ? cf : cr);
}

// Child c of frontier k-mer (cur, w), hashes (cf, cr), kept at `rank` of
// the next frontier: it takes its parent's appended bases and, while
// step < H, its own base.
NT_HD void branch_keep(const Frontier& fr, int cur, int nxt, int w, int c,
                       int rank, int step, uint64_t cf, uint64_t cr) {
    const int64_t o = slot(fr, nxt, rank), p = slot(fr, cur, w);
    const int H = fr.H, keep = step < H ? step : H;
    fr.f[o] = cf;
    fr.r[o] = cr;
    for (int s = 0; s < keep; ++s) fr.hist[o * H + s] = fr.hist[p * H + s];
    if (step < H) fr.hist[o * H + step] = uint8_t(c);
}

// Forward look-ahead depth of one root k-mer (branch_depths), searched
// by group g: a breadth-first search whose frontier keeps at most W live
// k-mers, the first W solid children in (parent, base) order, as the
// plain version's stable compaction keeps them.  Returns the number of
// steps, up to max_depth, after which the frontier still holds a live
// k-mer; *probes receives the solidity tests that a sequential scan in
// (parent, base) order makes, up to and including a step's W-th solid
// child (the group's further tests in a step are not counted).
//
// A frontier k-mer is its hashes plus the bases it will drop: at step
// `step` it drops root[step] while step < k, else the base its path
// appended at step - k.  Only those appended bases are kept (H =
// max_depth - k of them, none when max_depth <= k).  Each step runs in
// rounds of BRANCH_GROUP / 4 parent slots; a round's mask holds bit j
// for child j % 4 of slot j / 4, so a child's rank is the solid
// children before it in the rounds so far.
template <class Solid, class Group>
NT_HD int branch_root(const Group& g, const uint8_t* root, uint64_t f0,
                      uint64_t r0, const Solid& solid,
                      const nthash::Tables& t, int max_depth,
                      const Frontier& fr, int64_t* probes) {
    constexpr int SLOTS = BRANCH_GROUP / 4;
    const int W = fr.W;
    g.each(BRANCH_GROUP, [&](int j) {
        for (int i = j; i < fr.k; i += BRANCH_GROUP)
            fr.root[i] = uint8_t(nthash::clamp_code(WALK_LDG(root + i)));
    });
    if (g.leader()) {
        fr.f[0] = f0;
        fr.r[0] = r0;
    }
    g.sync();
    uint64_t cf[Group::LOCAL], cr[Group::LOCAL];
    int n = 1, cur = 0, depth = 0;
    int64_t np = 0;
    for (int step = 0; step < max_depth; ++step) {
        const int nxt = cur ^ 1;
        int carry = 0;                // solid children of the rounds so far
        int64_t tested = int64_t(4) * n;   // if fewer than W are solid
        for (int s0 = 0; s0 < n && carry < W; s0 += SLOTS) {
            const uint32_t word = g.gather(BRANCH_GROUP, [&](int j) {
                return s0 + j / 4 < n &&
                       branch_member(fr, cur, s0 + j / 4, j & 3, step, solid,
                                     t, cf[g.local(j)], cr[g.local(j)]);
            });
            g.each(BRANCH_GROUP, [&](int j) {
                const int rank = carry + popc32(word & ((1u << j) - 1));
                if ((word >> j) & 1 && rank < W)
                    branch_keep(fr, cur, nxt, s0 + j / 4, j & 3, rank, step,
                                cf[g.local(j)], cr[g.local(j)]);
            });
            const int got = popc32(word);
            if (carry + got >= W)
                tested = int64_t(4) * s0 + nth_set(word, W - 1 - carry) + 1;
            carry += got;
        }
        np += tested;
        g.sync();   // the next step reads what the members kept
        if (carry == 0) break;  // no live k-mer: depth stops growing
        ++depth;
        n = carry < W ? carry : W;
        cur = nxt;
    }
    *probes = np;
    return depth;
}

}  // namespace walk
