// Per-window arithmetic of the canonical ntHash kernel (nthash.cu).
//
// Every function here is `__host__ __device__` and plain C++ otherwise,
// so g++ compiles this header too: the CPU test suite loops
// `scan_strip` and `hash_strip` over the same grids the kernel launches, in both
// layouts, and holds the result bit-identical to the port's plain
// PyTorch version (ops/nthash.kmer_hashes_plain).
//
// Definitions (ntHash, Mohamadi et al. 2016; abyss_tpu/ops/nthash.py):
// srol rotates the low 33 bits and the high 31 bits of a word
// independently, and for the window s[i, i+k)
//   fwd(i) = XOR_j srol^(k-1-j) F[s(i+j)],  rev(i) = XOR_j srol^j R[s(i+j)],
//   canon(i) = min(fwd(i), rev(i))  (unsigned),
// where F/R are the forward / complement seed tables and any code >= 4
// (N or padding) has seed 0.  valid(i) says the window holds no code >= 4.
// A thread hashes the first window of its strip from the definition in
// O(k), then rolls to the next window in O(1):
//   fwd(i+1) = srol(fwd(i)) ^ srol^k(F[s(i)]) ^ F[s(i+k)]
//   rev(i+1) = sror(rev(i) ^ R[s(i)] ^ srol^k(R[s(i+k)]))
// A strip whose bases are all codes >= 4 (a padded read's tail) has
// every seed 0, so its windows are 0 with valid false: it writes them
// without any arithmetic.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define NT_HD __host__ __device__ __forceinline__
#else
#define NT_HD inline
#endif

namespace nthash {

constexpr uint64_t SEED_A = 0x3C8BFBB395C60474ULL;
constexpr uint64_t SEED_C = 0x3193C18562A02B4CULL;
constexpr uint64_t SEED_G = 0x20323ED082572324ULL;
constexpr uint64_t SEED_T = 0x295549F54BE24456ULL;
constexpr uint64_t M33 = (1ULL << 33) - 1;
constexpr uint64_t M31 = (1ULL << 31) - 1;
// extra Bloom hashes (nthash.hpp multiSeed / multiShift)
constexpr uint64_t MULTI_SEED = 0x90B45D39FB6DA1FAULL;
constexpr int MULTI_SHIFT = 27;

// Launch geometry, shared with the host harness.  A block of THREADS
// threads hashes at most TILE windows, each thread a strip of up to
// STRIP consecutive windows of one row, in one of two layouts:
//   tile:   one segment of up to `seg` <= TILE windows of one row;
//   packed: `rows` > 1 whole rows of W windows each, rows whose strips
//           fit THREADS (rows * ceil(W / STRIP) <= THREADS) and whose
//           bases fit PACK_CODES (rows * L <= PACK_CODES).
// ops/kernels.nthash_layout picks one from the shape.  The block stages
// the bases it reads and the canon/valid it writes in shared memory.
constexpr int THREADS = 256;
constexpr int STRIP = 16;
constexpr int TILE = THREADS * STRIP;
constexpr int PACK_CODES = 8192;

// Seed of base code c (0..3 = A,C,G,T; 4 = N/padding) on the forward
// (strand 0) or reverse-complement (strand 1) strand.
NT_HD uint64_t seed(int strand, int c) {
    if (c >= 4) return 0;
    const int b = strand ? 3 - c : c;
    return b == 0 ? SEED_A : b == 1 ? SEED_C : b == 2 ? SEED_G : SEED_T;
}

// Split-rotate left by n >= 0.
NT_HD uint64_t srol(uint64_t v, int n) {
    const unsigned n33 = unsigned(n % 33), n31 = unsigned(n % 31);
    uint64_t lo = v & M33, hi = v >> 33;
    lo = ((lo << n33) | (lo >> (33 - n33))) & M33;
    hi = ((hi << n31) | (hi >> (31 - n31))) & M31;
    return (hi << 33) | lo;
}

// srol(v, 1) as one 64-bit shift and two bit moves: v << 1 is right
// except for bit 32 (goes to bit 0, not 33) and bit 63 (goes to 33).
NT_HD uint64_t srol1(uint64_t v) {
    return ((v << 1) & ~(1ULL << 33)) | ((v >> 32) & 1) |
           ((v >> 30) & (1ULL << 33));
}

// The inverse: v >> 1 is right except for bit 0 (goes to bit 32) and
// bit 33 (goes to bit 63, not 32).
NT_HD uint64_t sror1(uint64_t v) {
    return ((v >> 1) & ~(1ULL << 32)) | ((v & 1) << 32) |
           ((v & (1ULL << 33)) << 30);
}

// Seeds and k-rotated seeds, indexed by code 0..4.
struct Tables {
    uint64_t f[5], r[5], fk[5], rk[5];
};

NT_HD void make_tables(Tables& t, int k) {
    for (int c = 0; c < 5; ++c) {
        t.f[c] = seed(0, c);
        t.r[c] = seed(1, c);
        t.fk[c] = srol(t.f[c], k);
        t.rk[c] = srol(t.r[c], k);
    }
}

NT_HD int clamp_code(uint8_t c) { return c < 4 ? int(c) : 4; }

// Extra hash #i of base hash h for k-mers of length k (NTE64,
// nthash.hpp:337-343; ops/nthash.nte64).  Hash #0 is h itself.
NT_HD uint64_t nte64(uint64_t h, int k, int i) {
    const uint64_t t = h * (uint64_t(i) ^ (uint64_t(k) * MULTI_SEED));
    return t ^ (t >> MULTI_SHIFT);
}

// Whether the nwin windows from codes[0] (codes[0 .. nwin+k-2]) hold a
// base.  The first code says so for most strips; else the rest are read
// 8 at a time, all 8 loads at once.
NT_HD bool has_base(const uint8_t* codes, int k, int nwin) {
    const int span = nwin + k - 1;
    bool base = codes[0] < 4;
    for (int j = 1; j < span && !base; j += 8)
        for (int u = 0; u < 8; ++u) base |= j + u < span && codes[j + u] < 4;
    return base;
}

// Hash nwin >= 1 consecutive windows whose first base is codes[0]
// (codes[0 .. nwin+k-2] readable).  fwd/rev may be null.
NT_HD void strip(const uint8_t* codes, int k, int nwin, const Tables& t,
                 uint64_t* canon, uint8_t* valid, uint64_t* fwd,
                 uint64_t* rev) {
    // the first window: both strands' chains side by side
    uint64_t f = 0, r = 0;
    int nbad = 0;
    for (int j = 0; j < k; ++j) {
        const int c = clamp_code(codes[j]);
        f = srol1(f) ^ t.f[c];
        r = srol1(r) ^ t.r[clamp_code(codes[k - 1 - j])];
        nbad += c == 4;
    }
    for (int i = 0;; ++i) {
        canon[i] = f < r ? f : r;
        valid[i] = nbad == 0;
        if (fwd != nullptr) fwd[i] = f;
        if (rev != nullptr) rev[i] = r;
        if (i + 1 == nwin) break;
        const int co = clamp_code(codes[i]), ci = clamp_code(codes[i + k]);
        f = srol1(f) ^ t.f[ci] ^ t.fk[co];
        r = sror1(r ^ t.r[co] ^ t.rk[ci]);
        nbad += int(ci == 4) - int(co == 4);
    }
}

// A strip's canon/valid go to its own run of SLOT = STRIP + 1 entries of
// the block's shared arrays: with runs of STRIP, the 32 threads of a warp
// would store each step's windows STRIP * 8 bytes apart, all in one bank
// pair, a 32-way conflict on every store.
constexpr int SLOT = STRIP + 1;

// Strip `sid` of a block that covers nrows rows of nw windows each
// (nrows > 1 only in the packed layout, where nw is the whole row): strip
// sid % spr of row sid / spr, spr the strips a row has.  Sets its row,
// first window s0 and window count n; false when the block has no
// strip sid.
NT_HD bool strip_of(int sid, int nrows, int nw, int& row, int& s0, int& n) {
    const int spr = (nw + STRIP - 1) / STRIP;
    row = sid / spr;
    s0 = (sid % spr) * STRIP;
    n = nw - s0 < STRIP ? nw - s0 : STRIP;
    return row < nrows;
}

// A block hashes in two passes.  First every thread looks at strip tid:
// a strip that holds no base gets its windows' values here (0, the
// formula's own value there: every seed is 0) and the call returns
// false; true means the strip needs hashing.  Then the strips that need
// it are dealt out again, one to each thread from thread 0 on
// (hash_strip), so that they fill whole warps: a padded read's strips of
// padding, two thirds of the main path's, cost no warp the arithmetic.
// block_codes holds each row's nw + k - 1 bases back to back, canon/valid
// the block's THREADS * SLOT shared entries; fwd/rev (may be null) point
// at the block's first window in the output, which is contiguous.
NT_HD bool scan_strip(const uint8_t* block_codes, int nrows, int nw, int k,
                      int tid, uint64_t* canon, uint8_t* valid,
                      uint64_t* fwd, uint64_t* rev) {
    int row, s0, n;
    if (!strip_of(tid, nrows, nw, row, s0, n)) return false;
    if (has_base(block_codes + row * (nw + k - 1) + s0, k, n)) return true;
    const int o = row * nw + s0;
    for (int i = 0; i < n; ++i) {
        canon[tid * SLOT + i] = 0;
        valid[tid * SLOT + i] = 0;
        if (fwd != nullptr) fwd[o + i] = 0;
        if (rev != nullptr) rev[o + i] = 0;
    }
    return false;
}

NT_HD void hash_strip(const uint8_t* block_codes, int nrows, int nw, int k,
                      int sid, const Tables& t, uint64_t* canon,
                      uint8_t* valid, uint64_t* fwd, uint64_t* rev) {
    int row, s0, n;
    strip_of(sid, nrows, nw, row, s0, n);
    const int o = row * nw + s0;
    strip(block_codes + row * (nw + k - 1) + s0, k, n, t, canon + sid * SLOT,
          valid + sid * SLOT, fwd != nullptr ? fwd + o : nullptr,
          rev != nullptr ? rev + o : nullptr);
}

// The shared entry of a block's output e (0 <= e < nrows * nw, in output
// order), as scan_strip or hash_strip wrote it.
NT_HD int out_slot(int e, int nw) {
    const int spr = (nw + STRIP - 1) / STRIP;
    const int row = e / nw, w = e - row * nw;
    return (row * spr + w / STRIP) * SLOT + w % STRIP;
}

}  // namespace nthash
