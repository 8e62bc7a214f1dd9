// Per-window arithmetic of the canonical ntHash kernel (nthash.cu).
//
// Every function here is `__host__ __device__` and plain C++ otherwise,
// so g++ compiles this header too: the CPU test suite loops
// `tile_thread` over the same grid the kernel launches and holds the
// result bit-identical to the port's plain PyTorch version
// (ops/nthash.kmer_hashes_plain).
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

// Launch geometry, shared with the host harness: a block of THREADS
// threads covers TILE consecutive windows of one row, each thread a
// strip of STRIP windows.
constexpr int THREADS = 64;
constexpr int STRIP = 8;
constexpr int TILE = THREADS * STRIP;

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

NT_HD uint64_t srol1(uint64_t v) {
    uint64_t lo = v & M33, hi = v >> 33;
    lo = ((lo << 1) | (lo >> 32)) & M33;
    hi = ((hi << 1) | (hi >> 30)) & M31;
    return (hi << 33) | lo;
}

NT_HD uint64_t sror1(uint64_t v) {
    uint64_t lo = v & M33, hi = v >> 33;
    lo = (lo >> 1) | ((lo & 1) << 32);
    hi = (hi >> 1) | ((hi & 1) << 30);
    return (hi << 33) | lo;
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

// Hash nwin >= 1 consecutive windows whose first base is codes[0]
// (codes[0 .. nwin+k-2] readable).  fwd/rev may be null.
NT_HD void strip(const uint8_t* codes, int k, int nwin, const Tables& t,
                 uint64_t* canon, uint8_t* valid, uint64_t* fwd,
                 uint64_t* rev) {
    uint64_t f = 0, r = 0;
    int nbad = 0;
    for (int j = 0; j < k; ++j) {
        const int c = clamp_code(codes[j]);
        f = srol1(f) ^ t.f[c];
        nbad += c == 4;
    }
    for (int j = k - 1; j >= 0; --j) r = srol1(r) ^ t.r[clamp_code(codes[j])];
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

// Thread `tid`'s share of a tile: tile_codes holds the tile's nw + k - 1
// bases, canon/valid the tile's nw outputs; fwd/rev (may be null) point
// at the tile's first window in the row's output.
NT_HD void tile_thread(const uint8_t* tile_codes, int nw, int k, int tid,
                       const Tables& t, uint64_t* canon, uint8_t* valid,
                       uint64_t* fwd, uint64_t* rev) {
    const int s0 = tid * STRIP;
    if (s0 >= nw) return;
    const int n = nw - s0 < STRIP ? nw - s0 : STRIP;
    strip(tile_codes + s0, k, n, t, canon + s0, valid + s0,
          fwd != nullptr ? fwd + s0 : nullptr,
          rev != nullptr ? rev + s0 : nullptr);
}

}  // namespace nthash
