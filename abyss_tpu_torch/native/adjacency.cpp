// Native contig-overlap join: the AdjList hot path
// (reference: AdjList/AdjList.cpp:44-60 — hash of (k-1)-prefixes /
// suffixes).  Python orchestrates; this finds all suffix->prefix exact
// (k-1)-overlap edges over 2-bit-coded contigs at C++ speed.
//
// Exactness: candidates are bucketed by a 64-bit FNV-1a hash of the
// window and verified with memcmp, so hash collisions cannot create
// false edges.
//
// build: g++ -O3 -march=native -shared -fPIC -std=c++17

#include <cstdint>
#include <cstring>
#include <vector>
#include <unordered_map>

namespace {

inline uint64_t fnv1a(const uint8_t* p, int64_t n) {
    uint64_t h = 1469598103934665603ull;
    for (int64_t i = 0; i < n; i++) {
        h ^= p[i];
        h *= 1099511628211ull;
    }
    return h;
}

}  // namespace

extern "C" {

// codes: concatenated 2-bit (0-3, 4=N) contig codes
// offsets: int64[n+1] contig boundaries
// o: overlap length (k-1)
// edges_out: int32[cap*4] receiving (u_contig, u_sense, v_contig, v_sense)
// returns number of edges found, or -1 if cap exceeded
long adjacency_overlaps(const uint8_t* codes, const int64_t* offsets,
                        long n_contigs, int o, int32_t* edges_out,
                        long cap) {
    // reverse-complemented copy of every contig (for the rc windows)
    std::vector<uint8_t> rc;
    std::vector<int64_t> rc_off(n_contigs + 1, 0);
    rc.reserve(offsets[n_contigs]);
    for (long i = 0; i < n_contigs; i++) {
        for (int64_t p = offsets[i + 1] - 1; p >= offsets[i]; p--) {
            uint8_t c = codes[p];
            rc.push_back(c < 4 ? 3 - c : 4);
        }
        rc_off[i + 1] = (int64_t)rc.size();
    }

    struct Entry { int32_t contig; int32_t sense; const uint8_t* ptr; };
    std::unordered_map<uint64_t, std::vector<Entry>> prefix_of;
    prefix_of.reserve(n_contigs * 2);

    auto window_ok = [&](const uint8_t* p) {
        for (int i = 0; i < o; i++)
            if (p[i] >= 4) return false;
        return true;
    };

    // index prefixes: fwd prefix of contig i; prefix of rc(i) (= rc of
    // its suffix) for sense 1
    for (long i = 0; i < n_contigs; i++) {
        int64_t len = offsets[i + 1] - offsets[i];
        if (len < o) continue;
        const uint8_t* fwd = codes + offsets[i];
        const uint8_t* rev = rc.data() + rc_off[i];
        if (window_ok(fwd))
            prefix_of[fnv1a(fwd, o)].push_back(
                Entry{(int32_t)i, 0, fwd});
        if (window_ok(rev))
            prefix_of[fnv1a(rev, o)].push_back(
                Entry{(int32_t)i, 1, rev});
    }

    long n_edges = 0;
    // probe suffixes: suffix of oriented u matches prefix of oriented v
    for (long i = 0; i < n_contigs; i++) {
        int64_t len = offsets[i + 1] - offsets[i];
        if (len < o) continue;
        const uint8_t* sfx[2] = {
            codes + offsets[i + 1] - o,        // sense 0: fwd suffix
            rc.data() + rc_off[i + 1] - o };   // sense 1: rc suffix
        for (int s = 0; s < 2; s++) {
            if (!window_ok(sfx[s])) continue;
            auto it = prefix_of.find(fnv1a(sfx[s], o));
            if (it == prefix_of.end()) continue;
            for (const Entry& e : it->second) {
                if (memcmp(sfx[s], e.ptr, o) != 0) continue;  // verify
                if (n_edges >= cap) return -1;
                edges_out[n_edges * 4 + 0] = (int32_t)i;
                edges_out[n_edges * 4 + 1] = s;
                edges_out[n_edges * 4 + 2] = e.contig;
                edges_out[n_edges * 4 + 3] = e.sense;
                n_edges++;
            }
        }
    }
    return n_edges;
}

}  // extern "C"
