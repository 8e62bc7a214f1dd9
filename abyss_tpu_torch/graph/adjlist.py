"""AdjList: build the contig overlap graph from unitig sequences.

Reimplements AdjList/AdjList.cpp:44-60: an edge u -> v
exists iff the last (k-1) bases of oriented contig u equal the first
(k-1) bases of oriented contig v.  The reference hashes (k-1)-prefixes
and suffixes; here the join is a dictionary on exact (k-1)-mer keys
(device sort-merge join is a later optimization for >10^6 contigs;
overlaps shorter than k-1 via suffix array, AdjList.cpp SAIS path, are
not yet implemented).
"""

from __future__ import annotations

from ..core import alphabet
from .contig_graph import ContigGraph, flip, node


def _native_overlaps(contigs, o: int):
    """Edge quadruples via the C++ join (native/adjacency.cpp); None
    when no toolchain is available."""
    import ctypes

    import numpy as np

    from ..native import load_library
    lib = load_library("adjacency", ["adjacency.cpp"])
    if lib is None:
        return None
    lib.adjacency_overlaps.restype = ctypes.c_long
    lib.adjacency_overlaps.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long]
    offsets = np.zeros(len(contigs) + 1, np.int64)
    for i, (_, s) in enumerate(contigs):
        offsets[i + 1] = offsets[i] + len(s)
    codes = np.empty(int(offsets[-1]), np.uint8)
    for i, (_, s) in enumerate(contigs):
        codes[offsets[i]:offsets[i + 1]] = alphabet.encode(s)
    cap = max(4 * len(contigs), 1024)
    while True:
        edges = np.empty(cap * 4, np.int32)
        n = lib.adjacency_overlaps(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(contigs), o,
            edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n >= 0:
            return edges[:n * 4].reshape(-1, 4)
        cap *= 4


def build_overlap_graph(contigs: list[tuple[str, str]], k: int,
                        coverages: list[int] | None = None,
                        min_overlap: int | None = None) -> ContigGraph:
    """contigs: list of (name, sequence). Returns the ContigGraph with
    l/C vertex properties and implicit d = -(k-1) edges.

    min_overlap (< k-1, AdjList's -m): overlaps shorter than k-1 are
    also found — the reference uses a suffix array for these
    (AdjList/AdjList.cpp:44-60 + Common/SuffixArray.h); here it is a
    per-length hash join from k-2 down to min_overlap, keeping only the
    longest overlap per oriented pair."""
    g = ContigGraph()
    for i, (name, seq) in enumerate(contigs):
        cov = coverages[i] if coverages else 0
        g.add_contig(name, len(seq), cov)

    if min_overlap is None:
        # the standard (k-1)-overlap join runs natively when possible
        quads = _native_overlaps(contigs, k - 1)
        if quads is not None:
            o = k - 1
            for ui, us, vi, vs in quads:
                u = node(int(ui), int(us))
                v = node(int(vi), int(vs))
                if v not in g.out[u]:
                    g.add_edge(u, v, {"d": -o})
            return g

    lengths = [k - 1]
    if min_overlap is not None and min_overlap < k - 1:
        lengths += list(range(k - 2, min_overlap - 1, -1))
    for o in lengths:
        prefix_of: dict[bytes, list[int]] = {}
        for i, (name, seq) in enumerate(contigs):
            if len(seq) < o:
                continue
            fwd = seq[:o].encode()
            rev = alphabet.revcomp(seq[-o:]).encode()
            prefix_of.setdefault(fwd, []).append(node(i, 0))
            prefix_of.setdefault(rev, []).append(node(i, 1))
        for i, (name, seq) in enumerate(contigs):
            if len(seq) < o:
                continue
            for s, suffix in ((0, seq[-o:]),
                              (1, alphabet.revcomp(seq[:o]))):
                u = node(i, s)
                for v in prefix_of.get(suffix.encode(), ()):
                    if v not in g.out[u]:  # longest overlap wins
                        g.add_edge(u, v, {"d": -o})
    return g
