"""PathOverlap: find/assemble/trim overlapping contig paths
(PathOverlap/PathOverlap.cpp).

Two paths overlap when a suffix of one equals a prefix of another at
the vertex level (findOverlaps: seed map on path endpoints, then
element-wise suffix/prefix check).  Modes:

  * assemble (--assemble, abyss-pe stage -4.path3): chain paths along
    unambiguous overlap edges, splicing out the duplicated vertices;
  * overlap (--overlap, stages -6.dot/-8.dot): emit the next-stage
    contig graph in which each path becomes one vertex (inheriting the
    terminal adjacency of its endpoints) and its constituent contigs
    are removed;
  * trim (--trim): iteratively cut the overlapped ends.

Host-side by design (paths are small; this is pure bookkeeping).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..graph.contig_graph import ContigGraph, flip, node
from .path_algebra import is_amb, amb_len, path_rc


@dataclass(frozen=True)
class Overlap:
    """source path-end overlaps target path-start by `count` vertices
    spanning `length` k-mers (PathOverlap.cpp Overlap)."""
    source: tuple[int, int]   # (path index, sense)
    target: tuple[int, int]
    count: int
    length: int


def _oriented(paths, v: tuple[int, int]) -> list[int]:
    i, sense = v
    return path_rc(paths[i]) if sense else list(paths[i])


def find_overlaps(paths: list[list[int]], lengths=None) -> list[Overlap]:
    """Every suffix/prefix vertex overlap between two paths
    (PathOverlap.cpp findOverlaps/makeSeedMap)."""
    seed_map: dict[int, list[tuple[int, int]]] = {}
    for i, p in enumerate(paths):
        if not p:
            continue
        seed_map.setdefault(p[0], []).append((i, 0))
        seed_map.setdefault(flip(p[-1]), []).append((i, 1))
    overlaps = []
    for i, _ in enumerate(paths):
        for sense in (0, 1):
            me = (i, sense)
            p = _oriented(paths, me)
            for start, u in enumerate(p):
                if is_amb(u):
                    continue
                for cand in seed_map.get(u, ()):
                    if cand == me:
                        continue
                    suffix = p[start:]
                    q = _oriented(paths, cand)
                    if len(suffix) <= len(q) and q[:len(suffix)] == suffix:
                        span = (sum(amb_len(e) if is_amb(e)
                                    else (lengths[e >> 1] if lengths
                                          else 1) for e in suffix))
                        overlaps.append(Overlap(me, cand, len(suffix),
                                                span))
    return overlaps


def assemble_overlapping_paths(paths: list[list[int]],
                               ss: bool = False) -> list[list[int]]:
    """Merge paths along unambiguous overlap edges
    (PathOverlap.cpp assembleOverlappingPaths + assemble_if; ss=True
    applies the IsPositive strand-specific predicate, :517-521).
    Returns the new path list (merged + untouched)."""
    overlaps = find_overlaps(paths)
    # overlap relation as a skew-symmetric graph over path indices
    g = ContigGraph()
    for i, p in enumerate(paths):
        g.add_contig(str(i))
    omap = {}
    for o in overlaps:
        u = node(o.source[0], o.source[1])
        v = node(o.target[0], o.target[1])
        if g.has_edge(u, v):
            # parallel overlap between the same pair: ambiguous amount;
            # drop the edge (reference rejects parallel edges outside
            # assemble mode and assembles only unambiguous chains)
            continue
        g.add_edge(u, v)
        omap[(u, v)] = o.count
        omap[(flip(v), flip(u))] = o.count
    from ..graph.algorithms import assemble_chains, assemble_stranded
    chains = [c for c in (assemble_stranded(g) if ss
                          else assemble_chains(g)) if len(c) >= 2]
    used = set()
    out = []
    for chain in chains:
        merged = _oriented(paths, (chain[0] >> 1, chain[0] & 1))
        ok = True
        for a, b in zip(chain, chain[1:]):
            cnt = omap.get((a, b))
            if cnt is None:
                ok = False
                break
            nxt = _oriented(paths, (b >> 1, b & 1))
            merged = merged + nxt[cnt:]
        if not ok:
            continue
        used.update(v >> 1 for v in chain)
        out.append(merged)
    for i, p in enumerate(paths):
        if i not in used and p:
            out.append(list(p))
    return out


def trim_overlaps(paths: list[list[int]]) -> list[list[int]]:
    """Iteratively remove the largest overlapped portion from each
    path end (PathOverlap.cpp trimOverlaps)."""
    paths = [list(p) for p in paths]
    while True:
        overlaps = find_overlaps(paths)
        if not overlaps:
            return [p for p in paths if p]
        cut_front = [0] * len(paths)
        cut_back = [0] * len(paths)
        for o in overlaps:
            si, ss = o.source
            ti, ts = o.target
            if ss:  # overlap is at the front of the stored source path
                cut_front[si] = max(cut_front[si], o.count)
            else:
                cut_back[si] = max(cut_back[si], o.count)
            if ts:
                cut_back[ti] = max(cut_back[ti], o.count)
            else:
                cut_front[ti] = max(cut_front[ti], o.count)
        for i, p in enumerate(paths):
            first, last = cut_front[i], len(p) - cut_back[i]
            p2 = p[first:last] if first < last else []
            while p2 and is_amb(p2[0]):
                p2.pop(0)
            while p2 and is_amb(p2[-1]):
                p2.pop()
            paths[i] = p2


def path_graph(g: ContigGraph, paths: list[list[int]],
               path_names: list[str],
               seqs: dict[str, str] | None = None,
               k: int = 0) -> ContigGraph:
    """The next-stage contig graph: one vertex per path (inheriting the
    terminal adjacency of its end vertices), constituent contigs
    removed, plus overlap edges between paths
    (PathOverlap.cpp addPathOverlapEdges via merge()).

    When `seqs` is given the path vertices get real lengths from the
    materialized sequences (ContigProperties via addProp)."""
    from . import paths as pathtools

    out = g.copy()
    in_paths: set[int] = set()
    pvert = []
    for name, p in zip(path_names, paths):
        length = sum(out.lengths[e >> 1] for e in p if not is_amb(e))
        if seqs is not None:
            length = len(pathtools.materialize_path(
                [e for e in p], out, seqs, k=k))
        cov = sum(out.coverages[e >> 1] for e in p if not is_amb(e))
        cid = out.add_contig(name, length, cov)
        u = node(cid, 0)
        pvert.append(u)
        # inherit terminal adjacency (ContigGraphAlgorithms merge())
        first = next((e for e in p if not is_amb(e)), None)
        last = next((e for e in reversed(p) if not is_amb(e)), None)
        if first is None:
            continue
        for w, prop in out.in_edges(first):
            out.add_edge(w, u, prop)
        for w, prop in out.out_edges(last):
            out.add_edge(u, w, prop)
        in_paths.update(e >> 1 for e in p if not is_amb(e))
    # overlap edges between paths
    overlaps = find_overlaps(paths, out.lengths)
    for o in overlaps:
        u = pvert[o.source[0]] ^ o.source[1]
        v = pvert[o.target[0]] ^ o.target[1]
        if not out.has_edge(u, v):
            out.add_edge(u, v, {"d": -o.length})
    for cid in in_paths:
        out.remove_contig(cid)
    return out
