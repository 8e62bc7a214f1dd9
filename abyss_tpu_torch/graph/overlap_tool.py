"""Overlap: connect blunt contigs whose distance estimates imply
overlap, creating gap contigs for scaffolded (non-overlapping) pairs.

Faithful reformulation of Overlap/Overlap.cpp:
  * candidates come from the distance estimates; a pair (t, h) is
    considered only when BOTH ends are blunt in the adjacency graph
    (out_degree(t) == 0 and in_degree(h) == 0, :341) and the pair is
    new;
  * the actual overlap is the LARGEST exact suffix/prefix match
    (findOverlap, :150-198), attempted only when
    distance - ceil(3*sd + 6) <= 0; matches shorter than
    minimum_overlap (5) are insignificant; an arithmetic progression
    of the top three overlap lengths marks a homopolymer/motif repeat
    and masks the candidate (skipped by default, --no-merge-repeat);
  * ambiguity resolution in two passes over canonical candidate edges
    (:506-580): overlapping pairs are spliced as graph edges
    (d = -overlap) only when t has exactly ONE overlap candidate;
    committed pairs clear their endpoints' remaining candidates;
    then scaffolded pairs (no overlap, --scaffold default on) become
    NEW GAP CONTIGS `(k-1 tail) + N*distance + (k-1 head)` wired
    t -> gap -> h (createGapContig, :239-261).
"""

from __future__ import annotations

import math

from ..core import alphabet
from .contig_graph import ContigGraph, flip, node


def _oriented_seq(g: ContigGraph, seqs: dict[str, str], v: int) -> str:
    s = seqs[g.names[v >> 1]]
    return s if (v & 1) == 0 else alphabet.revcomp(s)


def find_overlap(sa: str, sb: str) -> tuple[int, bool]:
    """(largest exact suffix(sa)/prefix(sb) overlap, masked): scans
    every length like the reference (Overlap.cpp:150-198); masked is
    the homopolymer/motif rule on the top three lengths."""
    n = min(len(sa), len(sb))
    overlaps = []
    for o in range(n, 0, -1):
        if sa[-o:] == sb[:o]:
            overlaps.append(o)
            if len(overlaps) >= 3:
                break
    if not overlaps:
        return 0, False
    mask = (len(overlaps) >= 3
            and overlaps[0] - overlaps[1] == overlaps[1] - overlaps[2])
    return overlaps[0], mask


def overlap_stage(g: ContigGraph, seqs: dict[str, str], estimates: dict,
                  k: int, min_overlap: int = 5, scaffold: bool = True,
                  mask_repeat: bool = False,
                  ) -> tuple[int, list[tuple[str, str, int, int, int]]]:
    """The full Overlap tool pass.  estimates:
    {(u_name, su, v_name, sv): DistanceEstimate}.

    Returns (edges_added, gap_contigs) where each gap contig is
    (name, sequence, t, h, distance); the caller appends them to the
    -4.fa artifact and the graph already contains t->gap->h."""
    # ---- candidate collection (findOverlap driver, :329-352) ----
    cand: dict[tuple[int, int], tuple] = {}
    for (un, su, vn, sv), e in estimates.items():
        if un not in g._index or vn not in g._index or un == vn:
            continue
        if e.distance >= 0 and not scaffold:
            continue
        t = node(g.id_of(un), su)
        h = node(g.id_of(vn), sv)
        if g.out_degree(t) > 0 or g.in_degree(h) > 0:
            continue        # not blunt
        if (t, h) in cand:
            continue
        err = math.ceil(3.0 * e.std_dev + 6)
        if e.distance - err <= 0:
            o, masked = find_overlap(_oriented_seq(g, seqs, t),
                                     _oriented_seq(g, seqs, h))
        else:
            o, masked = 0, False
        # findOverlap returns 0 with mask=false when the best overlap is
        # below minimum_overlap (Overlap.cpp:181-184 — the too-short
        # path precedes the homopolymer/motif check), so such a pair
        # stays a scaffold candidate rather than being mask-dropped.
        if o and o < min_overlap:
            o, masked = 0, False    # insignificant
        if masked and not mask_repeat:
            continue
        if o > 0 or scaffold:
            cand[(t, h)] = (e, o)
            cand[(flip(h), flip(t))] = (e, o)

    # canonical edges in source-vertex order (:503-513)
    canonical = sorted((t, h) for (t, h) in cand if t < h)
    overlap_out: dict[int, list[int]] = {}
    for (t, h), (e, o) in cand.items():
        if o > 0:
            overlap_out.setdefault(t, []).append(h)

    added = 0
    committed = set(cand)
    # pass 1: overlapping pairs, unambiguous only (:526-544)
    for t, h in canonical:
        e, o = cand[(t, h)]
        if o == 0:
            continue
        # contiguous_out (ContigGraphAlgorithms.h) requires BOTH
        # out_degree(t)==1 and in_degree(h)==1 in the candidate graph
        # (Overlap.cpp:532); cand stores both orientations, so h's
        # in-candidates are flip(h)'s out-candidates.
        if (len(overlap_out.get(t, ())) != 1
                or len(overlap_out.get(flip(h), ())) != 1):
            continue        # ambiguous
        g.add_edge(t, h, {"d": -o})   # complement edge added implicitly
        added += 1
        # clear t's out and h's in candidates from the scaffold set
        for key in [kk for kk in committed
                    if kk[0] == t or kk[1] == h
                    or kk[0] == flip(h) or kk[1] == flip(t)]:
            committed.discard(key)

    # pass 2: scaffolded pairs -> gap contigs (:546-580)
    gap_contigs: list[tuple[str, str, int, int, int]] = []
    if scaffold:
        scaffold_out: dict[int, list[int]] = {}
        for (t, h) in committed:
            scaffold_out.setdefault(t, []).append(h)
        # createContigName continues after the largest numeric name
        numeric = [int(n) for n in g.names if n.isdigit()]
        next_id = (max(numeric) + 1) if numeric else len(g.names)
        for t, h in canonical:
            if (t, h) not in committed:
                continue
            e, o = cand[(t, h)]
            if o > 0:
                continue    # was an (ambiguous) overlap, not a scaffold
            # both sides must be unambiguous (Overlap.cpp:561)
            if (len(scaffold_out.get(t, ())) != 1
                    or len(scaffold_out.get(flip(h), ())) != 1):
                continue    # ambiguous
            distance = int(e.distance)
            gap = "n" if distance <= 0 else "N" * distance
            useq = _oriented_seq(g, seqs, t)
            vseq = _oriented_seq(g, seqs, h)
            seq = useq[-(k - 1):] + gap + vseq[: k - 1]
            name = str(next_id)
            next_id += 1
            cid = g.add_contig(name, len(seq), 0)
            seqs[name] = seq
            v = node(cid, 0)
            g.add_edge(t, v, {"d": -(k - 1)})
            g.add_edge(v, h, {"d": -(k - 1)})
            gap_contigs.append((name, seq, t, h, distance))
    return added, gap_contigs


def add_overlap_edges(g: ContigGraph, seqs: dict[str, str],
                      estimates: dict, **kw) -> int:
    """Back-compat wrapper: edges only (no gap contigs)."""
    added, _ = overlap_stage(g, seqs, estimates, k=kw.get("k", 25),
                             scaffold=False)
    return added
