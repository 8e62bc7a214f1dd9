"""abyss-overlap + abyss-layout: all-pairs suffix-prefix overlap graph
and greedy layout.

Reimplements Map/overlap.cc (FM-index all-pairs overlaps -> ASQG/dot
overlap graph) and Layout/layout.cc:30-45 (greedy layout of the overlap
graph into merged sequences).  Instead of an FM-index, overlaps are
found with a seed dictionary on `min_overlap`-length prefixes plus
direct verification — a hash join, which is also how the device version
scales (sorted seed arrays + searchsorted).
"""

from __future__ import annotations

from ..core import alphabet
from .contig_graph import ContigGraph, flip, node


def build_overlap_graph_variable(contigs: list[tuple[str, str]],
                                 min_overlap: int = 20) -> ContigGraph:
    """Overlap graph with variable-length exact suffix-prefix overlaps
    (longest overlap per ordered pair; no containment edges)."""
    g = ContigGraph()
    for name, seq in contigs:
        g.add_contig(name, len(seq), 0)

    # seed index: first min_overlap bases of each oriented contig
    seeds: dict[str, list[int]] = {}
    oriented: list[str] = []
    for i, (name, seq) in enumerate(contigs):
        for s, text in ((0, seq), (1, alphabet.revcomp(seq))):
            oriented.append(text)
            if len(text) >= min_overlap:
                seeds.setdefault(text[:min_overlap], []).append(node(i, s))

    for i, (name, seq) in enumerate(contigs):
        for s in (0, 1):
            u = node(i, s)
            text = oriented[u]
            if len(text) < min_overlap:
                continue
            # try overlaps from longest to shortest
            best: dict[int, int] = {}
            for o in range(len(text) - 1, min_overlap - 1, -1):
                suf = text[-o:]
                for v in seeds.get(suf[:min_overlap], ()):
                    if v >> 1 == i:
                        continue
                    if v in best:
                        continue
                    if oriented[v][:o] == suf:
                        best[v] = o
            for v, o in best.items():
                if not g.has_edge(u, v):
                    g.add_edge(u, v, {"d": -o})
    return g


def layout(contigs: list[tuple[str, str]], min_overlap: int = 20,
           ) -> list[tuple[str, str]]:
    """Greedy layout (Layout/layout.cc): drop contained sequences, then
    repeatedly merge along the longest unambiguous overlaps; returns the
    laid-out sequences."""
    # containment removal
    keep = []
    seqs = [s for _, s in contigs]
    for i, (name, s) in enumerate(contigs):
        contained = False
        rc = alphabet.revcomp(s)
        for j, t in enumerate(seqs):
            if i != j and len(t) >= len(s) and (s in t or rc in t):
                if len(t) > len(s) or j < i:
                    contained = True
                    break
        if not contained:
            keep.append((name, s))
    g = build_overlap_graph_variable(keep, min_overlap)
    seq_of = {name: s for name, s in keep}

    from .algorithms import merge_linear_chains
    # restrict to unambiguous best overlaps: drop all edges from vertices
    # with out-degree > 1 / in-degree > 1 (greedy-unique layout)
    for u in list(g.vertices()):
        if g.out_degree(u) > 1:
            keep_v = max(g.out_edges(u), key=lambda e: -(e[1] or {}).get("d", 0))
            for v, _ in list(g.out_edges(u)):
                if v != keep_v[0]:
                    g.remove_edge(u, v)
    for u in list(g.vertices()):
        if g.in_degree(u) > 1:
            preds = [(w, g.out[w][u]) for w in g.predecessors(u)]
            keep_w = max(preds, key=lambda e: -(e[1] or {}).get("d", 0))
            for w, _ in preds:
                if w != keep_w[0]:
                    g.remove_edge(w, u)
    g2, out_seqs, chains = merge_linear_chains(g, seq_of)
    return [(n, out_seqs[n]) for n in
            (g2.names[c] for c in g2.contigs())]
