"""PathConsensus: resolve ambiguous (N-gap) path segments by sequence
consensus (MergePaths/PathConsensus.cpp:44-88, fillGap:703).

For every `u <gap>N v` in the input paths, search the contig graph for
paths u -> v whose length matches the gap (constrainedSearch), then:

  * 1 solution: splice it in;
  * 2 solutions: global NW alignment of the two interior sequences;
    identity >= p emits a NEW consensus contig (alignPair);
  * 3..a solutions: strip the common vertex prefix/suffix and run the
    center-star MSA over the interiors (alignMulti; align/dialign.py
    replaces vendored DIALIGN-TX);
  * 0 / >a / too-complex: the gap stays.

Emits the rewritten paths, the new consensus contigs (the reference's
-5.fa), and the contigs consumed by consensus regions.

Port of abyss_tpu/scaffold/path_consensus.py: the same code, with the
device of the multiple alignment's batched NW passed in.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..graph.contig_graph import ContigGraph
from .path_algebra import amb, amb_len, is_amb
from .paths import Constraint, constrained_search


@dataclass
class ConsensusStats:
    num_amb: int = 0
    merged: int = 0
    no_paths: int = 0
    too_many: int = 0
    too_complex: int = 0
    dissimilar: int = 0


@dataclass
class ConsensusResult:
    paths: list = field(default_factory=list)
    new_contigs: list = field(default_factory=list)  # (name, seq, cov)
    stats: ConsensusStats = field(default_factory=ConsensusStats)


def _materialize(g, seqs, p, k):
    from . import paths as pathtools
    return pathtools.materialize_path(p, g, seqs, k=k)


def _path_cov(g, p):
    return sum(g.coverages[e >> 1] for e in p if not is_amb(e))


def _fill_gap(g: ContigGraph, seqs, u: int, gap_kmers: int, v: int, k: int,
              identity: float, num_branches: int, dist_error: int,
              new_contigs: list, next_name: list, stats: ConsensusStats,
              device="cuda"):
    """Resolve one `u gap v` constraint; returns the replacement
    entry list for the gap (may still be [amb]) (fillGap)."""
    gap = [amb(gap_kmers)]
    # distance in bases from end of u to start of v (the stored gap is
    # d + k - 1 by the scaffold convention)
    dist = gap_kmers - (k - 1)
    sols = constrained_search(
        g, u, [Constraint(target=v, distance=dist,
                          error=dist_error, num_pairs=0)],
        max_paths=num_branches + 1)
    if not sols:
        stats.no_paths += 1
        return gap
    if len(sols) > num_branches:
        stats.too_many += 1
        return gap
    interiors = [s[1:-1] for s in sols if s[-1] == v]
    if len(interiors) != len(sols):
        # a solution ended elsewhere; treat as unresolved
        stats.no_paths += 1
        return gap
    if len(sols) == 1:
        stats.merged += 1
        return interiors[0]
    # multiple solutions: sequence consensus over the interiors
    texts = []
    for mid in interiors:
        if mid:
            texts.append(_materialize(g, seqs, mid, k))
        else:
            # prefix/suffix overlap by k-1 (alignMulti's empty-path arm)
            s = seqs[g.names[u >> 1]]
            texts.append(s[-(k - 1):] if len(s) >= k - 1 else s)
    lens = [len(t) for t in texts]
    if min(lens) == 0 or min(lens) / max(lens) < identity:
        stats.dissimilar += 1
        return gap
    if max(lens) > 20_000:
        stats.too_complex += 1  # quadratic NW guard (tool is bubble-scale)
        return gap
    from ..align.dialign import msa_consensus
    consensus, ident = msa_consensus(texts, device=device)
    if consensus is None or ident < identity:
        stats.dissimilar += 1
        return gap
    stats.merged += 1
    name = str(next_name[0])
    next_name[0] += 1
    cov = sum(_path_cov(g, mid) for mid in interiors)
    new_contigs.append((name, consensus, cov))
    cid = g.add_contig(name, len(consensus), cov)
    newv = 2 * cid
    # wire the consensus contig between u and v, inheriting the actual
    # flank overlaps of the first solution (outputNewContig's edges
    # carry the solutions' real distances, not a fixed k-1)
    first_mid = next((m for m in interiors if m), None)
    if first_mid is not None:
        d_left = (g.out[u].get(first_mid[0]) or {}).get("d", -(k - 1))
        d_right = (g.out[first_mid[-1]].get(v) or {}).get("d", -(k - 1))
    else:
        d_left = d_right = -(k - 1)
    g.add_edge(u, newv, {"d": d_left})
    g.add_edge(newv, v, {"d": d_right})
    seqs[name] = consensus
    return [newv]


def resolve_paths(g: ContigGraph, seqs: dict[str, str],
                  paths: list[list[int]], k: int,
                  identity: float = 0.9, num_branches: int = 4,
                  dist_error: int = 6,
                  start_name: int | None = None,
                  device="cuda") -> ConsensusResult:
    """Resolve every ambiguous gap across `paths`
    (PathConsensus.cpp main loop).  Mutates g/seqs by adding consensus
    contigs; returns rewritten paths + the new contigs.  A consensus of
    7 or more candidates scores its pairs on `device`."""
    res = ConsensusResult()
    if start_name is None:
        start_name = max((int(n) for n in g.names if n.isdigit()),
                         default=-1) + 1
    next_name = [start_name]
    cache: dict[tuple, list] = {}
    for p in paths:
        if not any(is_amb(e) for e in p):
            res.paths.append(list(p))
            continue
        out = [p[0]]
        for prev, e, nxt in zip(p, p[1:], p[2:] + [None]):
            if not is_amb(e):
                out.append(e)
                continue
            res.stats.num_amb += 1
            if nxt is None:
                out.append(e)  # trailing gap: nothing to anchor on
                continue
            key = (out[-1], amb_len(e), nxt)
            if key not in cache:
                cache[key] = _fill_gap(
                    g, seqs, out[-1], amb_len(e), nxt, k, identity,
                    num_branches, dist_error, res.new_contigs,
                    next_name, res.stats, device)
            out.extend(cache[key])
        res.paths.append(out)
    return res
