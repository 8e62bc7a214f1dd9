"""Distance-constrained path search, path merging, and scaffolding.

Covers the roles of three reference tools:
  * SimpleGraph (SimpleGraph/SimpleGraph.cpp, Graph/ConstrainedSearch.h):
    find the unique contig path consistent with a contig's distance
    estimates;
  * MergePaths (MergePaths/MergePaths.cpp): merge consistent per-seed
    paths;
  * abyss-scaffold (Scaffold/scaffold.cc): build scaffold paths from the
    mate-pair distance graph, cutting ambiguities and emitting N-gaps.

Conventions: a distance d between oriented contigs u -> v means v starts
d bases after u ends (negative = overlap), matching the reference's
Distance edge property.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..graph.contig_graph import ContigGraph, flip, node


@dataclass
class Constraint:
    target: int     # vertex
    distance: int   # expected start of target relative to end of seed
    error: int      # allowed absolute deviation
    num_pairs: int = 0


def constrained_search(g: ContigGraph, start: int,
                       constraints: list[Constraint],
                       max_paths: int = 200, max_depth: int = 30,
                       max_cost: int = 100_000) -> list[list[int]]:
    """All paths from `start` that place every constraint target within
    its distance window (ConstrainedSearch.h:57-141).  A path may end as
    soon as all constraints are satisfied.  Returns up to max_paths
    satisfying paths (vertex lists beginning at start).

    `max_cost` bounds total vertex expansions (opt::maxCost,
    ConstrainedSearch.h:17,92): a tangle whose window-bounded search
    space explodes combinatorially is treated as unresolvable ([])
    rather than explored exhaustively."""
    if not constraints:
        return []
    want = {c.target: c for c in constraints}
    max_reach = max(c.distance + c.error for c in constraints)
    solutions: list[list[int]] = []
    overflow = [False]
    cost = [0]

    def dfs(path: list[int], pos: int, satisfied: dict[int, bool],
            depth: int):
        """pos = start coordinate of path[-1] relative to end of start."""
        if overflow[0]:
            return
        cost[0] += 1
        if len(solutions) >= max_paths or cost[0] >= max_cost:
            overflow[0] = True
            return
        if all(satisfied.values()):
            solutions.append(list(path))
            return
        if depth >= max_depth:
            return
        u = path[-1]
        for v, prop in sorted(g.out_edges(u)):
            d = (prop or {}).get("d", 0)
            # position of v's start relative to the end of the seed:
            # the seed's end is coordinate 0
            if len(path) == 1:
                v_start = d
            else:
                v_start = pos + g.length(u) + d
            if v_start > max_reach:
                continue
            sat2 = satisfied
            if v in want and not satisfied[v]:
                c = want[v]
                if abs(v_start - c.distance) <= c.error:
                    sat2 = dict(satisfied)
                    sat2[v] = True
            path.append(v)
            dfs(path, v_start, sat2, depth + 1)
            path.pop()

    dfs([start], 0, {c.target: False for c in constraints}, 0)
    if overflow[0]:
        return []
    return solutions


def allowed_error(sd: float, distance_error: int = 6,
                  n_sd: float = 3.0) -> int:
    """Distance window half-width: ceil(NUM_SIGMA * sd +
    distanceError) — exactly Common/Estimate.h:154-159 (the additive
    +6 applies always, not as a floor; the old max(6, 3*sd) form lost
    boundary paths, e.g. a -24 overlap edge against a +2 estimate at
    sd 6.8)."""
    import math
    return int(math.ceil(n_sd * sd + distance_error))


def _path_span(g: ContigGraph, path: list[int], i0: int, i1: int) -> int:
    """Distance in bases from the END of path[i0] to the START of
    path[i1] walking the graph edges (SimpleGraph.cpp
    calculatePathLength for the ambiguous middle)."""
    span = 0
    for j in range(i0, i1):
        prop = g.out[path[j]].get(path[j + 1]) or {}
        span += prop.get("d", 0)
        if j + 1 < i1:
            span += g.length(path[j + 1])
    return span


def construct_ambiguous_path(g: ContigGraph, sols: list[list[int]],
                             k: int = 0) -> list[int]:
    """Common prefix + `nN` + common suffix of several solutions
    (SimpleGraph.cpp constructAmbiguousPath:326).  numN = span of the
    longest candidate's middle + k - 1 ("the convention")."""
    from .path_algebra import amb

    first = sols[0]
    min_len = min(len(s) for s in sols)
    pre = 0
    while pre < min_len and all(s[pre] == first[pre] for s in sols):
        pre += 1
    suf = 0
    while suf < min_len - pre and all(
            s[len(s) - 1 - suf] == first[len(first) - 1 - suf]
            for s in sols):
        suf += 1
    out = first[:pre]
    if suf > 0 and pre > 0:
        longest = max(sols, key=lambda s: _path_span(g, s, pre - 1,
                                                     len(s) - suf))
        dist = _path_span(g, longest, pre - 1, len(longest) - suf)
        num_n = max(1, dist + k - 1)
        out.append(amb(num_n))
        out.extend(first[len(first) - suf:])
    return out


def simple_graph_seed_paths(g: ContigGraph, estimates: dict,
                            names_index: dict, k: int = 0,
                            max_paths: int = 200,
                            ) -> dict[int, list[int]]:
    """For each oriented contig with distance estimates, search for the
    consistent path (SimpleGraph.cpp main loop).  `estimates` maps
    (u_name, su, v_name, sv) -> DistanceEstimate.  Returns
    {oriented seed vertex: path starting at the seed} — a unique
    solution verbatim, or the ambiguous prefix + nN + suffix form that
    PathConsensus later resolves (SimpleGraph.cpp:620-633)."""
    by_seed: dict[int, list[Constraint]] = {}
    for (un, su, vn, sv), e in estimates.items():
        if un not in names_index or vn not in names_index:
            continue
        u = node(names_index[un], su)
        v = node(names_index[vn], sv)
        by_seed.setdefault(u, []).append(Constraint(
            target=v, distance=e.distance, error=allowed_error(e.std_dev),
            num_pairs=e.num_pairs))
    paths: dict[int, list[int]] = {}
    for u, cons in sorted(by_seed.items()):
        sols = constrained_search(g, u, cons, max_paths=max_paths)
        # a seed appearing twice in its own solution is a repeat: skip
        # (SimpleGraph.cpp findRepeats/"Repeat:" arm)
        if any(sum(1 for v in s if (v >> 1) == (u >> 1)) > 1
               for s in sols):
            continue
        if len(sols) == 1:
            paths[u] = sols[0]
        elif len(sols) > 1:
            p = construct_ambiguous_path(g, sols, k=k)
            if len(p) >= 2:
                paths[u] = p
    return paths


def simple_graph_paths(g: ContigGraph, estimates: dict, names_index: dict,
                       max_paths: int = 200, seqs: dict | None = None,
                       consensus_identity: float = 0.9,
                       max_candidates: int = 4, k: int = 0,
                       ) -> list[list[int]]:
    """Path list view of simple_graph_seed_paths (compat wrapper for
    callers that do not track seeds); ambiguous entries are dropped by
    truncating at the first gap."""
    from .path_algebra import is_amb

    out = []
    for u, p in sorted(simple_graph_seed_paths(
            g, estimates, names_index, k=k, max_paths=max_paths).items()):
        if any(is_amb(e) for e in p):
            p = p[:next(i for i, e in enumerate(p) if is_amb(e))]
        if len(p) >= 2:
            out.append(p)
    return out


def _is_subpath(small: list[int], big: list[int]) -> bool:
    n, m = len(small), len(big)
    if n > m:
        return False
    for i in range(m - n + 1):
        if big[i:i + n] == small:
            return True
    return False


def merge_consistent_paths(paths: list[list[int]]) -> list[list[int]]:
    """Greedy merge of per-seed paths (MergePaths.cpp greedy mode):
    overlapping paths that agree on their overlap are chained; paths
    contained in others are dropped; conflicting overlaps leave paths
    separate."""
    def canon(p: list[int]) -> list[int]:
        q = [flip(v) for v in reversed(p)]
        return p if p <= q else q

    work = [canon(p) for p in paths if len(p) >= 2]
    # drop duplicates and contained paths
    work = sorted(set(map(tuple, work)), key=len, reverse=True)
    kept: list[list[int]] = []
    for p in work:
        p = list(p)
        pf = [flip(v) for v in reversed(p)]
        if any(_is_subpath(p, q) or _is_subpath(pf, q) for q in kept):
            continue
        kept.append(p)

    # chain paths whose suffix matches another's prefix
    merged = True
    while merged:
        merged = False
        for i in range(len(kept)):
            for j in range(len(kept)):
                if i == j:
                    continue
                a = kept[i]
                # try both orientations of the second path: a merge may
                # need it reverse-complemented (every x+y orientation
                # case reduces to (i,j)-with-flipped-b by loop symmetry)
                best = 0
                for b in (kept[j],
                          [flip(v) for v in reversed(kept[j])]):
                    for o in range(min(len(a), len(b)) - 1, 0, -1):
                        if a[-o:] == b[:o]:
                            best = o
                            break
                    if best:
                        kept[i] = a + b[best:]
                        del kept[j]
                        merged = True
                        break
                if merged:
                    break
            if merged:
                break
    return kept


def scaffold_paths(dist_graph: ContigGraph, min_pairs: int = 10,
                   min_len: int = 200) -> list[list[int]]:
    """Scaffold over a mate-pair distance graph (scaffold.cc:220-795):
    drop weak edges (n < min_pairs) and short contigs (< min_len), cut
    ambiguous vertices, and read off the remaining linear chains."""
    g = dist_graph.copy()
    for u in list(g.vertices()):
        for v, prop in g.out_edges(u):
            n = (prop or {}).get("n", 0)
            if n < min_pairs:
                g.remove_edge(u, v)
    for cid in list(g.contigs()):
        if g.lengths[cid] < min_len:
            g.remove_contig(cid)
    # pop scaffold-graph bubbles (scaffold.cc pops bubbles before
    # assembly): parallel 1-contig branches between the same junctions
    # collapse to the better-supported one
    from ..graph.algorithms import assemble_chains, pop_bubbles
    pop_bubbles(g)
    # dominant-edge resolution (scaffold.cc's weak-edge removal): at a
    # branch, keep the strongest edge when it has >= 2x the support of
    # the runner-up; otherwise cut all (ambiguous)
    for u in list(g.vertices()):
        edges = g.out_edges(u)
        if len(edges) > 1:
            ns = sorted((((p or {}).get("n", 0)), v) for v, p in edges)
            best_n, best_v = ns[-1]
            second_n = ns[-2][0]
            for v, _ in edges:
                if v != best_v or best_n < 2 * second_n:
                    g.remove_edge(u, v)
    for u in list(g.vertices()):
        if g.in_degree(u) > 1:
            preds = list(g.predecessors(u))
            ns = sorted(((g.out[w].get(u) or {}).get("n", 0), w)
                        for w in preds)
            best_n, best_w = ns[-1]
            second_n = ns[-2][0]
            for w in preds:
                if w != best_w or best_n < 2 * second_n:
                    g.remove_edge(w, u)
    return assemble_chains(g)


def materialize_path(path: list[int], g: ContigGraph, seqs: dict[str, str],
                     default_overlap: int = 0, min_gap: int = 1,
                     k: int = 0) -> str:
    """Path -> sequence with 'N' gaps for positive distances
    (MergeContigs.cpp for scaffold paths).

    Ambiguous path entries (path_algebra.amb, the reference's `nN`
    nodes) become N runs of `n - (k-1)` bases (the stored length is
    d + k - 1 by the scaffold convention, scaffold.cc addDistEst).

    A negative distance splices the overlap ONLY when the two ends
    actually match (the Overlap tool's verification role,
    Overlap/Overlap.cpp); a distance *estimate* that merely came out
    negative (e.g. across a repeat) falls back to an N gap instead of
    fabricating sequence."""
    from ..core import alphabet
    from .path_algebra import amb_len, is_amb

    def oriented(v):
        s = seqs[g.names[v >> 1]]
        return s if (v & 1) == 0 else alphabet.revcomp(s)

    # strip leading/trailing gaps; fold interior gap entries into
    # explicit inter-contig distances
    p = [e for i, e in enumerate(path)
         if not (is_amb(e) and (i == 0 or i == len(path) - 1))]
    if not p:
        return ""
    gap_before: dict[int, int] = {}   # index in concrete list -> gap bp
    concrete: list[int] = []
    for e in p:
        if is_amb(e):
            bp = max(min_gap, amb_len(e) - max(k - 1, 0))
            gap_before[len(concrete)] = \
                gap_before.get(len(concrete), 0) + bp
        else:
            concrete.append(e)
    if not concrete:
        return ""
    path = concrete

    out = [oriented(path[0])]
    for i, (a, b) in enumerate(zip(path, path[1:])):
        if i + 1 in gap_before:
            out.append("N" * gap_before[i + 1] + oriented(b))
            continue
        prop = g.out[a].get(b) or {}
        d = prop.get("d", default_overlap)
        s = oriented(b)
        if d < 0 and -d <= len(s):
            o = -d
            tail = out[-1][-o:] if len(out[-1]) >= o else \
                "".join(out)[-o:]
            if len(tail) == o and tail == s[:o]:
                out.append(s[o:])
                continue
            # unverified overlap: treat as an estimated near-adjacency
            out.append("N" * min_gap + s)
        elif d < 0:
            out.append("N" * min_gap + s)
        else:
            out.append("N" * max(int(d), min_gap) + s)
    return "".join(out)


def write_paths(paths: list[list[int]], g: ContigGraph, out, start_id):
    """ContigPath file: `<new-name>\\t<v1> <v2> ...`; ambiguous entries
    render as `<n>N` (Common/ContigPath.h operator<<).  start_id may be
    an int (sequential names) or a list of names."""
    import os
    from .path_algebra import amb_len, is_amb
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        for i, p in enumerate(paths):
            name = (start_id[i] if isinstance(start_id, list)
                    else start_id + i)
            f.write(f"{name}\t" + " ".join(
                f"{amb_len(v)}N" if is_amb(v) else g.name(v)
                for v in p) + "\n")
    finally:
        if own:
            f.close()


def read_paths(path, g: ContigGraph) -> tuple[list[str], list[list[int]]]:
    """Read a ContigPath file; returns (names, paths) with ambiguous
    `<n>N` entries decoded to path_algebra.amb."""
    from ..graph.contig_graph import parse_vertex_name
    from .path_algebra import amb
    names, paths = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                p = [amb(int(tok[:-1])) if tok.endswith("N")
                     and tok[:-1].isdigit()
                     else parse_vertex_name(tok, g._index)
                     for tok in parts[1:]]
            except (KeyError, ValueError):
                continue
            names.append(parts[0])
            paths.append(p)
    return names, paths
