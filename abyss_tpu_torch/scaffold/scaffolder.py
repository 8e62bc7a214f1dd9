"""abyss-scaffold: clean the distance-estimate graph and assemble
scaffold paths, searching (n, s) to maximize N50
(Scaffold/scaffold.cc:220-795 cleaning, :864 scaffold(), :1138-1166
search strategies).

Cleaning passes, in reference order (scaffold() at scaffold.cc:669):
filter (short contigs / weak edges) -> remove 2-cycles -> resolve forks
-> prune tips -> remove repeats -> remove transitive edges -> prune
tips -> pop bubbles -> remove weak edges -> assemble linear chains.
Output paths carry ambiguous N entries sized `d + k - 1`
(addDistEst:549, "by convention").

The search over n (min pairs) and s (min contig length) is the
reference's grid/line search with three-steps-per-decade s values and
memoization (optimize_grid_search/optimize_line_search).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

from ..graph.contig_graph import ContigGraph, flip
from .path_algebra import amb


def _filter_graph(g: ContigGraph, min_pairs: int, min_len: int):
    """Remove short contigs and weak edges (scaffold.cc filterGraph)."""
    for cid in list(g.contigs()):
        if g.lengths[cid] < min_len:
            g.remove_contig(cid)
    for u in list(g.vertices()):
        for v, prop in g.out_edges(u):
            if ((prop or {}).get("n", 0)) < min_pairs:
                g.remove_edge(u, v)


def _remove_cycles(g: ContigGraph):
    """Remove simple 2-cycles (scaffold.cc removeCycles)."""
    for u in list(g.vertices()):
        for v in g.successors(u):
            if g.has_edge(v, u):
                g.remove_edge(u, v)
                g.remove_edge(v, u)


def _resolve_forks(g: ContigGraph, g0: ContigGraph):
    """At a fork u->{v1,v2}, add the v1->v2 (or v2->v1) edge if exactly
    one of them exists in the unfiltered graph (scaffold.cc
    resolveForks)."""
    for u in list(g.vertices()):
        succs = g.successors(u)
        if len(succs) < 2:
            continue
        for i, v1 in enumerate(succs):
            for v2 in succs[i + 1:]:
                if g.has_edge(v1, v2) or g.has_edge(v2, v1):
                    continue
                has12 = v2 in g0.out[v1]
                has21 = v1 in g0.out[v2]
                if has12 == has21:
                    continue  # both (cycle) or neither
                if has12:
                    g.add_edge(v1, v2, g0.out[v1][v2])
                else:
                    g.add_edge(v2, v1, g0.out[v2][v1])


def _prune_scaffold_tips(g: ContigGraph):
    """Remove v when some u with out-degree > 1 has u->v and v is a
    dead-end with in-degree 1 (scaffold.cc pruneTips)."""
    doomed = set()
    for u in g.vertices():
        if g.out_degree(u) <= 1:
            continue
        for v in g.successors(u):
            if g.in_degree(v) == 1 and g.out_degree(v) == 0:
                doomed.add(v >> 1)
    for cid in doomed:
        g.remove_contig(cid)


def _remove_repeats(g: ContigGraph):
    """Clear vertices that look repetitive: v on a transitive edge
    u->v->w1 with an extra branch v->w2 unrelated to w1 (scaffold.cc
    removeRepeats)."""
    repeats = []
    for u in g.vertices():
        succs = set(g.successors(u))
        for v in succs:
            for w1 in g.successors(v):
                if w1 not in succs:
                    continue
                # u->w1 is transitive over u->v->w1
                for w2 in g.successors(v):
                    if w2 != w1 and not g.has_edge(w1, w2) \
                            and not g.has_edge(w2, w1):
                        repeats.append(v)
                        break
                else:
                    continue
                break
    seen = set()
    for v in repeats:
        for w in list(g.successors(v)):
            g.remove_edge(v, w)
        if flip(v) in seen:
            g.remove_contig(v >> 1)
        seen.add(v)


def _remove_transitive(g: ContigGraph):
    """Remove u->w when some u->v->w exists (scaffold.cc
    remove_transitive_edges)."""
    for u in list(g.vertices()):
        succs = set(g.successors(u))
        if len(succs) < 2:
            continue
        second = set()
        for v in succs:
            second.update(g.successors(v))
        for w in succs & second:
            g.remove_edge(u, w)


def _pop_bubbles(g: ContigGraph):
    from ..graph.algorithms import pop_bubbles
    pop_bubbles(g)


def _remove_weak(g: ContigGraph):
    """Remove u1->v2 when u1 and v2 each have a strictly
    better-supported alternative (scaffold.cc removeWeakEdges)."""
    weak = []
    for u1 in g.vertices():
        if g.out_degree(u1) != 2:
            continue
        for v2, prop in g.out_edges(u1):
            if g.in_degree(v2) != 2:
                continue
            v1 = next(v for v in g.successors(u1) if v != v2)
            if g.in_degree(v1) != 1:
                continue
            u2 = next(w for w in g.predecessors(v2) if w != u1)
            if g.out_degree(u2) != 1:
                continue
            n = (prop or {}).get("n", 0)
            n_u1v1 = (g.out[u1][v1] or {}).get("n", 0)
            n_u2v2 = (g.out[u2].get(v2) or {}).get("n", 0)
            if n < n_u1v1 and n < n_u2v2:
                weak.append((u1, v2))
    for u, v in weak:
        g.remove_edge(u, v)


@dataclass
class ScaffoldResult:
    n: int
    s: int
    n50: int
    paths: list
    graph: ContigGraph


def build_scaffold_paths(g0: ContigGraph, min_pairs: int, min_len: int,
                         k: int = 0, min_gap: int = 50,
                         max_gap: int | None = None,
                         ss: bool = False) -> ScaffoldResult:
    """One (n, s) scaffolding pass (scaffold.cc scaffold()); ss=True
    assembles strand-specifically (assembleDFS ss, scaffold.cc:795)."""
    g = g0.copy()
    _filter_graph(g, min_pairs, min_len)
    _remove_cycles(g)
    _resolve_forks(g, g0)
    _prune_scaffold_tips(g)
    _remove_repeats(g)
    _remove_transitive(g)
    _prune_scaffold_tips(g)
    _pop_bubbles(g)
    _remove_weak(g)
    if max_gap is not None:
        for u in list(g.vertices()):
            for v, prop in g.out_edges(u):
                if ((prop or {}).get("d", 0)) > max_gap:
                    g.remove_edge(u, v)
    from ..graph.algorithms import assemble_chains, assemble_stranded
    chains = assemble_stranded(g) if ss else assemble_chains(g)
    # insert N entries sized d + k - 1 (addDistEst convention)
    paths = []
    lengths = []
    used = set()
    for chain in chains:
        out = [chain[0]]
        total = g.lengths[chain[0] >> 1]
        for u, v in zip(chain, chain[1:]):
            prop = (g.out[u].get(v) if v in g.out[u]
                    else g0.out[u].get(v)) or {}
            d = prop.get("d", 0)
            sd = prop.get("sd", prop.get("e", 1))
            exact_overlap = (sd == 0 and d < 0)
            if not exact_overlap:
                out.append(amb(max(1, max(int(d), min_gap) + k - 1)))
            out.append(v)
            total += g.lengths[v >> 1]
            used.add(v >> 1)
        used.add(chain[0] >> 1)
        paths.append(out)
        lengths.append(total)
    lengths += [g0.lengths[c] for c in g0.contigs() if c not in used]
    from ..core.histogram import Histogram
    h = Histogram.of(x for x in lengths if x >= min_len)
    n50 = int(h.n50()) if h.size() else 0
    return ScaffoldResult(min_pairs, min_len, n50, paths, g)


def _s_steps(lo: int, hi: int) -> list[int]:
    """Three values of s per decade, rounded to one significant figure
    (scaffold.cc optimize_s)."""
    if lo >= hi:
        return [lo]
    step = 10 ** (1 / 3)
    out = []
    i0 = round(math.log(max(lo, 1)) / math.log(step))
    i1 = round(math.log(hi) / math.log(step))
    for i in range(i0, i1 + 1):
        s = step ** i
        decade = 10 ** math.floor(math.log10(max(s, 1)))
        s = int(round(s / decade) * decade)
        if not out or s != out[-1]:
            out.append(s)
    return out


def search_scaffold_params(g0: ContigGraph, n_range, s_range,
                           k: int = 0, min_gap: int = 50,
                           strategy: str = "grid", n_step: int = 1,
                           verbose: int = 0,
                           ss: bool = False) -> ScaffoldResult:
    """Find (n, s) maximizing scaffold N50 (scaffold.cc
    optimize_grid_search / optimize_line_search, memoized)."""
    n_lo, n_hi = n_range if isinstance(n_range, tuple) else \
        (n_range, n_range)
    s_lo, s_hi = s_range if isinstance(s_range, tuple) else \
        (s_range, s_range)
    memo: dict[tuple, ScaffoldResult] = {}

    def run(n, s):
        if (n, s) not in memo:
            memo[(n, s)] = build_scaffold_paths(g0, n, s, k=k,
                                                min_gap=min_gap, ss=ss)
            if verbose:
                print(f"[scaffold] n={n} s={s} "
                      f"N50={memo[(n, s)].n50}", file=sys.stderr)
        return memo[(n, s)]

    ns = list(range(n_lo, n_hi + 1, n_step))
    # NB: do not name this `ss` — that would shadow the strand-
    # specific flag captured by run() (the round-4 stage-8 regression)
    s_steps = _s_steps(s_lo, s_hi)
    best = None

    def better(r, cur):
        return cur is None or r.n50 > cur.n50

    if strategy == "line" and len(ns) > 1 and len(s_steps) > 1:
        # alternate 1-D optimizations until fixpoint (line search)
        best = run(ns[len(ns) // 2], s_steps[-1])
        for _ in range(len(ns)):
            prev = (best.n, best.s)
            for s in s_steps:
                r = run(best.n, s)
                if better(r, best):
                    best = r
            for n in ns:
                r = run(n, best.s)
                if better(r, best):
                    best = r
            if (best.n, best.s) == prev:
                break
    else:
        for n in ns:
            for s in s_steps:
                r = run(n, s)
                if better(r, best):
                    best = r
    return best
