"""Contig-graph algorithms: chain assembly, tip/island/shim removal,
bubble popping, path materialization.

Reimplements the reference's Graph/ContigGraphAlgorithms.h (assemble,
merge, pruneTips, removeIslands), Graph/PopBubbles.h (bubble discovery)
and MergePaths/MergeContigs.cpp (path -> sequence)."""

from __future__ import annotations

from ..core import alphabet
from .contig_graph import ContigGraph, flip, node


def contiguous_out(g: ContigGraph, u: int) -> int | None:
    """The unique successor v of u with unique predecessor u
    (ContigGraphAlgorithms.h contiguous_out)."""
    succ = g.successors(u)
    if len(succ) != 1:
        return None
    v = succ[0]
    if g.in_degree(v) != 1:
        return None
    return v


def assemble_chains(g: ContigGraph) -> list[list[int]]:
    """Maximal unambiguous paths (assemble, ContigGraphAlgorithms.h:221).

    Returns vertex paths of length >= 2; each chain reported once (not
    its complement).  Singleton contigs are not reported.
    """
    chains = []
    seen = set()
    for u in g.vertices():
        if u in seen:
            continue
        v = contiguous_out(g, u)
        if v is None:
            continue
        # u starts a chain only if it is not itself mid-chain
        prev = g.predecessors(u)
        if len(prev) == 1 and contiguous_out(g, prev[0]) == u:
            continue
        path = [u]
        while v is not None and v not in seen and v != u:
            path.append(v)
            v = contiguous_out(g, v)
        if len(path) >= 2:
            comp = [flip(x) for x in reversed(path)]
            if min(path) <= min(comp):
                chains.append(path)
            else:
                chains.append(comp)
            seen.update(path)
            seen.update(comp)
    return chains


def assemble_stranded(g: ContigGraph) -> list[list[int]]:
    """Strand-specific chain assembly (assemble_stranded,
    ContigGraphAlgorithms.h:250-253, the ss= mode): merge only along
    edges whose BOTH endpoints are forward-sense (the IsPositive
    predicate, :228-244), so sense/antisense transcripts stay separate
    and mixed-orientation joins are never made.  Chains are emitted in
    their own (forward) orientation — no canonicalization."""
    def fwd_out(u: int):
        v = contiguous_out(g, u)
        return v if (v is not None and (u & 1) == 0 and (v & 1) == 0) \
            else None

    chains = []
    seen = set()
    for u in g.vertices():
        if u in seen or (u & 1):
            continue
        v = fwd_out(u)
        if v is None:
            continue
        prev = g.predecessors(u)
        if len(prev) == 1 and fwd_out(prev[0]) == u:
            continue
        path = [u]
        while v is not None and v not in seen and v != u:
            path.append(v)
            v = fwd_out(v)
        if len(path) >= 2:
            chains.append(path)
            seen.update(path)
    return chains


def merge_chain(g: ContigGraph, path: list[int],
                seqs: dict[str, str]) -> str:
    """Materialize a chain into sequence using edge distances
    (MergeContigs.cpp mergePath): negative d = overlap, positive d =
    'N' gap."""
    def oriented_seq(v: int) -> str:
        s = seqs[g.names[v >> 1]]
        return s if (v & 1) == 0 else alphabet.revcomp(s)

    out = [oriented_seq(path[0])]
    for a, b in zip(path, path[1:]):
        prop = g.out[a].get(b) or {}
        d = prop.get("d", 0)
        s = oriented_seq(b)
        if d < 0:
            # sanity: the overlap must match
            out.append(s[-d:])
        else:
            out.append("N" * int(d) + s)
    return "".join(out)


def merge_linear_chains(g: ContigGraph, seqs: dict[str, str],
                        next_name: int | None = None, ss: bool = False,
                        ) -> tuple[ContigGraph, dict[str, str], list[list[int]]]:
    """Merge all unambiguous chains into new contigs, producing a new
    graph (the core of abyss-filtergraph --assemble / MergeContigs).
    ss=True uses the strand-specific predicate (--SS, the pe ss= knob)."""
    chains = assemble_stranded(g) if ss else assemble_chains(g)
    merged_of = {}  # vertex -> (new_cid, position)
    new_contigs: list[tuple[str, str, int]] = []
    if next_name is None:
        next_name = max((int(n) for n in g.names if n.isdigit()),
                        default=-1) + 1
    used = set()
    for path in chains:
        seq = merge_chain(g, path, seqs)
        cov = sum(g.coverages[v >> 1] for v in path)
        new_contigs.append((str(next_name), seq, cov))
        for v in path:
            used.add(v >> 1)
        merged_of[path[0]] = (len(new_contigs) - 1, "start")
        merged_of[path[-1]] = (len(new_contigs) - 1, "end")
        next_name += 1

    g2 = ContigGraph()
    out_seqs = {}
    # carry over untouched contigs
    old_to_new = {}
    for cid in g.contigs():
        if cid in used:
            continue
        n = g.names[cid]
        nc = g2.add_contig(n, g.lengths[cid], g.coverages[cid])
        old_to_new[cid] = nc
        out_seqs[n] = seqs[n]
    chain_new_id = {}
    for i, (n, seq, cov) in enumerate(new_contigs):
        nc = g2.add_contig(n, len(seq), cov)
        chain_new_id[i] = nc
        out_seqs[n] = seq

    def map_vertex(v: int, end: str) -> int | None:
        """Map an old vertex to the new graph (chain ends map to the
        merged contig)."""
        if (v >> 1) in old_to_new:
            return node(old_to_new[v >> 1], v & 1)
        return None

    # rebuild edges: edges whose endpoints survive, or connect to chain ends
    chain_of_start = {}
    chain_of_end = {}
    for i, path in enumerate(chains):
        chain_of_start[path[0]] = i
        chain_of_end[path[-1]] = i

    def new_vertex_for(v: int, incoming: bool) -> int | None:
        if (v >> 1) in old_to_new:
            return node(old_to_new[v >> 1], v & 1)
        # v inside a chain: only ends keep external edges
        if incoming:
            # edges INTO v: valid if v is a chain start (fwd) / end (flip)
            if v in chain_of_start:
                return node(chain_new_id[chain_of_start[v]], 0)
            if flip(v) in chain_of_end:
                return node(chain_new_id[chain_of_end[flip(v)]], 1)
        else:
            # edges OUT of v: valid if v is a chain end / flipped start
            if v in chain_of_end:
                return node(chain_new_id[chain_of_end[v]], 0)
            if flip(v) in chain_of_start:
                return node(chain_new_id[chain_of_start[flip(v)]], 1)
        return None

    for u in g.vertices():
        for v, prop in g.out_edges(u):
            nu = new_vertex_for(u, incoming=False)
            nv = new_vertex_for(v, incoming=True)
            if nu is None or nv is None:
                continue
            if nu >> 1 == nv >> 1 and (u >> 1) != (v >> 1):
                continue  # edge absorbed inside a chain
            if not g2.has_edge(nu, nv):
                g2.add_edge(nu, nv, dict(prop) if prop else None)
    # drop edges absorbed inside chains (u->v both interior)
    return g2, out_seqs, chains


def bfs(g: ContigGraph, start: int, max_depth: int | None = None) -> dict:
    """Breadth-first search (Graph/BreadthFirstSearch.h): returns
    {vertex: depth} for every oriented vertex reachable from start."""
    from collections import deque
    depth = {start: 0}
    q = deque([start])
    while q:
        u = q.popleft()
        if max_depth is not None and depth[u] >= max_depth:
            continue
        for v in g.successors(u):
            if v not in depth:
                depth[v] = depth[u] + 1
                q.append(v)
    return depth


def all_paths_search(g: ContigGraph, start: int, goal: int,
                     max_paths: int = 100,
                     max_depth: int = 100) -> list[list[int]] | None:
    """All simple paths start -> goal (Graph/AllPathsSearch.h).  Returns
    None when the path count or depth limit is exceeded (the reference's
    'too many paths' result)."""
    paths: list[list[int]] = []
    stack = [(start, [start])]
    while stack:
        u, path = stack.pop()
        if u == goal and len(path) > 1:
            paths.append(path)
            if len(paths) > max_paths:
                return None
            continue
        if len(path) > max_depth:
            return None
        for v in g.successors(u):
            if v in path and v != goal:
                continue  # simple paths only
            stack.append((v, path + [v]))
    return paths


def bidirectional_bfs(g: ContigGraph, start: int, goal: int,
                      max_depth: int = 50) -> int | None:
    """Bidirectional BFS distance start -> goal
    (Graph/BidirectionalBFS.h): expands frontiers from both ends,
    meeting in the middle.  Returns the path length or None."""
    if start == goal:
        return 0
    from .contig_graph import flip
    fwd = {start: 0}
    # searching backwards over successors of flip(v) mirrors
    # predecessor expansion in the skew-symmetric graph
    bwd = {goal: 0}
    frontier_f = [start]
    frontier_b = [goal]
    for _ in range(max_depth):
        # expand the smaller frontier
        if len(frontier_f) <= len(frontier_b):
            nxt = []
            for u in frontier_f:
                for v in g.successors(u):
                    if v in bwd:
                        return fwd[u] + 1 + bwd[v]
                    if v not in fwd:
                        fwd[v] = fwd[u] + 1
                        nxt.append(v)
            frontier_f = nxt
        else:
            nxt = []
            for u in frontier_b:
                for w in g.successors(flip(u)):
                    v = flip(w)
                    if v in fwd:
                        return fwd[v] + 1 + bwd[u]
                    if v not in bwd:
                        bwd[v] = bwd[u] + 1
                        nxt.append(v)
            frontier_b = nxt
        if not frontier_f and not frontier_b:
            return None
    return None


def prune_tips(g: ContigGraph, max_len: int) -> list[int]:
    """Remove short dead-end branches (pruneTips,
    ContigGraphAlgorithms.h).  A tip is a contig t with out_degree == 0
    (dead end), length <= max_len, whose predecessor has another
    outgoing branch.  Returns removed contig ids; iterates to fixpoint.
    """
    removed = []
    changed = True
    while changed:
        changed = False
        for cid in list(g.contigs()):
            for s in (0, 1):
                t = node(cid, s)
                if g.out_degree(t) != 0:
                    continue
                if g.lengths[cid] > max_len:
                    continue
                preds = g.predecessors(t)
                if not preds:
                    continue
                if any(g.out_degree(p) > 1 for p in preds):
                    g.remove_contig(cid)
                    removed.append(cid)
                    changed = True
                    break
    return removed


def remove_shims(g: ContigGraph, max_degree: int = 1,
                 min_overlap: int = 10, protected: set | None = None,
                 ) -> list[int]:
    """Remove shim (filler) contigs — the reference filtergraph's
    DEFAULT cleaning pass (FilterGraph.cc:202-527): a shim only
    contributes k-1 bases; once removed, each (predecessor, successor)
    pair still overlaps by >= min_overlap, so spliced u->w edges with
    d = d(u,v) + len(v) + d(v,w) preserve connectivity.

    Faithful details: candidates are discovered ONCE (both
    orientations, vertex-index order), sorted per pass by
    (in*out degree, length, id); a vertex made adjacent to a removed
    branch point is deferred to the next pass; parallel spliced edges
    are skipped; self- or self-complement-adjacent contigs and
    tails are never shims; min(in, out) degree must be <= max_degree."""
    protected = protected or set()

    def dist(u: int, v: int) -> int:
        p = g.out[u].get(v)
        return int(p["d"]) if isinstance(p, dict) and "d" in p else 0

    def removable(v: int) -> bool:
        cid = v >> 1
        if g.removed[cid] or cid in protected:
            return False
        outs = g.successors(v)
        ins = g.predecessors(v)
        if min(len(outs), len(ins)) == 0:       # tail
            return False
        if min(len(outs), len(ins)) > max_degree:
            return False
        for w in outs:
            if w == v or w == flip(v):          # self(-complement) adjacent
                return False
        maxuv = max(dist(u, v) for u in ins)
        maxvw = max(dist(v, w) for w in outs)
        if maxuv + g.lengths[cid] + maxvw > -min_overlap:
            return False
        return True

    removed: list[int] = []
    cands = [v for v in g.vertices() if removable(v)]
    while cands:
        cands.sort(key=lambda v: (g.out_degree(v) * g.in_degree(v),
                                  g.lengths[v >> 1], v))
        marked: set[int] = set()
        deferred = []
        for v in cands:
            cid = v >> 1
            if cid in marked:
                deferred.append(v)
                continue
            if not removable(v):
                continue
            ins = list(g.predecessors(v))
            outs = list(g.successors(v))
            for u in ins:
                for w in outs:
                    if len(outs) > 1:
                        marked.add(u >> 1)
                    if len(ins) > 1:
                        marked.add(w >> 1)
                    if g.has_edge(u, w):        # parallel edge
                        continue
                    x = dist(u, v) + g.lengths[cid] + dist(v, w)
                    g.add_edge(u, w, {"d": x})
            g.remove_contig(cid)
            removed.append(cid)
        cands = deferred
    return removed


def remove_islands(g: ContigGraph, min_len: int) -> list[int]:
    """Remove contigs with no edges shorter than min_len
    (removeIslands, ContigGraphAlgorithms.h)."""
    removed = []
    for cid in list(g.contigs()):
        u = node(cid, 0)
        if g.out_degree(u) == 0 and g.in_degree(u) == 0 \
                and g.lengths[cid] < min_len:
            g.remove_contig(cid)
            removed.append(cid)
    return removed


def find_bubbles(g: ContigGraph) -> list[tuple[int, list[int], int]]:
    """Find simple bubbles (PopBubbles.h): a source u whose successors
    are >= 2 single-in single-out branches that all reconverge at the
    same sink w.  Returns (source, branch_vertices, sink) triples."""
    bubbles = []
    seen_sinks = set()
    for u in g.vertices():
        succ = g.successors(u)
        if len(succ) < 2:
            continue
        branches = []
        sink = None
        ok = True
        for b in succ:
            if g.in_degree(b) != 1 or g.out_degree(b) != 1:
                ok = False
                break
            w = g.successors(b)[0]
            if sink is None:
                sink = w
            elif w != sink:
                ok = False
                break
            branches.append(b)
        if ok and sink is not None and sink != u and \
                g.in_degree(sink) == len(branches):
            if (flip(sink), flip(u)) in seen_sinks:
                continue
            seen_sinks.add((u, sink))
            bubbles.append((u, branches, sink))
    return bubbles


def pop_bubbles(g: ContigGraph, identity_check=None) -> list[int]:
    """Remove all but the highest-coverage branch of each simple bubble
    (PopBubbles tool, PopBubbles/PopBubbles.cpp; identity_check(a, b)
    may veto dissimilar branches like the p >= 0.9 alignment check)."""
    removed = []
    for u, branches, w in find_bubbles(g):
        if any(g.removed[b >> 1] for b in branches + [u, w]):
            continue
        if identity_check is not None and not identity_check(branches):
            continue
        keep = max(branches,
                   key=lambda b: (g.coverages[b >> 1], -(b >> 1)))
        for b in branches:
            if b != keep:
                g.remove_contig(b >> 1)
                removed.append(b >> 1)
    return removed
