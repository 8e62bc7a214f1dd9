"""Path algebra with ambiguous (N-gap) entries + MergePaths merging.

The reference's contig paths (Common/ContigPath.h) admit *ambiguous*
entries — "N" nodes carrying only a length — produced by scaffolding
and by the consensus path merge.  MergePaths/MergePaths.cpp aligns two
paths around a shared pivot contig, reconciling gaps against concrete
sub-paths by length arithmetic, and merges all per-seed paths either
greedily (--greedy, extendPaths) or through a path-overlap graph with
consensus alignment (the default, assemblePathGraph).  This module is
the host-side port of that algebra (paths are ~10^3 small lists; the
device has no business here).

Encoding: a path is a list[int]; entry >= 0 is an oriented contig
vertex (2*id+sense, graph/contig_graph.py), entry < 0 is an ambiguous
gap of `-entry - 1` k-mers (ContigNode(n, 'N')).

Lengths are in k-mers (contig bp - k + 1), matching
MergePaths.cpp:readContigLengths.
"""

from __future__ import annotations

from ..graph.contig_graph import flip

# -- ambiguous-entry encoding -----------------------------------------------

DIR_X, DIR_F, DIR_R, DIR_B = 0, 1, 2, 3


def amb(length: int) -> int:
    """An ambiguous gap entry of `length` k-mers (ContigNode(n,'N'))."""
    return -int(length) - 1


def is_amb(e: int) -> bool:
    return e < 0


def amb_len(e: int) -> int:
    return -e - 1


def entry_len(lengths, e: int) -> int:
    """Length in k-mers of a path entry (MergePaths.cpp getLength)."""
    return amb_len(e) if e < 0 else lengths[e >> 1]


def path_rc(p: list[int]) -> list[int]:
    """reverseComplement of a path: reverse order, flip senses; gaps
    are self-complementary."""
    return [e if e < 0 else flip(e) for e in reversed(p)]


def path_len(lengths, p: list[int]) -> int:
    return sum(entry_len(lengths, e) for e in p)


# -- pairwise path alignment (MergePaths.cpp align() family) ----------------


def _build_consensus(lengths, p1, i1, e1, p2, i2, e2, out) -> bool:
    """Fill p1's gap at i1 (region p1[i1:e1]) with p2[i2:e2]
    (MergePaths.cpp buildConsensus)."""
    it1b = i1 + 1
    if it1b == e1:
        # p2 completely fills the gap of p1
        out.extend(p2[i2:e2])
        return True
    # the gaps of p1 and p2 overlap: p2 must end the region with a gap
    it2a = e2 - 1
    if e2 == i2 or not is_amb(p2[it2a]):
        return False
    ambiguous1 = amb_len(p1[i1])
    ambiguous2 = amb_len(p2[it2a])
    unambiguous1 = sum(entry_len(lengths, e) for e in p1[it1b:e1])
    unambiguous2 = sum(entry_len(lengths, e) for e in p2[i2:it2a])
    if ambiguous1 < unambiguous2 or ambiguous2 < unambiguous1:
        return False
    n = max(1, ambiguous2 - unambiguous1, ambiguous1 - unambiguous2)
    out.extend(p2[i2:it2a])
    out.append(amb(n))
    out.extend(p1[it1b:e1])
    return True


def _align_coordinates(lengths, p1, i1, p2, i2, out):
    """Reconcile simultaneous gaps by length bookkeeping
    (MergePaths.cpp alignCoordinates).  Returns (ok, i1', i2')."""
    start = len(out)
    ambiguous1 = ambiguous2 = 0
    while i1 < len(p1) and i2 < len(p2):
        if is_amb(p1[i1]):
            ambiguous1 += amb_len(p1[i1])
            i1 += 1
            if i1 >= len(p1) or is_amb(p1[i1]):
                del out[start:]
                return False, i1, i2
        if is_amb(p2[i2]):
            ambiguous2 += amb_len(p2[i2])
            i2 += 1
            if i2 >= len(p2) or is_amb(p2[i2]):
                del out[start:]
                return False, i1, i2
        if ambiguous1 > 0 and ambiguous2 > 0:
            if ambiguous1 > ambiguous2:
                out.append(amb(ambiguous2))
                ambiguous1 -= ambiguous2
                ambiguous2 = 0
            else:
                out.append(amb(ambiguous1))
                ambiguous2 -= ambiguous1
                ambiguous1 = 0
        elif ambiguous1 > 0:
            ambiguous1 -= entry_len(lengths, p2[i2])
            out.append(p2[i2])
            i2 += 1
        elif ambiguous2 > 0:
            ambiguous2 -= entry_len(lengths, p1[i1])
            out.append(p1[i1])
            i1 += 1
        else:
            del out[start:]
            return False, i1, i2
        if ambiguous1 == 0 and ambiguous2 == 0:
            break
        if ambiguous1 < 0 or ambiguous2 < 0:
            del out[start:]
            return False, i1, i2
    ambiguous = ambiguous1 + ambiguous2
    if len(out) == start:
        return False, i1, i2
    if is_amb(out[-1]):
        if ambiguous != 0:
            del out[start:]
            return False, i1, i2
    else:
        out.append(amb(max(1, ambiguous)))
    return True, i1, i2


def _align_at_seed(lengths, p1, i1, e1, p2, i2, out):
    """Seed the gap alignment at p1[e1] matched against each occurrence
    in p2; keep the seed giving the shortest full consensus
    (MergePaths.cpp alignAtSeed).  Returns (ok, i1', i2')."""
    best_len = None
    best_e2 = None
    for e2 in range(i2, len(p2)):
        if p2[e2] != p1[e1]:
            continue
        trial = []
        if _build_consensus(lengths, p1, i1, e1, p2, i2, e2, trial):
            d, _, _ = _align_scan(lengths, p1, e1, p2, e2, trial)
            if d != DIR_X and (best_len is None or len(trial) <= best_len):
                best_len = len(trial)
                best_e2 = e2
    if best_e2 is None:
        return False, i1, i2
    ok = _build_consensus(lengths, p1, i1, e1, p2, i2, best_e2, out)
    assert ok
    return True, e1, best_e2


def _align_ambiguous(lengths, p1, i1, p2, i2, out):
    """Align starting at an ambiguous p1[i1]
    (MergePaths.cpp alignAmbiguous).  Returns (ok, i1', i2')."""
    for e1 in range(i1, len(p1)):
        if is_amb(p1[e1]):
            continue
        ok, n1, n2 = _align_at_seed(lengths, p1, i1, e1, p2, i2, out)
        if ok:
            return True, n1, n2
    # no seeded alignment: p2 may fit entirely within p1's gap
    return _align_coordinates(lengths, p1, i1, p2, i2, out)


def _align_one(lengths, p1, i1, p2, i2, out):
    """Consume the next aligned piece (MergePaths.cpp alignOne).
    Returns (ok, i1', i2')."""
    n1 = len(p1) - i1
    n2 = len(p2) - i2
    if n1 <= n2 and p1[i1:] == p2[i2:i2 + n1]:
        out.extend(p1[i1:])
        return True, len(p1), i2 + n1
    if n2 < n1 and p2[i2:] == p1[i1:i1 + n2]:
        out.extend(p2[i2:])
        return True, i1 + n2, len(p2)
    a1, a2 = is_amb(p1[i1]), is_amb(p2[i2])
    if a1 and a2:
        if amb_len(p1[i1]) > amb_len(p2[i2]):
            return _align_ambiguous(lengths, p1, i1, p2, i2, out)
        ok, j2, j1 = _align_ambiguous(lengths, p2, i2, p1, i1, out)
        return ok, j1, j2
    if a1:
        return _align_ambiguous(lengths, p1, i1, p2, i2, out)
    if a2:
        ok, j2, j1 = _align_ambiguous(lengths, p2, i2, p1, i1, out)
        return ok, j1, j2
    out.append(p1[i1])
    return p1[i1] == p2[i2], i1 + 1, i2 + 1


def _align_scan(lengths, p1, i1, p2, i2, out):
    """Align suffixes p1[i1:] / p2[i2:], appending the consensus to
    `out` (MergePaths.cpp align(it1,last1,it2,last2,out)).
    Returns (dir, i1', i2')."""
    while i1 < len(p1) and i2 < len(p2):
        ok, i1, i2 = _align_one(lengths, p1, i1, p2, i2, out)
        if not ok:
            return DIR_X, i1, i2
    out.extend(p1[i1:])
    out.extend(p2[i2:])
    if i1 >= len(p1) and i2 >= len(p2):
        return DIR_B, i1, i2
    return (DIR_F if i1 >= len(p1) else DIR_R), i1, i2


# orientation combination table (MergePaths.cpp align():DIRS): index =
# reverse-scan dir << 2 | forward-scan dir
_DIRS = [DIR_X, DIR_X, DIR_X, DIR_X,
         DIR_X, DIR_B, DIR_R, DIR_R,
         DIR_X, DIR_F, DIR_B, DIR_F,
         DIR_X, DIR_F, DIR_R, DIR_B]


def _align_at(lengths, p1, p2, k1, k2):
    """Align p1 and p2 anchored at p1[k1] == p2[k2]; returns
    (consensus, dir) with dir DIR_X on failure."""
    # reverse scan from the pivot leftwards
    r1 = path_rc(p1[:k1 + 1])
    r2 = path_rc(p2[:k2 + 1])
    outr: list[int] = []
    dr, _, _ = _align_scan(lengths, r1, 0, r2, 0, outr)
    if dr == DIR_X:
        return None, DIR_X
    outf: list[int] = []
    df, _, _ = _align_scan(lengths, p1, k1, p2, k2, outf)
    if df == DIR_X:
        return None, DIR_X
    consensus = path_rc(outr)[:-1] + outf
    orientation = _DIRS[dr << 2 | df]
    if orientation == DIR_X:
        return None, DIR_X
    return consensus, orientation


def _find_pivot(p1, p2):
    """A vertex unique in both paths (MergePaths.cpp findPivot)."""
    for e in p2:
        if is_amb(e):
            continue
        if p2.count(e) == 1 and p1.count(e) == 1:
            return e
    return None


def _is_sublist(small, big):
    n, m = len(small), len(big)
    for i in range(m - n + 1):
        if big[i:i + n] == small:
            return True, i
    return False, -1


def align_pair(lengths, p1: list[int], p2: list[int], pivot: int):
    """Find an equivalent region of two paths; returns
    (consensus, dir) — ([], DIR_X) when they cannot be reconciled
    (MergePaths.cpp align(lengths,p1,p2,pivot,orientation))."""
    self_align = p1 is p2
    if not self_align:
        if p1 == p2:
            return list(p1), DIR_B
        found, at = _is_sublist(p2, p1)
        if found:
            d = (DIR_R if at == 0 else
                 DIR_F if at + len(p2) == len(p1) else DIR_B)
            return list(p1), d
    if pivot is None or pivot not in p1 or pivot not in p2:
        pivot = _find_pivot(p1, p2)
        if pivot is None:
            return [], DIR_X
    k2 = p2.index(pivot)
    k1 = -1
    while True:
        try:
            k1 = p1.index(pivot, k1 + 1)
        except ValueError:
            return [], DIR_X
        if self_align and k1 == k2:
            continue  # trivial self-alignment
        consensus, d = _align_at(lengths, p1, p2, k1, k2)
        if d != DIR_X:
            return consensus, d


def path_is_cycle(lengths, p: list[int]) -> bool:
    """A path aligning with itself at a repeated pivot is a cycle
    (MergePaths.cpp isCycle)."""
    if not p or is_amb(p[0]):
        return False
    c, d = align_pair(lengths, p, p, p[0])
    return d != DIR_X and bool(c)


# -- per-seed path merging (MergePaths.cpp drivers) -------------------------


def _get_path(paths: dict, u: int) -> list[int]:
    """The stored path of an oriented seed (MergePaths.cpp getPath)."""
    p = paths[u >> 1]
    return path_rc(p) if (u & 1) else list(p)


def _equal_ignore_amb(a: list[int], b: list[int]) -> bool:
    if len(a) != len(b):
        return False
    return all(x == y or (is_amb(x) and is_amb(y)) for x, y in zip(a, b))


def find_repeats(paths: dict) -> set[int]:
    """Contigs appearing more than once within a single path
    (MergePaths.cpp findRepeats)."""
    repeats = set()
    for p in paths.values():
        seen: dict[int, int] = {}
        for e in p:
            if not is_amb(e):
                seen[e >> 1] = seen.get(e >> 1, 0) + 1
        repeats.update(c for c, n in seen.items() if n > 1)
    return repeats


def remove_repeats(paths: dict, verbose: int = 0) -> set[int]:
    """Drop seed paths rooted at tandem repeats
    (MergePaths.cpp removeRepeats)."""
    repeats = find_repeats(paths)
    hit = sum(1 for r in repeats if r in paths)
    if hit == len(paths) and hit > 0:
        return set()  # all repeats: likely a cyclic sequence; keep all
    for r in repeats:
        paths.pop(r, None)
    return repeats


def remove_subsumed(lengths, paths: dict) -> None:
    """Drop paths equal to a sub-alignment of a larger one
    (MergePaths.cpp removeSubsumedPaths/identifySubsumedPaths)."""
    overlaps: set[int] = set()
    changed = True
    while changed:
        changed = False
        for seed in sorted(paths):
            if seed not in paths:
                continue
            path = paths[seed]
            out: set[int] = set()
            for e in path:
                if is_amb(e) or (e >> 1) == seed:
                    continue
                other = e >> 1
                if other not in paths:
                    continue
                p2 = _get_path(paths, e)
                consensus, d = align_pair(lengths, path, p2, e)
                if d == DIR_X:
                    continue
                if _equal_ignore_amb(consensus, path):
                    out.add(other)
                elif _equal_ignore_amb(consensus, p2):
                    out = set()  # the other path subsumes this seed
                    out.add(seed)
                    break
                elif path_is_cycle(lengths, consensus):
                    if not path_is_cycle(lengths, path) and \
                            not path_is_cycle(lengths, p2):
                        overlaps.add(seed)
                        overlaps.add(other)
            if out:
                for o in out:
                    paths.pop(o, None)
                changed = True


def extend_path_greedy(lengths, seed: int, paths: dict) -> list[int]:
    """Greedily merge every reachable per-seed path into the seed's
    path (MergePaths.cpp extendPaths / mergePaths)."""
    path = list(paths[seed])
    seen = {2 * seed}
    queue = [e for e in path if not is_amb(e) and not (
        e in seen or seen.add(e))]
    while queue:
        next_queue = []
        merged = 0
        for pivot in queue:
            if (pivot >> 1) not in paths:
                continue
            p2 = _get_path(paths, pivot)
            consensus, d = align_pair(lengths, path, p2, pivot)
            if d == DIR_X:
                next_queue.append(pivot)
                continue
            path = consensus
            merged += 1
            for e in p2:
                if not is_amb(e) and e not in seen:
                    seen.add(e)
                    next_queue.append(e)
        if merged == 0:
            break
        queue = next_queue
    return path


def merge_seed_chain(lengths, paths: dict, seed_chain: list[int]):
    """Merge the paths of an ordered chain of seeds
    (MergePaths.cpp mergePath)."""
    path = _get_path(paths, seed_chain[0])
    prev = seed_chain[0]
    for seed in seed_chain[1:]:
        p2 = _get_path(paths, seed)
        pivot = seed if seed in path else prev
        consensus, d = align_pair(lengths, path, p2, pivot)
        if d != DIR_X:
            path = consensus
        prev = seed
    return path


def _canon(p: list[int]) -> tuple:
    q = path_rc(p)
    return tuple(min(p, q))


def merge_paths(lengths, paths: dict, greedy: bool = False,
                verbose: int = 0) -> list[list[int]]:
    """MergePaths main flow: merge per-seed paths into maximal
    consistent paths; non-greedy (default) assembles a path-overlap
    graph and merges along its linear chains
    (MergePaths.cpp main/assemblePathGraph)."""
    paths = {s: list(p) for s, p in paths.items() if len(p) >= 2}
    if not paths:
        return []
    if greedy:
        merged = {}
        for seed in sorted(paths):
            merged[seed] = extend_path_greedy(lengths, seed, paths)
        remove_repeats(merged, verbose)
        remove_subsumed(lengths, merged)
        result = merged
    else:
        # path-overlap graph over oriented seeds (buildPathGraph):
        # u -> v when the two seed paths align with that orientation
        from ..graph.contig_graph import ContigGraph
        g = ContigGraph()
        index = {}
        for seed in sorted(paths):
            index[seed] = g.add_contig(str(seed))
        for seed in sorted(paths):
            p1 = paths[seed]
            u = 2 * index[seed]
            for e in p1:
                if is_amb(e) or (e >> 1) == seed or (e >> 1) not in paths:
                    continue
                p2 = _get_path(paths, e)
                consensus, d = align_pair(lengths, p1, p2, e)
                if d == DIR_X:
                    continue
                v = 2 * index[e >> 1] + (e & 1)
                if d == DIR_B:
                    # subsumption: seed order in the consensus decides
                    su = _first_seed_pos(consensus, 2 * seed)
                    sv = _first_seed_pos(consensus, e)
                    d = DIR_F if su <= sv else DIR_R
                if d == DIR_F:
                    if not g.has_edge(u, v):
                        g.add_edge(u, v)
                else:
                    if not g.has_edge(v, u):
                        g.add_edge(v, u)
        _remove_transitive_edges(g)
        from ..graph.algorithms import assemble_chains
        chains = assemble_chains(g)
        covered = set()
        merged = {}
        for chain in chains:
            seeds = [2 * int(g.names[v >> 1]) + (v & 1) for v in chain]
            path = merge_seed_chain(lengths, paths, seeds)
            prc = path_rc(path)
            for s in seeds:
                if (s >> 1) in covered:
                    continue
                covered.add(s >> 1)
                merged[s >> 1] = prc if (s & 1) else path
        for seed, p in paths.items():
            if seed not in covered:
                merged[seed] = list(p)
        remove_repeats(merged, verbose)
        remove_subsumed(lengths, merged)
        result = merged
    # unique canonical output (outputSortedPaths dedupes by sort)
    seen = set()
    out = []
    for seed in sorted(result):
        c = _canon(result[seed])
        if c in seen or len(c) < 2:
            continue
        seen.add(c)
        out.append(list(c))
    return out


def _first_seed_pos(path: list[int], v: int) -> int:
    for i, e in enumerate(path):
        if e == v or e == flip(v):
            return i
    return len(path)


def _remove_transitive_edges(g) -> None:
    """Drop u->w when u->v->w exists (MergePaths.cpp
    removeTransitiveEdges semantics)."""
    for u in list(g.vertices()):
        succs = set(g.successors(u))
        if len(succs) < 2:
            continue
        second = set()
        for v in succs:
            second.update(g.successors(v))
        for w in succs & second:
            g.remove_edge(u, w)
