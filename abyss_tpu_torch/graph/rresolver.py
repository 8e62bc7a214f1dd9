"""RResolver: repeat resolution at the unitig stage using read-length
r-mers.

Port of abyss_tpu/graph/rresolver.py.  Reimplements the core of
RResolver/RAlgorithmsShort.{h,cpp}
(see RResolver/README.md:1-27): for every junction in the unitig
overlap graph, enumerate the short paths that cross it, slide windows
of size r (close to the read length) across each path, and count how
many windows are supported by an r-mer Bloom filter built from the
reads.  Paths whose support falls below the threshold are false joins
created by k-mer-scale ambiguity; their edges are cut, splitting
repeats that reads can resolve.

The r-mer filter reuses the ntHash kernel (any r) and the bit Bloom
filter on the device, so support queries are batched device gathers
like everything else; the junction enumeration and the cuts are host
code, copied as they are.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core import alphabet
from ..ops import nthash
from ..ops.bloom import BitBloomFilter, CountingBloomFilter
from .contig_graph import ContigGraph, flip, node


@dataclass
class RResolverStats:
    junctions: int = 0
    paths_tested: int = 0
    paths_supported: int = 0
    edges_cut: int = 0
    repeats_split: int = 0


def build_rmer_filter(batches, r: int, size: int, num_hashes: int = 4,
                      threshold: int = 1, device="cuda") -> BitBloomFilter:
    """Bloom filter of read r-mers (RResolver/BloomFilters.{h,cpp}).

    A plain bit filter, like the reference's vanilla
    btllib::KmerBloomFilter (BloomFilters.h:12,25) — window support is
    a membership test, so counting inserts (sort + RLE per batch)
    would be wasted work.  `threshold` is accepted for signature
    compatibility and ignored.  The filter is built on `device` from
    [B, L] numpy code batches."""
    dev = resolve_device(device)
    f = BitBloomFilter.create(size, r, num_hashes, device=dev)
    for codes in batches:
        if codes.shape[1] < r:
            continue
        _, _, canon, valid = nthash.kmer_hashes(
            torch.from_numpy(np.ascontiguousarray(codes)).to(dev), r)
        f.insert(canon, valid)
    return f


def _oriented_seq(g, seqs, v):
    s = seqs[g.names[v >> 1]]
    return s if (v & 1) == 0 else alphabet.revcomp(s)


def _junction_paths(g: ContigGraph, v: int, max_branches: int):
    """(in, v, out) triples crossing junction vertex v; one-sided paths
    (in, v, None)/(None, v, out) when the other side is empty."""
    ins = g.predecessors(v)
    outs = g.successors(v)
    if len(ins) < 2 and len(outs) < 2:
        return []
    if max(len(ins), 1) * max(len(outs), 1) > max_branches:
        return []
    if not ins:
        return [(None, v, b) for b in outs]
    if not outs:
        return [(a, v, None) for a in ins]
    return [(a, v, b) for a in ins for b in outs]


MIN_MARGIN = 2  # RAlgorithmsShort.h:16


def _path_windows(g, seqs, path, k: int, r: int, min_tests: int,
                  max_tests: int):
    """The margin-confined r-window battery of a 3-vertex junction
    path (testCombination/getMargin, RAlgorithmsShort.cpp:369-416):
    exactly ~`tests` windows centred on the repeat, each reaching
    `margin = (r + tests - 1 - repeatSize + 1) / 2` bases into both
    neighbours.  Returns None when the combination is UNKNOWN (window
    not long enough, margins unavailable, one-sided junction) — the
    reference keeps unknown paths (never cuts on missing evidence)."""
    a, v, b = path
    if a is None or b is None:
        return None
    texts = [_oriented_seq(g, seqs, p) for p in (a, v, b)]
    o = k - 1
    merged = texts[0] + texts[1][o:] + texts[2][o:]
    repeat_start = len(texts[0]) - o
    repeat_size = len(texts[1])
    repeat_end = repeat_start + repeat_size
    tests = min_tests
    # window long enough? (getMinWindowLength: tests-1 + 2m + repeat)
    if r < tests - 1 + MIN_MARGIN + repeat_size + MIN_MARGIN:
        return None
    if tests > max_tests:
        return None
    margin = (r + tests - 1 - repeat_size + 1) // 2
    if repeat_start < margin or len(merged) - repeat_end < margin:
        return None     # head/tail shorter than margin
    sub = merged[repeat_start - margin: repeat_end + margin]
    if len(sub) < r:
        return None
    return [sub[s:s + r] for s in range(len(sub) - r + 1)]


def resolve_repeats(g: ContigGraph, seqs: dict[str, str],
                    rmer_filter: BitBloomFilter | CountingBloomFilter, k: int,
                    support_threshold: int = 4, min_tests: int = 18,
                    max_tests: int = 40, max_branches: int = 75,
                    ) -> RResolverStats:
    """Cut junction-crossing edges that reads do not support; the
    window probe runs on the filter's device.

    An (in, v, out) path is supported when enough of its r-windows are
    present in the read r-mer filter.  Edges that appear in *no*
    supported path (but whose junction had at least one supported
    alternative) are removed.
    """
    r = rmer_filter.k
    stats = RResolverStats()
    edge_support: dict[tuple[int, int], bool] = {}

    # pass 1 (host): enumerate every junction path and collect all of
    # their r-windows; pass 2 (device): ONE batched filter probe over
    # the whole window set — per-path device calls would mean thousands
    # of tiny dispatches at ever-varying shapes
    path_infos: list[tuple[tuple, int, int]] = []  # (path, start, n)
    all_windows: list[str] = []
    for cid in list(g.contigs()):
        for s in (0, 1):
            v = node(cid, s)
            paths = _junction_paths(g, v, max_branches)
            if not paths:
                continue
            stats.junctions += 1
            for path in paths:
                wins = _path_windows(g, seqs, path, k, r, min_tests,
                                     max_tests)
                stats.paths_tested += 1
                if wins is None:
                    # unresolvable: treat as supported (do not cut)
                    path_infos.append((path, 0, -1))
                else:
                    path_infos.append((path, len(all_windows), len(wins)))
                    all_windows.extend(wins)

    hits = np.zeros(0, bool)
    if all_windows:
        arr = np.full((len(all_windows), r), 4, np.uint8)
        for i, w in enumerate(all_windows):
            arr[i, :len(w)] = alphabet.encode(w)
        _, _, canon, valid = nthash.kmer_hashes(
            torch.from_numpy(arr).to(rmer_filter.device), r)
        hits = rmer_filter.contains(canon, valid)[:, 0].cpu().numpy()

    # per-repeat supported (in -> outs) map for instance splitting
    by_repeat: dict[int, dict[int, set]] = {}
    for path, start, nw in path_infos:
        if nw < 0:
            supported = True
        else:
            # good() = found >= threshold (RAlgorithmsShort.h:152);
            # too-few-possible-tests paths were already returned as
            # unknown (supported) by _path_windows
            supported = int(hits[start:start + nw].sum()) >= \
                support_threshold
        if supported:
            stats.paths_supported += 1
        a, vv, b = path
        if a is not None and b is not None and (vv & 1) == 0:
            ins = by_repeat.setdefault(vv, {})
            ins.setdefault(a, set())
            if supported:
                ins[a].add(b)
        edges = []
        if a is not None:
            edges.append((a, vv))
        if b is not None:
            edges.append((vv, b))
        for e in edges:
            edge_support[e] = edge_support.get(e, False) | supported

    # resolved-repeat duplication (RAlgorithmsShort.cpp:1002-1060):
    # group a repeat's in-contigs by their SET of supported out-contigs;
    # each distinct set beyond the first becomes an instance COPY of the
    # repeat (same sequence, fresh name) wired intigs -> copy -> outigs.
    # The copies land in -1-rr.fa and let downstream merges thread each
    # context through its own repeat copy.
    handled: set[int] = set()
    for vv in sorted(by_repeat):
        ins = by_repeat[vv]
        instances: list[tuple[frozenset, list[int]]] = []
        cut_ins = []
        for a in sorted(ins):
            S = frozenset(ins[a])
            if not S:
                cut_ins.append(a)
                continue
            for outset, members in instances:
                if outset == S:
                    members.append(a)
                    break
            else:
                instances.append((S, [a]))
        if len(instances) <= 1:
            continue        # the plain edge-cut pass suffices
        vprop = {b: g.out[vv].get(b) for b in g.successors(vv)}
        # instance 0 keeps the original vertex: prune its outs to S0
        S0, members0 = instances[0]
        for b in list(g.successors(vv)):
            if b not in S0:
                g.remove_edge(vv, b)
                stats.edges_cut += 1
        for outset, members in instances[1:]:
            name = f"{g.names[vv >> 1]}r{stats.repeats_split}"
            stats.repeats_split += 1
            cid = g.add_contig(name, g.lengths[vv >> 1],
                               g.coverages[vv >> 1])
            seqs[name] = _oriented_seq(g, seqs, vv)
            copy_v = node(cid, 0)
            for a in members:
                prop = g.out[a].get(vv)
                g.remove_edge(a, vv)
                g.add_edge(a, copy_v, prop)
            for b in outset:
                g.add_edge(copy_v, b, vprop.get(b))
        for a in cut_ins:
            if g.has_edge(a, vv):
                g.remove_edge(a, vv)
                stats.edges_cut += 1
        # this vertex's edges are fully decided; skip the generic cuts
        handled.add(vv)
        handled.add(flip(vv))

    for (u, v), sup in sorted(edge_support.items()):
        if u in handled or v in handled or flip(u) in handled \
                or flip(v) in handled:
            continue
        if not sup and g.has_edge(u, v):
            g.remove_edge(u, v)
            stats.edges_cut += 1
    return stats


def read_size_batches(lengths: np.ndarray,
                      fraction_threshold: float = 0.1) -> list[int]:
    """Distinct read sizes covering >= 10% of reads each, ascending
    (RAlgorithmsShort.cpp determineShortReadStats:
    READ_BATCH_FRACTION_THRESHOLD)."""
    lengths = np.asarray(lengths)
    lengths = lengths[lengths > 0]
    if not len(lengths):
        return []
    sizes, counts = np.unique(lengths, return_counts=True)
    frac = counts / counts.sum()
    out = [int(s) for s, fr in zip(sizes, frac)
           if fr >= fraction_threshold]
    if not out:
        out = [int(sizes[np.argmax(counts)])]
    return out


def default_r(read_size: int, k: int, extract: int = 4) -> int:
    """The reference's r heuristic: min(k + 60, read_size,
    read_size - extract + 1) (RAlgorithmsShort.cpp:266,
    R_HEURISTIC=60, opt::extract=4)."""
    return min(k + 60, read_size, read_size - extract + 1)


def resolve_repeats_multi(g: ContigGraph, seqs: dict[str, str],
                          read_batches_fn, read_lengths: np.ndarray,
                          k: int, filter_size: int = 1 << 22,
                          support_threshold: int = 4,
                          max_subiterations: int = 5,
                          verbose: int = 0, device="cuda") -> RResolverStats:
    """The full resolveShort driver (RAlgorithmsShort.cpp:1258-1323):
    one r per read-size batch (the reference's multi-r sweep comes from
    multi-size read sets), a fresh r-mer filter per r, and
    subiterations per r until no new unsupported paths appear.

    read_batches_fn() must return a fresh iterator of [B, L] code
    arrays on each call (the filter is rebuilt per r, on `device`)."""
    total = RResolverStats()
    max_len = int(read_lengths.max()) if len(read_lengths) else 0
    for size in read_size_batches(read_lengths):
        r = default_r(size, k)
        if r <= k or r > max_len:
            continue
        rmer = build_rmer_filter(read_batches_fn(), r=r,
                                 size=filter_size, device=device)
        for sub in range(max_subiterations):
            st = resolve_repeats(g, seqs, rmer, k,
                                 support_threshold=support_threshold)
            total.junctions += st.junctions
            total.paths_tested += st.paths_tested
            total.paths_supported += st.paths_supported
            total.edges_cut += st.edges_cut
            if verbose:
                import sys
                print(f"[rresolver] size={size} r={r} sub={sub + 1}: "
                      f"cut {st.edges_cut}", file=sys.stderr)
            if st.edges_cut == 0:
                break
    return total
