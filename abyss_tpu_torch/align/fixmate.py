"""Mate pairing: join per-read alignments into fragment records.

The role of abyss-fixmate (ParseAligns/abyss-fixmate.cc):
pair up the two reads of each fragment, emit
  * the fragment-size histogram (.hist) from same-contig FR pairs
    (g_histogram.insert, abyss-fixmate.cc:165), and
  * cross-contig pair links that feed DistanceEst.

One implementation over columns (`_pair_columns`, numpy over a library's
mapped reads); `fixmate` turns a list of Alignments into its columns,
`fixmate_columns` takes the mapper's block as it stands.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np
from numpy.lib.stride_tricks import as_strided

from ..core.histogram import Histogram
from ..utils import trace
from . import mapper
from .mapper import Alignment


@dataclass
class PairLink:
    """A read pair spanning two contigs, reoriented so that read1 points
    right on u and read2 points left on v (u -> v is the implied edge)."""
    u_name: str
    u_sense: int
    v_name: str
    v_sense: int
    # aligned segment of read1 on the *oriented* u, and read2 on oriented v
    p1: int        # start on oriented u
    a1: int        # aligned length on u
    p2: int
    a2: int
    u_len: int
    v_len: int


def fixmate(alignments: Iterable[Alignment | None],
            ) -> tuple[Histogram, list[PairLink]]:
    """Pair alignments by mate key.  Returns the fragment-size histogram
    (same-contig FR pairs) and cross-contig PairLinks."""
    alns = [a for a in alignments if a is not None]
    names: dict[str, int] = {}
    rname = [names.setdefault(a.rname, len(names)) for a in alns]
    rev, pos, qstart, qend, mapq, rlen = np.array(
        [(a.rev, a.pos, a.qstart, a.qend, a.mapq, a.rlen) for a in alns],
        np.int64).reshape(-1, 6).T
    return _pair_columns(*_mate_keys([a.qname for a in alns]),
                         np.array(rname, np.int64), rev, pos, qstart, qend,
                         mapq, rlen, list(names))


def fixmate_columns(cols: np.ndarray, qnames: list[str],
                    contig_names: list, contig_lengths: list,
                    ) -> tuple[Histogram, list[PairLink]]:
    """`fixmate` over the mapper's columns as they stand: cols is
    `mapper.align_columns`' block (`mapper.FIELDS` rows, one column a
    read, of read qnames[i]) over an index of those contigs."""
    m = np.flatnonzero(cols[mapper.MAPPED])
    keys, rank = _mate_keys(qnames)
    names: dict[str, int] = {}
    name_id = np.array([names.setdefault(n, len(names))
                        for n in contig_names], np.int64)
    cidx = cols[mapper.CONTIG, m]
    rev, pos, qstart, qend, mapq = cols[
        [mapper.REV, mapper.POS, mapper.QSTART, mapper.QEND,
         mapper.MAPQ]][:, m].astype(np.int64)
    return _pair_columns(
        keys[m], rank[m], name_id[cidx], rev, pos, qstart, qend, mapq,
        np.asarray(contig_lengths, np.int64)[cidx], list(names))


def _mate_keys(qnames: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Each read's mate key, its name without a /1 or /2 suffix (SAM-
    style mate naming), as a row of uint64 words: the key's UTF-8 bytes
    eight to a word, then its length; and the rank of the name among
    the names of its key: the key itself (0), key/1 (1) and key/2 (2),
    as string order ranks them.  Read names hold no newline."""
    n = len(qnames)
    raw = np.frombuffer("\n".join(qnames).encode("utf-8", "surrogatepass")
                        + bytes(8), np.uint8)
    ends = np.append(np.flatnonzero(raw[:-8] == 10), len(raw) - 8)
    if len(ends) != max(n, 1):
        raise ValueError("a read name holds a newline")
    ends = ends[:n]
    starts = np.concatenate([[0], ends[:-1] + 1])[:n]
    lens = ends - starts
    last, before = raw[ends - 1], raw[ends - 2]
    stripped = (lens > 2) & (before == ord("/")) & \
        ((last == ord("1")) | (last == ord("2")))
    rank = np.where(stripped, last.astype(np.int64) - ord("0"), 0)
    klen = lens - 2 * stripped
    # the eight bytes from each position, as one little-endian word
    win = as_strided(raw, (len(raw) - 7, 8), (1, 1)).view("<u8")[:, 0]
    words = [klen.astype(np.uint64)]
    for w in range(0, int(klen.max(initial=0)), 8):
        left = np.clip(klen - w, 0, 8).astype(np.uint64) * np.uint64(8)
        mask = np.where(left == 64, np.uint64(2**64 - 1),
                        (np.uint64(1) << left) - np.uint64(1))
        words.append(win[np.minimum(starts + w, len(win) - 1)] & mask)
    return np.stack(words, axis=1), rank


def _pair_columns(keys: np.ndarray, rank: np.ndarray, rname: np.ndarray,
                  rev: np.ndarray, pos: np.ndarray, qstart: np.ndarray,
                  qend: np.ndarray, mapq: np.ndarray, rlen: np.ndarray,
                  names: list[str]) -> tuple[Histogram, list[PairLink]]:
    """Pair mapped reads, given in arrival order as columns (`_mate_keys`'
    keys and ranks; rname indexes names), by mate key: the 1st and 2nd
    occurrence of a key pair, then the 3rd and 4th, and so on, each
    pair in the order its second read arrived.  The histogram holds the
    insert sizes of same-contig FR pairs, in the order the pairs would
    insert them one by one; FF/RR pairs are dropped, as are
    cross-contig pairs with a mapq of 0.  With tracing on it counts
    `fixmate.pairs` and `fixmate.links`."""
    n = len(keys)
    # a stable sort keeps each key's reads in arrival order
    order = np.lexsort(keys.T)
    g = keys[order]
    rows = np.arange(n)
    start = np.concatenate([[True], (g[1:] != g[:-1]).any(axis=1)])[:n]
    occ = rows - np.maximum.accumulate(np.where(start, rows, 0))
    later = np.flatnonzero(occ % 2 == 1)
    second, first = order[later], order[later - 1]
    by_arrival = np.argsort(second)
    second, first = second[by_arrival], first[by_arrival]
    # a1 is the mate whose name sorts first, the earlier on a tie
    swap = rank[first] > rank[second]
    r1 = np.where(swap, second, first)
    r2 = np.where(swap, first, second)
    same = rname[r1] == rname[r2]

    # fragment size from FR orientation (forward start to reverse end)
    fr = same & (rev[r1] != rev[r2])
    f = np.where(rev[r1] != 0, r2, r1)[fr]
    r = np.where(rev[r1] != 0, r1, r2)[fr]
    isize = (pos[r] + (qend[r] - qstart[r]) + qstart[r]) \
        - (pos[f] - qstart[f])
    hist = Histogram()
    vals, at, counts = np.unique(isize, return_index=True,
                                 return_counts=True)
    for o in np.argsort(at).tolist():
        hist.insert(int(vals[o]), int(counts[o]))

    # cross-contig links: read1 oriented to point right on u, read2 to
    # point left on v (a flipped contig starts at rlen - end)
    cross = ~same & (mapq[r1] != 0) & (mapq[r2] != 0)
    u, v = r1[cross], r2[cross]
    s1, s2 = rev[u] != 0, rev[v] == 0
    a1, a2 = qend[u] - qstart[u], qend[v] - qstart[v]
    p1 = np.where(s1, rlen[u] - (pos[u] + a1), pos[u])
    p2 = np.where(s2, rlen[v] - (pos[v] + a2), pos[v])
    label = np.array(names, dtype=object)
    links = list(map(PairLink, *(x.tolist() for x in (
        label[rname[u]], s1.astype(np.int64), label[rname[v]],
        s2.astype(np.int64), p1, a1, p2, a2, rlen[u], rlen[v]))))
    if trace.enabled():
        trace.count("fixmate.pairs", len(second))
        trace.count("fixmate.links", len(links))
    return hist, links
