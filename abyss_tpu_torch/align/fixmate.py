"""Mate pairing: join per-read alignments into fragment records.

The role of abyss-fixmate (ParseAligns/abyss-fixmate.cc):
pair up the two reads of each fragment, emit
  * the fragment-size histogram (.hist) from same-contig FR pairs
    (g_histogram.insert, abyss-fixmate.cc:165), and
  * cross-contig pair links that feed DistanceEst.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from ..core.histogram import Histogram
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


def _mate_key(qname: str) -> str:
    """Strip /1 /2 suffixes (SAM-style mate naming)."""
    if len(qname) > 2 and qname[-2] == "/" and qname[-1] in "12":
        return qname[:-2]
    return qname


def _oriented(a: Alignment, want_forward: bool) -> tuple[int, int, int]:
    """(sense, start, alen) of the alignment on the contig oriented so the
    read points right (want_forward) or left (not want_forward)."""
    alen = a.qend - a.qstart
    if a.rev != (not want_forward):
        # flip the contig
        sense = 1
        start = a.rlen - (a.pos + alen)
    else:
        sense = 0
        start = a.pos
    return sense, start, alen


def fixmate(alignments: Iterable[Alignment | None],
            ) -> tuple[Histogram, list[PairLink]]:
    """Pair alignments by mate key.  Returns the fragment-size histogram
    (same-contig FR pairs) and cross-contig PairLinks."""
    hist = Histogram()
    pending: dict[str, Alignment] = {}
    links: list[PairLink] = []
    for a in alignments:
        if a is None:
            continue
        key = _mate_key(a.qname)
        m = pending.pop(key, None)
        if m is None:
            pending[key] = a
            continue
        a1, a2 = (m, a) if m.qname <= a.qname else (a, m)
        if a1.rname == a2.rname:
            # fragment size from FR orientation (forward start to reverse end)
            if a1.rev == a2.rev:
                continue  # FF/RR pair: inconsistent, drop
            fwd, rev = (a1, a2) if not a1.rev else (a2, a1)
            isize = (rev.pos + (rev.qend - rev.qstart) + rev.qstart) \
                - (fwd.pos - fwd.qstart)
            hist.insert(isize)
        else:
            if a1.mapq == 0 or a2.mapq == 0:
                continue
            s1, p1, l1 = _oriented(a1, want_forward=True)
            s2, p2, l2 = _oriented(a2, want_forward=False)
            links.append(PairLink(
                u_name=a1.rname, u_sense=s1, v_name=a2.rname, v_sense=s2,
                p1=p1, a1=l1, p2=p2, a2=l2,
                u_len=a1.rlen, v_len=a2.rlen))
    return hist, links
