"""DAssembler: greedy targeted micro-assembly around a seed read.

Reimplements DAssembler/DAssembler.cpp: starting from a
seed sequence, repeatedly extend by the best overlapping read (suffix of
the contig vs prefix of a read, considering both read orientations),
for localized/targeted assembly.
"""

from __future__ import annotations

import numpy as np

from ..core import alphabet


def _overlap_len(a: str, b: str, min_overlap: int,
                 max_mismatches: int) -> int:
    """Longest suffix(a)/prefix(b) overlap with few mismatches."""
    max_o = min(len(a), len(b) - 1)
    for o in range(max_o, min_overlap - 1, -1):
        mism = sum(1 for x, y in zip(a[-o:], b[:o]) if x != y)
        if mism <= max_mismatches:
            return o
    return 0


def extend_greedy(seed: str, reads: list[str], min_overlap: int = 30,
                  max_mismatches: int = 1, max_length: int = 100000,
                  ) -> str:
    """Greedily extend the seed rightwards with best-overlapping reads."""
    pool = []
    for r in reads:
        pool.append(r)
        pool.append(alphabet.revcomp(r))
    # seed index on min_overlap-length prefixes for speed
    index: dict[str, list[int]] = {}
    for i, r in enumerate(pool):
        if len(r) >= min_overlap:
            index.setdefault(r[:min_overlap], []).append(i)

    contig = seed
    used = set()
    while len(contig) < max_length:
        best_gain, best_read, best_o = 0, None, 0
        # candidate reads whose prefix seed matches a contig suffix seed
        tail = contig[-(min_overlap + 40):]
        cands = set()
        for s in range(max(0, len(tail) - min_overlap + 1)):
            for i in index.get(tail[s:s + min_overlap], ()):
                cands.add(i)
        for i in cands:
            if i in used:
                continue
            r = pool[i]
            o = _overlap_len(contig, r, min_overlap, max_mismatches)
            gain = len(r) - o
            if o and gain > best_gain:
                best_gain, best_read, best_o = gain, i, o
        if best_read is None:
            break
        contig += pool[best_read][best_o:]
        used.add(best_read)
    return contig


def assemble_region(seed: str, reads: list[str], **kw) -> str:
    """Extend the seed both directions (right, then left via rc)."""
    right = extend_greedy(seed, reads, **kw)
    both = extend_greedy(alphabet.revcomp(right), reads, **kw)
    return alphabet.revcomp(both)
