"""abyss-mergepairs: overlap-merge paired-end reads.

Reimplements Align/mergepairs.cc: for each FR pair, find the best
suffix(read1)-prefix(rc-of-read2-as-fragment... i.e. read2 reverse
complemented) overlap; merge when the overlap is long enough and clean,
taking the higher-quality base at mismatches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import alphabet


@dataclass
class MergeStats:
    pairs: int = 0
    merged: int = 0
    no_overlap: int = 0
    too_many_mismatches: int = 0


def best_overlap(a: np.ndarray, b: np.ndarray, min_overlap: int,
                 max_mismatch_frac: float) -> tuple[int, int]:
    """Best (overlap_len, mismatches) of suffix(a) vs prefix(b); the
    longest acceptable overlap wins (mergepairs' scan)."""
    best = (0, 0)
    max_o = min(len(a), len(b))
    for o in range(max_o, min_overlap - 1, -1):
        mism = int((a[len(a) - o:] != b[:o]).sum())
        if mism <= max_mismatch_frac * o:
            return o, mism
    return best


def merge_pair(seq1: str, qual1: str | None, seq2: str, qual2: str | None,
               min_overlap: int = 10, max_mismatch_frac: float = 0.1,
               ) -> str | None:
    """Merge read1 with rc(read2); None if no acceptable overlap."""
    a = alphabet.encode(seq1)
    b = alphabet.encode(alphabet.revcomp(seq2))
    o, mism = best_overlap(a, b, min_overlap, max_mismatch_frac)
    if o == 0:
        return None
    qa = np.frombuffer((qual1 or "I" * len(seq1)).encode(), np.uint8)
    qb = np.frombuffer((qual2 or "I" * len(seq2)).encode(), np.uint8)[::-1]
    head = a[:len(a) - o]
    tail = b[o:]
    ov_a = a[len(a) - o:]
    ov_b = b[:o]
    q_a = qa[len(a) - o:]
    q_b = qb[:o]
    ov = np.where(q_a >= q_b, ov_a, ov_b)
    return alphabet.decode(np.concatenate([head, ov, tail]))


def merge_pairs(pairs, min_overlap: int = 10,
                max_mismatch_frac: float = 0.1,
                ) -> tuple[list[str | None], MergeStats]:
    """pairs: [(seq1, qual1, seq2, qual2)]."""
    stats = MergeStats()
    out = []
    for s1, q1, s2, q2 in pairs:
        stats.pairs += 1
        m = merge_pair(s1, q1, s2, q2, min_overlap, max_mismatch_frac)
        if m is None:
            stats.no_overlap += 1
        else:
            stats.merged += 1
        out.append(m)
    return out, stats
