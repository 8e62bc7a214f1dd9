"""Multi-sequence consensus for ambiguous path resolution.

The reference resolves ambiguous ("N-gap") path segments by collecting
up to `a` candidate sequences and computing a DIALIGN-TX multiple
alignment, then taking the column consensus
(MergePaths/PathConsensus.cpp:44-88, Align/dialign.{h,cpp}, dialign/).

This rebuild replaces the vendored DIALIGN-TX C code with a
center-star MSA: score all pairs (batched NW on device when the
candidate set is large), pick the sequence with the best total score
as the star, align every other sequence to it with full-traceback NW,
project the pairwise gaps into common coordinates, and majority-vote
each column.  Center-star is a 2-approximation of the optimal SP-score
MSA and matches the reference's *use* of dialign (consensus of a few
near-identical alternatives), while being expressible as a batch of
independent NW problems — the shape a device batches well.

Port of abyss_tpu/align/dialign.py: the same code, with the device of
the batched NW (`nw.nw_batch`) passed in.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core import alphabet
from .nw import nw_batch, nw_score_np

GAP = 255  # gap sentinel in aligned code rows


def nw_traceback(a: np.ndarray, b: np.ndarray, match: int = 1,
                 mismatch: int = -1, gap: int = -2,
                 free_ends: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Global NW alignment with traceback (host-side; the candidate
    sequences here are short gap fillers).  Returns the two rows of the
    pairwise alignment as uint8 code arrays with GAP sentinels.

    free_ends=True gives semi-global alignment (no end-gap penalty on b),
    like the reference's overlap consensus mode."""
    n, m = len(a), len(b)
    score = np.zeros((n + 1, m + 1), np.int32)
    score[:, 0] = np.arange(n + 1) * gap
    score[0, :] = 0 if free_ends else np.arange(m + 1) * gap
    sub = np.where(a[:, None] == b[None, :], match, mismatch)
    # Row recurrence: cur[j] = max(diag[j-1], prev[j]+gap, cur[j-1]+gap).
    # The cur[j-1]+gap term is a max-prefix-scan (see nw.nw_score_np), so
    # each row is pure vector ops; pointers are recomputed from the score
    # matrix during traceback (diag > up > left priority, matching the
    # original cell-by-cell argmax order).
    off = np.arange(m + 1) * (-gap)
    best = np.empty(m + 1, np.int32)
    for i in range(1, n + 1):
        prev = score[i - 1]
        best[0] = score[i, 0]
        np.maximum(prev[:-1] + sub[i - 1], prev[1:] + gap, out=best[1:])
        score[i] = np.maximum.accumulate(best + off) - off
    # traceback
    ra, rb = [], []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                score[i, j] == score[i - 1, j - 1] + sub[i - 1, j - 1]:
            p = 0
        elif i > 0 and score[i, j] == score[i - 1, j] + gap:
            p = 1
        else:
            p = 2
        if i > 0 and j > 0 and p == 0:
            ra.append(a[i - 1])
            rb.append(b[j - 1])
            i -= 1
            j -= 1
        elif i > 0 and (p == 1 or j == 0):
            ra.append(a[i - 1])
            rb.append(GAP)
            i -= 1
        else:
            ra.append(GAP)
            rb.append(b[j - 1])
            j -= 1
    return (np.array(ra[::-1], np.uint8), np.array(rb[::-1], np.uint8))


def _pair_scores(codes: list[np.ndarray], device="cuda") -> np.ndarray:
    """All-pairs NW scores.  Uses the batched NW on `device` when there
    are enough pairs to amortize a dispatch; numpy otherwise."""
    n = len(codes)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    scores = np.zeros((n, n), np.int32)
    if len(pairs) >= 16:
        la = max(len(codes[i]) for i, _ in pairs)
        lb = max(len(codes[j]) for _, j in pairs)
        a = np.full((len(pairs), la), alphabet.BAD, np.uint8)
        b = np.full((len(pairs), lb), alphabet.BAD, np.uint8)
        for p, (i, j) in enumerate(pairs):
            a[p, :len(codes[i])] = codes[i]
            b[p, :len(codes[j])] = codes[j]
        dev = resolve_device(device)
        s = nw_batch(torch.from_numpy(a).to(dev),
                     torch.from_numpy(b).to(dev)).cpu().numpy()
        for p, (i, j) in enumerate(pairs):
            scores[i, j] = scores[j, i] = s[p]
        return scores
    for i, j in pairs:
        s = nw_score_np(codes[i], codes[j])
        scores[i, j] = scores[j, i] = s
    return scores


def msa_consensus(seqs: list[str], min_identity: float = 0.0,
                  device="cuda") -> tuple[str | None, float]:
    """Center-star consensus of candidate sequences; the all-pairs
    scores of 7 or more sequences run on `device`.

    Returns (consensus, mean identity vs consensus); (None, 0.0) when
    the candidates are less than min_identity similar — the caller then
    leaves the gap ambiguous, like PathConsensus's identity gate
    (p >= 0.9, bin/abyss-pe:264).
    """
    seqs = [s for s in seqs if s]
    if not seqs:
        return None, 0.0
    if len(seqs) == 1:
        return seqs[0], 1.0
    codes = [alphabet.encode(s) for s in seqs]
    scores = _pair_scores(codes, device)
    star = int(np.argmax(scores.sum(axis=1)))
    center = codes[star]

    # align each sequence to the star; merge gap structures
    aligned_pairs = []
    for i, c in enumerate(codes):
        if i == star:
            continue
        ra, rb = nw_traceback(center, c)
        aligned_pairs.append((ra, rb))
    # project: master gap pattern = union of star-row gaps
    # walk all pairs simultaneously by star position
    rows = [[] for _ in range(len(aligned_pairs) + 1)]  # row 0 = star
    idx = [0] * len(aligned_pairs)
    for pos in range(len(center) + 1):
        # emit any insertions (gaps in star row) pending at this star pos
        while True:
            ins = [p for p, (ra, _) in enumerate(aligned_pairs)
                   if idx[p] < len(ra) and ra[idx[p]] == GAP]
            if not ins:
                break
            p0 = ins[0]
            rows[0].append(GAP)
            for p, (ra, rb) in enumerate(aligned_pairs):
                if p == p0:
                    rows[p + 1].append(rb[idx[p]])
                    idx[p] += 1
                else:
                    rows[p + 1].append(GAP)
        if pos == len(center):
            break
        rows[0].append(center[pos])
        for p, (ra, rb) in enumerate(aligned_pairs):
            rows[p + 1].append(rb[idx[p]])
            idx[p] += 1
    mat = np.array(rows, np.uint8)  # [nseq, L]

    # column majority vote over non-gap symbols
    cons = []
    for col in mat.T:
        vals, counts = np.unique(col[col != GAP], return_counts=True)
        if len(vals) == 0:
            continue
        base = vals[np.argmax(counts)]
        n_gap = int((col == GAP).sum())
        # a column that is mostly gaps is an insertion held by a
        # minority; drop it (dialign keeps only anchored columns)
        if n_gap > len(col) - n_gap:
            continue
        cons.append(base)
    cons = np.array(cons, np.uint8)
    consensus = alphabet.decode(cons)

    # identity of each candidate vs the consensus
    idents = []
    for c in codes:
        ra, rb = nw_traceback(cons, c)
        matches = int(((ra == rb) & (ra != GAP)).sum())
        idents.append(matches / max(len(ra), 1))
    ident = float(np.mean(idents))
    if ident < min_identity:
        return None, ident
    return consensus, ident
