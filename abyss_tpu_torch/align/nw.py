"""Global alignment (Needleman-Wunsch), batched for the device.

Port of abyss_tpu/align/nw.py.  The reference's Align/alignGlobal.{h,cc}
serves PopBubbles' branch identity check and PathConsensus.  The host
numpy variants (`nw_score_np`, `align_global`, `nw_identity_np`) are
copies; `nw_batch` scores many pairs at once in torch ops on their
device, one DP row at a time over the rows of A, each row's left-gap
recurrence resolved by a running maximum (`torch.cummax`) instead of a
scan over the columns of B.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import alphabet


def nw_score_np(a: np.ndarray, b: np.ndarray, match: int = 1,
                mismatch: int = -1, gap: int = -2) -> int:
    """Host NW score between two code arrays (no traceback)."""
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1) * gap
    off = np.arange(lb + 1) * (-gap)  # gap < 0: -gap > 0
    for i in range(1, la + 1):
        sub = prev[:-1] + np.where(b == a[i - 1], match, mismatch)
        # cur[j] = max(sub[j-1], prev[j]+gap, cur[j-1]+gap) is a
        # max-prefix-scan in disguise: with best[j] = the non-gap-row
        # candidate, cur[j] = max_{m<=j}(best[m] + (j-m)*gap)
        #            = maximum.accumulate(best - j*gap)[j] + j*gap.
        best = np.empty(lb + 1, prev.dtype)
        best[0] = i * gap
        np.maximum(sub, prev[1:] + gap, out=best[1:])
        prev = np.maximum.accumulate(best + off) - off
    return int(prev[lb])


def align_global(sa: str, sb: str, match: int = 1, mismatch: int = -1,
                 gap: int = -2) -> tuple[str, str, int]:
    """Host NW with traceback (alignGlobal.h's NWAlignment): returns
    the two gapped alignment strings and the score.  For short
    sequences (konnector alternate-path consensus, PathConsensus)."""
    la, lb = len(sa), len(sb)
    D = np.zeros((la + 1, lb + 1), np.int32)
    D[:, 0] = np.arange(la + 1) * gap
    D[0, :] = np.arange(lb + 1) * gap
    a = np.frombuffer(sa.encode(), np.uint8)
    b = np.frombuffer(sb.encode(), np.uint8)
    for i in range(1, la + 1):
        sub = D[i - 1, :-1] + np.where(b == a[i - 1], match, mismatch)
        up = D[i - 1, 1:] + gap
        best = np.maximum(sub, up)
        # left moves resolved by a max-prefix scan (cf. nw_score_np)
        off = np.arange(lb + 1) * (-gap)
        row = np.empty(lb + 1, np.int32)
        row[0] = i * gap
        row[1:] = best
        D[i] = np.maximum.accumulate(row + off) - off
    # traceback
    i, j = la, lb
    oa, ob = [], []
    while i > 0 or j > 0:
        if i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] + (
                match if sa[i - 1] == sb[j - 1] else mismatch):
            oa.append(sa[i - 1])
            ob.append(sb[j - 1])
            i -= 1
            j -= 1
        elif i > 0 and D[i, j] == D[i - 1, j] + gap:
            oa.append(sa[i - 1])
            ob.append("-")
            i -= 1
        else:
            oa.append("-")
            ob.append(sb[j - 1])
            j -= 1
    return "".join(reversed(oa)), "".join(reversed(ob)), int(D[la, lb])


def nw_identity_np(sa: str, sb: str) -> float:
    """Fraction of matched positions in a global alignment — the
    PopBubbles identity criterion (PopBubbles.cpp, p >= 0.9 default).

    Computed from the NW score with unit match and zero mismatch/gap
    scores: score == number of matches in the best alignment.
    """
    a, b = alphabet.encode(sa), alphabet.encode(sb)
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0
    prev = np.zeros(lb + 1, np.int32)
    for i in range(1, la + 1):
        # cur[j] = max(prev[j-1]+eq[j-1], prev[j], cur[j-1]): with zero
        # gap cost the cur[j-1] term is a plain running max.
        cur = np.empty(lb + 1, np.int32)
        cur[0] = 0
        eq = (b == a[i - 1]).astype(np.int32)
        np.maximum(prev[:-1] + eq, prev[1:], out=cur[1:])
        prev = np.maximum.accumulate(cur)
    matches = int(prev[lb])
    return matches / max(la, lb)


def nw_batch(a_codes: torch.Tensor, b_codes: torch.Tensor, match: int = 1,
             mismatch: int = -1, gap: int = -2) -> torch.Tensor:
    """Batched NW scores on the inputs' device.

    a_codes: uint8[N, LA]; b_codes: uint8[N, LB] (BAD-padded).  Padding
    is treated as mismatch-free gap-through: a padded base of A or B
    scores 0 against anything, a padded row of A costs no gap from
    above, and a padded column of B costs no gap in row 0 (the left-gap
    move always costs `gap`, as in the JAX package).  Scores are exact
    for the unpadded lengths if callers slice, or a good identity proxy.

    Returns int32[N] scores over the full padded lengths.

    Row i of the DP table is cur[j] = max(best[j-1], cur[j-1] + gap)
    for j >= 1, cur[0] = first, where best holds the diagonal and upward
    moves.  Unrolled, cur[j] = max over m <= j of v[m] + (j - m) * gap
    with v = [first, best...], so cur = cummax(v - j*gap) + j*gap: one
    running maximum per row instead of a scan over LB (nw_score_np's
    identity)."""
    a = a_codes.to(torch.int32)
    b = b_codes.to(torch.int32)
    N, LA = a.shape
    LB = b.shape[1]
    dev = a.device
    b_ok = b < 4
    jg = torch.arange(LB + 1, dtype=torch.int32, device=dev) * gap
    zero = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    prev = torch.cat([zero, torch.cumsum(torch.where(b_ok, gap, 0), dim=1,
                                         dtype=torch.int32)], dim=1)
    for i in range(LA):
        ai = a[:, i:i + 1]                                  # [N, 1]
        a_ok = ai < 4
        valid = b_ok & a_ok
        sub_sc = torch.where(valid, torch.where(b == ai, match, mismatch),
                             0)
        down = torch.where(a_ok, gap, 0)                    # [N, 1]
        best = torch.maximum(prev[:, :-1] + sub_sc, prev[:, 1:] + down)
        v = torch.cat([prev[:, :1] + down, best], dim=1)    # [N, LB + 1]
        prev = torch.cummax(v - jg, dim=1).values + jg
    return prev[:, -1].to(torch.int32)


def identity_check_factory(seqs: dict[str, str], names: list[str],
                           min_identity: float = 0.9):
    """Returns a branch-identity predicate for pop_bubbles: branches must
    be pairwise >= min_identity similar (PopBubbles.cpp p option)."""
    def check(branch_vertices):
        from ..graph.contig_graph import contig_id, sense as vsense
        texts = []
        for v in branch_vertices:
            s = seqs[names[v >> 1]]
            texts.append(s if (v & 1) == 0 else alphabet.revcomp(s))
        for i in range(len(texts)):
            for j in range(i + 1, len(texts)):
                if nw_identity_np(texts[i], texts[j]) < min_identity:
                    return False
        return True
    return check
