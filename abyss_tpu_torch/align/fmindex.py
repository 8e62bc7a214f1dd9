"""FM-index: BWT-based substring index.

Port of abyss_tpu/align/fmindex.py.  Reimplements the role of
FMIndex/ (FMIndex.h:20-45, sais.hxx suffix array, BitArrays.h
occurrence tables, sampled SA) used by abyss-index / abyss-map /
abyss-count / abyss-overlap.

Device build: the suffix array comes from prefix doubling with DEVICE
sorts -- each round packs (rank, successor-rank) into one 64-bit key and
runs a single `torch.sort`, so the O(n log n) rounds run at memory
bandwidth (the reference links sais.hxx, an induced sort: a sequential
pointer chase).  Small inputs build on host numpy to skip dispatch
overhead.

Memory (the round-4 advisor note): the occurrence table is checkpointed
every OCC_BLOCK positions (int32 ranks) with the in-block remainder
counted from the BWT on query — ~0.4 B/base instead of round-4's 40
B/base dense table — and SA samples are stored densely behind a packed
sample bitmask (+ rank checkpoints), ~1.3 B/base at the default rate.
The production read mapper remains the k-mer seed index
(align/mapper.py); the FM-index serves the substring/count/overlap
toolchain (abyss-count, abyss-dawg, abyss-overlap).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device

SENTINEL = 0  # '$' < all codes; stored text uses codes+1 internally
OCC_BLOCK = 64
_DEVICE_MIN = 1 << 20   # build on device above ~1M bases


def _suffix_array_host(text: np.ndarray) -> np.ndarray:
    """Prefix doubling with numpy sorts (small inputs)."""
    n = len(text)
    rank = text.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    tmp = np.empty(n, np.int64)
    k = 1
    while k < n:
        key2 = np.full(n, -1, np.int64)
        key2[:n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        tmp[order[0]] = 0
        prev = order[:-1]
        cur = order[1:]
        newgrp = (rank[cur] != rank[prev]) | (key2[cur] != key2[prev])
        tmp[cur] = np.cumsum(newgrp)
        rank = tmp.copy()
        sa = order
        if rank[sa[-1]] == n - 1:
            break
        k *= 2
    return sa


def _doubling_round(rank: torch.Tensor, k: int):
    """One prefix-doubling round: one sort of the packed (rank << 32 |
    successor rank + 1) keys, then the new ranks by a scan.  Returns
    (new ranks, order, whether every rank is now distinct)."""
    n = rank.shape[0]
    succ = torch.cat([rank[k:], rank.new_zeros(min(k, n))])[:n] + 1
    # rank < n < 2^31, so the signed order of the keys is the unsigned one
    key = (rank << 32) | succ
    # unstable: ties get equal new ranks whatever their order, and the
    # last round's keys are distinct
    ks, order = torch.sort(key)
    newgrp = torch.cat([ks.new_zeros(1), (ks[1:] != ks[:-1]).long()])
    ranks_sorted = torch.cumsum(newgrp, dim=0)
    new_rank = torch.empty_like(ranks_sorted).scatter_(0, order,
                                                       ranks_sorted)
    return new_rank, order, ranks_sorted[-1] == n - 1


def _suffix_array_device(text: np.ndarray, device="cuda") -> np.ndarray:
    """Prefix doubling with device sorts: each round is one sort of
    packed keys plus a scan (`_doubling_round`), on `device`.

    The text must end with a unique smallest symbol (FMIndex.build
    appends SENTINEL): "no successor" packs as successor rank 0 + 1,
    the key of a real successor of rank 0, and only that sentinel keeps
    the two apart."""
    n = len(text)
    assert n and int(text[-1]) == int(text.min()) and \
        int(np.count_nonzero(text == text[-1])) == 1, \
        "suffix array text must end with a unique smallest sentinel"
    rank = torch.from_numpy(np.ascontiguousarray(text, np.int64)).to(
        resolve_device(device))
    order = None
    k = 1
    while k < n:
        rank, order, done = _doubling_round(rank, k)
        if bool(done):
            break
        k *= 2
    if order is None:   # n == 1
        return np.zeros(1, np.int64)
    return order.cpu().numpy().astype(np.int64)


def suffix_array(text: np.ndarray, device="cuda") -> np.ndarray:
    """Suffix array of `text` (int codes; caller appends the sentinel),
    built on `device` from _DEVICE_MIN symbols on, on the host below."""
    if len(text) >= _DEVICE_MIN:
        return _suffix_array_device(text, device)
    return _suffix_array_host(text)


@dataclass
class FMIndex:
    bwt: np.ndarray        # uint8[n] (values 0..4; 0 = sentinel)
    C: np.ndarray          # int64[6] cumulative symbol starts
    occ_ck: np.ndarray     # int32[n//B + 1, 5] block-start counts
    sa_vals: np.ndarray    # int64[n_sampled] dense sampled SA values
    sa_mask: np.ndarray    # bool[n] position i is sampled
    sa_rank: np.ndarray    # int32[n//B + 1] sampled-count checkpoints
    sa_rate: int
    n: int

    @staticmethod
    def build(codes: np.ndarray, sa_rate: int = 8,
              device="cuda") -> "FMIndex":
        """codes: uint8 array of base codes (0..3).  The suffix array is
        sorted on `device` (raises without a card unless "cpu")."""
        resolve_device(device)
        text = codes.astype(np.int64) + 1
        text = np.concatenate([text, [SENTINEL]])
        n = len(text)
        sa = suffix_array(text, device)
        bwt = text[(sa - 1) % n].astype(np.uint8)
        counts = np.bincount(text, minlength=6)
        C = np.zeros(6, np.int64)
        C[1:] = np.cumsum(counts)[:-1]
        # checkpointed occurrences: counts of each symbol BEFORE each
        # block start (BitArrays.h's rank structure, block-rank form)
        nb = n // OCC_BLOCK + 1
        occ_ck = np.zeros((nb, 5), np.int32)
        for s in range(5):
            hits = (bwt == s)
            block_sums = np.add.reduceat(
                hits, np.arange(0, n, OCC_BLOCK))
            occ_ck[1:, s] = np.cumsum(block_sums)[:nb - 1]
        keep = sa % sa_rate == 0
        sa_vals = sa[keep]
        sa_rank = np.zeros(nb, np.int32)
        ksums = np.add.reduceat(keep, np.arange(0, n, OCC_BLOCK))
        sa_rank[1:] = np.cumsum(ksums)[:nb - 1]
        return FMIndex(bwt=bwt, C=C, occ_ck=occ_ck, sa_vals=sa_vals,
                       sa_mask=keep, sa_rank=sa_rank,
                       sa_rate=sa_rate, n=n)

    def occ(self, i: int, c: int) -> int:
        """Occurrences of symbol c in bwt[:i]."""
        b, r = divmod(i, OCC_BLOCK)
        base = int(self.occ_ck[b, c])
        if r:
            base += int(np.count_nonzero(
                self.bwt[b * OCC_BLOCK:b * OCC_BLOCK + r] == c))
        return base

    def backward_search(self, pattern: np.ndarray) -> tuple[int, int]:
        """SA interval [lo, hi) of the pattern (codes 0..3)."""
        lo, hi = 0, self.n
        for c in pattern[::-1].astype(np.int64) + 1:
            c = int(c)
            lo = int(self.C[c]) + self.occ(lo, c)
            hi = int(self.C[c]) + self.occ(hi, c)
            if lo >= hi:
                return 0, 0
        return int(lo), int(hi)

    def count(self, pattern: np.ndarray) -> int:
        lo, hi = self.backward_search(pattern)
        return hi - lo

    def _sa_at(self, i: int) -> int:
        steps = 0
        while not self.sa_mask[i]:
            c = int(self.bwt[i])
            i = int(self.C[c]) + self.occ(i, c)
            steps += 1
        b = i // OCC_BLOCK
        r = int(self.sa_rank[b]) + int(np.count_nonzero(
            self.sa_mask[b * OCC_BLOCK:i]))
        return int((self.sa_vals[r] + steps) % self.n)

    def locate(self, pattern: np.ndarray, limit: int = 100) -> list[int]:
        lo, hi = self.backward_search(pattern)
        return sorted(self._sa_at(i) for i in range(lo, min(hi, lo + limit)))
