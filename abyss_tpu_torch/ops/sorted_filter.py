"""Sorted-table k-mer counter: the scatter-free counting structure.

Port of abyss_tpu/ops/sorted_filter.py.  Canonical hashes are collected,
sorted and run-length encoded; count/contains queries are answered with
an unsigned `searchsorted` plus one gather, or, for large query
batches, with the sort joins of ops/sort_join.  Exact up to 64-bit hash
collisions.  Keys are int64 tensors holding uint64 bit patterns; every
sort and search here is unsigned (u64.py), and the all-ones padding
sentinel (-1) sorts last.
"""

from __future__ import annotations

import torch

from .. import u64
from .scan import running_max, running_min
from .sort_join import (join_counts, join_counts_packed, join_solid_packed,
                        pack_table, solid_prefixes)

COUNTER_MAX = 32767  # COVERAGE_MAX, Assembly/VertexData.h:33
# bulk queries at or above this many switch from the 40-bit packed
# probe to the exact join (the packed words carry a 23-bit index)
PACKED_MAX_QUERIES = 1 << 23


def _pad_pow2(x: torch.Tensor, fill: int = u64.ALL_ONES) -> torch.Tensor:
    """Pad dim 0 up to the next power of two with `fill` (the all-ones
    key sentinel by default).  Kept from the JAX package, whose compiled
    programs were per power-of-two bucket: the pads are sentinels that
    every merge drops, so the counts do not depend on them."""
    n = x.shape[0]
    m = 1 << max(int(n - 1).bit_length(), 0)
    if m == n:
        return x
    return torch.cat([x, torch.full((m - n,), fill, dtype=x.dtype,
                                    device=x.device)])


class SortedKmerFilter:
    """Sorted k-mer count table.

    kmers: int64[N] unique canonical hashes in unsigned order;
    counts: int32[N]; packed: the (prefix | count) words of the packed
    probe (ops/sort_join.pack_table), or None."""

    def __init__(self, kmers: torch.Tensor, counts: torch.Tensor,
                 packed: torch.Tensor | None = None, k: int = 0,
                 threshold: int = 2, num_hashes: int = 1):
        self.kmers = kmers
        self.counts = counts
        self.packed = packed
        self.k = k
        self.threshold = threshold
        self.num_hashes = num_hashes  # API compatibility only
        # exact membership table of the solid keys for the walk loops,
        # built on first use by ops/hash_probe.solid_table
        self.solid_tab: torch.Tensor | None = None
        # the packed table's sort_join.solid_prefixes, built on the
        # first packed contains_bulk (the classify rounds' solid bit)
        self.solid_prefixes: torch.Tensor | None = None

    @property
    def n(self) -> int:
        return int(self.kmers.shape[0])

    @property
    def device(self) -> torch.device:
        return self.kmers.device

    def count(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        """Count per query ([...] int32); absent or masked -> 0."""
        if not self.n:
            return torch.zeros(canon.shape, dtype=torch.int32,
                               device=canon.device)
        idx = u64.usearchsorted(self.kmers, canon.reshape(-1))
        idx = torch.clamp(idx, max=self.n - 1).reshape(canon.shape)
        hit = self.kmers[idx] == canon
        c = torch.where(hit, self.counts[idx], 0)
        if mask is not None:
            c = torch.where(mask, c, 0)
        return c

    def contains(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        return self.count(canon, mask) >= self.threshold

    def count_bulk(self, canon: torch.Tensor, mask=None,
                   exact: bool = False) -> torch.Tensor:
        """Bulk count via a sort join: the packed 40-bit prefix probe
        (false-join odds ~N*M/2^40 per batch) below 2^23 queries, else,
        or with exact=True, the full-64-bit join."""
        flat = canon.reshape(-1)
        if exact or self.packed is None or \
                flat.shape[0] >= PACKED_MAX_QUERIES:
            c = join_counts(self.kmers, self.counts, flat)
        else:
            c = join_counts_packed(self.packed, flat)
        c = c.reshape(canon.shape)
        if mask is not None:
            c = torch.where(mask, c, 0)
        return c

    def contains_bulk(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        """Bulk solidity: the packed probe's solid-bit finish when
        available (the classify hot path needs only the bit)."""
        flat = canon.reshape(-1)
        if self.packed is None or flat.shape[0] >= PACKED_MAX_QUERIES:
            return self.count_bulk(canon, mask) >= self.threshold
        if self.solid_prefixes is None:
            self.solid_prefixes = solid_prefixes(self.packed, self.threshold)
        hit = join_solid_packed(self.packed, flat, self.threshold,
                                self.solid_prefixes).reshape(canon.shape)
        if mask is not None:
            hit = hit & mask
        return hit


def _sort_rle(canon: torch.Tensor):
    """Sorted unique values + counts of a hash array: (keys, counts)
    with a key and its run length at each run start, the sentinel
    elsewhere."""
    s, _ = u64.usort(canon)
    n = s.shape[0]
    dev = s.device
    one = torch.ones(1, dtype=torch.bool, device=dev)
    start = torch.cat([one, s[1:] != s[:-1]])
    last = torch.cat([s[:-1] != s[1:], one])
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    # end position of each run, propagated backward to every element
    end_pos = running_min(torch.where(last, pos, n), reverse=True)
    counts = torch.where(start, end_pos - pos + 1, 0)
    keys = torch.where(start, s, u64.ALL_ONES)
    return keys, counts


def _merge_pairs(keys: torch.Tensor, counts: torch.Tensor):
    """Merge (possibly duplicated-key) pairs into compacted (keys,
    totals, n_real): per-key totals from the cumsum differenced against
    the forward-filled cumsum at the previous run's end."""
    ks, order = u64.usort(keys)
    cs = counts.to(torch.int64)[order]
    dev = ks.device
    csum = torch.cumsum(cs, dim=0)
    last = torch.cat([ks[:-1] != ks[1:],
                      torch.ones(1, dtype=torch.bool, device=dev)])
    ends = torch.where(last, csum, 0)
    # csum is nondecreasing, so a running max fills forward correctly
    prev = running_max(torch.cat([torch.zeros(1, dtype=torch.int64,
                                              device=dev), ends[:-1]]))
    totals = csum - prev
    keep = last & (ks != u64.ALL_ONES)
    outk = torch.where(keep, ks, u64.ALL_ONES)
    outc = torch.where(keep, totals, 0)
    # compact: non-lasts and sentinels to the end, key order kept
    outk, order = u64.usort(outk)
    return outk, outc[order], keep.sum()


def _split_singles(keys: torch.Tensor, counts: torch.Tensor):
    """Separate count-1 keys (for the stash) from multi-count keys,
    each compacted by one sort."""
    single = counts == 1
    multi = counts >= 2
    sk, _ = u64.usort(torch.where(single, keys, u64.ALL_ONES))
    mk, order = u64.usort(torch.where(multi, keys, u64.ALL_ONES))
    mc = torch.where(multi, counts, 0)[order]
    return sk, single.sum(), mk, mc, multi.sum()


class SortedKmerCounter:
    """Streaming builder: accumulates canonical-hash chunks and counts
    them with device sorts (no scatter anywhere).

    Chunks are pre-reduced (sort + RLE) as they arrive, then merged into
    one running table, keeping peak memory near the reduced size.
    Keys seen once in a reduce window go to a singleton stash instead of
    the running merge, and are resolved exactly at finalize (a key
    stashed in two windows sums there)."""

    def __init__(self, k: int, threshold: int = 2,
                 reduce_every: int = 12 << 20):
        self.k = k
        self.threshold = threshold
        self._hash_chunks: list[torch.Tensor] = []
        self._merged = None  # (keys, counts, n) running table
        self._pending = 0
        self._reduce_every = reduce_every
        self._singles: list[torch.Tensor] = []
        self._n_singles = 0

    def add(self, canon: torch.Tensor, mask=None):
        canon = canon.reshape(-1)
        if mask is not None:
            canon = torch.where(mask.reshape(-1), canon, u64.ALL_ONES)
        self._hash_chunks.append(canon)
        self._pending += canon.shape[0]
        if self._pending >= self._reduce_every:
            self._reduce()

    def _fold(self, keys: torch.Tensor, counts: torch.Tensor):
        """Merge compacted (keys, counts) into the running table."""
        counts = counts.to(torch.int64)
        if self._merged is not None:
            k0, c0, _ = self._merged
            keys = _pad_pow2(torch.cat([k0, keys]))
            counts = _pad_pow2(torch.cat([c0.to(torch.int64), counts]), 0)
        keys, counts, n_real = _merge_pairs(keys, counts)
        n = int(n_real)  # one scalar to the host per fold
        m = min(1 << max(int(n - 1).bit_length(), 0), keys.shape[0])
        self._merged = (keys[:m],
                        torch.clamp(counts[:m], max=COUNTER_MAX).to(
                            torch.int32), n)

    def _reduce(self, stash: bool = True):
        """Fold pending hash chunks into the running table; window
        singletons go to the stash (stash=True)."""
        if not self._hash_chunks:
            return
        parts = self._hash_chunks
        self._hash_chunks = []
        self._pending = 0
        allh = _pad_pow2(torch.cat(parts) if len(parts) > 1 else parts[0])
        keys, counts = _sort_rle(allh)
        del allh
        if stash:
            sk, n_s, keys, counts, _ = _split_singles(keys, counts)
            ns = int(n_s)
            if ns:
                sb = 1 << max(int(ns - 1).bit_length(), 0)
                self._singles.append(sk[:min(sb, sk.shape[0])])
                self._n_singles += ns
        self._fold(keys, counts)

    def _fold_stash(self):
        """Resolve the singleton stash: sort+RLE it in bounded groups
        and merge each into the running table (exact)."""
        singles, self._singles, self._n_singles = self._singles, [], 0
        group: list[torch.Tensor] = []
        size = 0
        for arr in singles + [None]:
            if arr is not None:
                group.append(arr)
                size += arr.shape[0]
            if (arr is None or size >= self._reduce_every) and group:
                allh = _pad_pow2(torch.cat(group) if len(group) > 1
                                 else group[0])
                keys, counts = _sort_rle(allh)
                del allh
                self._fold(keys, counts)
                group, size = [], 0

    def finalize(self, device=None) -> SortedKmerFilter:
        """The finished filter.  `device` places an empty filter (no
        k-mer was added); otherwise the filter lives where the hashes
        did."""
        self._reduce()
        self._fold_stash()
        if self._merged is None:
            return SortedKmerFilter(
                kmers=torch.zeros(0, dtype=torch.int64, device=device),
                counts=torch.zeros(0, dtype=torch.int32, device=device),
                k=self.k, threshold=self.threshold)
        keys, counts, n = self._merged
        self._merged = None
        kmers = keys[:n]
        counts = counts[:n]
        return SortedKmerFilter(
            kmers=kmers, counts=counts, packed=pack_table(kmers, counts),
            k=self.k, threshold=self.threshold)

