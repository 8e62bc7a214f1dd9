"""Bloom filters as device-resident tensors.

Port of abyss_tpu/ops/bloom.py.  The reference keeps two filters for
Bloom-mode assembly (BloomDBG/bloom-dbg.cc:359-369):

  * a **counting Bloom filter** over k-mers (8-bit counters) updated
    with a *conservative* increment: an insert raises only the counters
    below the key's new count;
  * a plain **bit Bloom filter** of "assembled" (visited) k-mers.

The conservative increment has a closed form under batching: inserting
the same key c times in a row gives
`counter_i = max(counter_i, min_j(counter_j) + c)`.  So a batch insert
sorts the canonical hashes, run-length encodes duplicates, gathers each
unique key's H counters, and scatter-maxes the saturated targets.  The
write side is ops/scatter_max.scatter_max_u8 (the CUDA kernel
csrc/scatter_max.cu on the card) in update modes "scatter" and
"pallas", which the JAX package holds bit-identical; "sort" is the
merge of ops/sort_join.  `contains` = min over the H counters >=
threshold.

Filter sizes are powers of two, so indexing is a mask of the 64-bit
hash instead of a modulo.  Arrays keep one byte per counter or bit,
with a trailing sink slot (`size`) that masked lanes point at and that
is cleared after every insert.

PyTorch idiom: inserts update the filter's tensor in place and return
the filter (the JAX package returns a new one): the counting filter is
a GiB at the reference's E. coli budget, and a copy per batch would
double pass 1's traffic.  `union` and `intersect` return new filters.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device, u64
from . import nthash
from .scan import running_min
from .scatter_max import scatter_max_u8
from .sort_join import dense_gather_u8, dense_scatter_max_u8

COUNTER_MAX = 255  # uint8 saturation (CountingBloomFilter.hpp counter type)
UPDATE_MODES = ("scatter", "sort", "pallas")


def _sorted_run_lengths(canon: torch.Tensor, mask=None):
    """Sort + run-length-encode a hash batch.

    Returns (sorted values, run length at each run start, start mask);
    masked lanes go to the all-ones sentinel, which the start mask
    excludes."""
    canon = canon.reshape(-1)
    if mask is not None:
        canon = torch.where(mask.reshape(-1), canon, u64.ALL_ONES)
    s, _ = u64.usort(canon)
    n = s.shape[0]
    dev = s.device
    one = torch.ones(1, dtype=torch.bool, device=dev)
    start = torch.cat([one, s[1:] != s[:-1]])
    last = torch.cat([s[:-1] != s[1:], one])
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    end_pos = running_min(torch.where(last, pos, n), reverse=True)
    counts = torch.where(start, end_pos - pos + 1, 0)
    valid = start
    if mask is not None:
        valid = valid & (s != u64.ALL_ONES)
    return s, counts, valid


def _check_pow2(size: int) -> int:
    if size & (size - 1) or size <= 0:
        raise ValueError(f"filter size must be a power of two, got {size}")
    if size > (1 << 31):
        raise ValueError("filter size must fit int32 indexing (<= 2^31)")
    return size


def _hash_indices(canon: torch.Tensor, k: int, num_hashes: int, size: int,
                  mask=None) -> torch.Tensor:
    """[..., H] int64 filter indices of each key; masked lanes -> the
    sink slot `size`."""
    idx = nthash.multi_hashes(canon, k, num_hashes) & (size - 1)
    if mask is not None:
        idx = torch.where(mask[..., None], idx, size)
    return idx


class CountingBloomFilter:
    """Counting Bloom filter state.

    counters: uint8[size + 1], the last slot the masked-write sink.
    update_mode: "scatter" (gather + scatter-max), "sort" (the merges of
    ops/sort_join) or "pallas" (the JAX package's binned Pallas kernel;
    here the same scatter-max as "scatter").  All three give the same
    counters."""

    def __init__(self, counters: torch.Tensor, k: int = 0,
                 num_hashes: int = 4, threshold: int = 2,
                 update_mode: str = "scatter"):
        if update_mode not in UPDATE_MODES:
            raise ValueError(f"update_mode must be one of {UPDATE_MODES}, "
                             f"got {update_mode!r}")
        self.counters = counters
        self.k = k
        self.num_hashes = num_hashes
        self.threshold = threshold
        self.update_mode = update_mode

    @property
    def size(self) -> int:
        return self.counters.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.counters.device

    @staticmethod
    def create(size: int, k: int, num_hashes: int = 4, threshold: int = 2,
               device="cuda") -> "CountingBloomFilter":
        _check_pow2(size)
        return CountingBloomFilter(
            counters=torch.zeros(size + 1, dtype=torch.uint8,
                                 device=resolve_device(device)),
            k=k, num_hashes=num_hashes, threshold=threshold)

    def _indices(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        return _hash_indices(canon, self.k, self.num_hashes, self.size, mask)

    def insert_counts(self, canon: torch.Tensor, counts: torch.Tensor,
                      mask=None) -> "CountingBloomFilter":
        """Conservatively add `counts[j]` occurrences of each distinct
        k-mer, in place; returns self.

        canon: [N] int64 canonical hashes (unique within the batch for
        exact conservative semantics; duplicates still give a valid
        conservative underestimate).  counts: [N] int.  mask: [N] bool."""
        idx = self._indices(canon, mask)                      # [N, H]
        flat = idx.reshape(-1)
        if self.update_mode == "sort":
            cur = dense_gather_u8(self.counters, flat).reshape(idx.shape)
        else:
            cur = self.counters[idx]
        lo = cur.amin(dim=-1).to(torch.int32)
        tgt = torch.clamp(lo + counts.to(torch.int32), max=COUNTER_MAX)
        tgt8 = tgt.to(torch.uint8)[..., None].expand(idx.shape).reshape(-1)
        if self.update_mode == "sort":
            self.counters = dense_scatter_max_u8(self.counters, flat, tgt8)
        else:
            scatter_max_u8(self.counters, flat, tgt8)
        self.counters[self.size] = 0
        return self

    def insert(self, canon: torch.Tensor, mask=None) -> "CountingBloomFilter":
        """Insert a batch of k-mer hashes (duplicates allowed), in place.

        Sorts + run-length-encodes the batch so duplicate k-mers within
        the batch accumulate their full multiplicity, then applies one
        conservative batched update.  Deterministic and independent of
        the order within the batch."""
        s, run_len, valid = _sorted_run_lengths(canon, mask)
        return self.insert_counts(s, run_len, mask=valid)

    def count(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        """Min-count per k-mer ([...] int32); masked lanes -> 0."""
        c = self.counters[self._indices(canon)].amin(dim=-1).to(torch.int32)
        if mask is not None:
            c = torch.where(mask, c, 0)
        return c

    def contains(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        return self.count(canon, mask) >= self.threshold

    # bulk aliases (the SortedKmerFilter API; the Bloom filter's bulk
    # path is the same gather)
    count_bulk = count
    contains_bulk = contains

    @property
    def popcount_bytes(self) -> int:
        return self.size


class BitBloomFilter:
    """Plain Bloom filter (visited/assembled k-mer set).

    bits: uint8[size + 1], one byte per bit plus the sink slot.
    `insert` updates `bits` in place: at the default budget the array is
    32 MB, and a copy per insert would double the visited filter's
    traffic."""

    def __init__(self, bits: torch.Tensor, k: int = 0, num_hashes: int = 4):
        self.bits = bits
        self.k = k
        self.num_hashes = num_hashes

    @property
    def size(self) -> int:
        return self.bits.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.bits.device

    @staticmethod
    def create(size: int, k: int, num_hashes: int = 4,
               device="cuda") -> "BitBloomFilter":
        _check_pow2(size)
        return BitBloomFilter(
            bits=torch.zeros(size + 1, dtype=torch.uint8,
                             device=resolve_device(device)),
            k=k, num_hashes=num_hashes)

    def _indices(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        return _hash_indices(canon, self.k, self.num_hashes, self.size, mask)

    def _set(self, idx: torch.Tensor) -> "BitBloomFilter":
        self.bits[idx.reshape(-1)] = 1
        self.bits[self.size] = 0
        return self

    def insert(self, canon: torch.Tensor, mask=None) -> "BitBloomFilter":
        """Set the bits of every (unmasked) key, in place; returns self."""
        return self._set(self._indices(canon, mask))

    def insert_window(self, canon: torch.Tensor, start: int, end: int,
                      mask=None) -> "BitBloomFilter":
        """Set only the bits in [start, end), in place: the windowed shard
        build of Bloom/BloomFilterWindow.h; union() merges shards."""
        idx = self._indices(canon, mask)
        return self._set(torch.where((idx >= start) & (idx < end), idx,
                                     self.size))

    def contains(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        hit = self.bits[self._indices(canon)].amin(dim=-1) > 0
        if mask is not None:
            hit = hit & mask
        return hit

    def union(self, other: "BitBloomFilter") -> "BitBloomFilter":
        """Bitwise OR merge (abyss-bloom union, Bloom/bloom.cc)."""
        return BitBloomFilter(torch.maximum(self.bits, other.bits), self.k,
                              self.num_hashes)

    def intersect(self, other: "BitBloomFilter") -> "BitBloomFilter":
        return BitBloomFilter(torch.minimum(self.bits, other.bits), self.k,
                              self.num_hashes)

    @property
    def popcount(self) -> int:
        return int((self.bits[:-1] > 0).sum())


class CascadingBloomFilter:
    """Cascade of L bit Bloom filters (Bloom/CascadingBloomFilter.h).

    One insert promotes a key by exactly one level; `contains` answers
    against the deepest level ("seen >= L times").  All levels share
    the key's H hash values.  A batch is sorted + run-length-encoded, so
    a key with multiplicity c at level l ends at min(L, l + c), as c
    inserts one at a time would leave it.

    levels: uint8[L, size + 1], the last column the masked sink."""

    def __init__(self, levels: torch.Tensor, k: int = 0,
                 num_hashes: int = 4):
        self.levels = levels
        self.k = k
        self.num_hashes = num_hashes

    @property
    def size(self) -> int:
        return self.levels.shape[1] - 1

    @property
    def depth(self) -> int:
        return self.levels.shape[0]

    @property
    def threshold(self) -> int:  # the CountingBloomFilter API
        return self.depth

    @property
    def device(self) -> torch.device:
        return self.levels.device

    @staticmethod
    def create(size: int, k: int, num_hashes: int = 4, depth: int = 2,
               device="cuda") -> "CascadingBloomFilter":
        _check_pow2(size)
        return CascadingBloomFilter(
            levels=torch.zeros((depth, size + 1), dtype=torch.uint8,
                               device=resolve_device(device)),
            k=k, num_hashes=num_hashes)

    def _indices(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        return _hash_indices(canon, self.k, self.num_hashes, self.size, mask)

    def _level_of(self, idx: torch.Tensor) -> torch.Tensor:
        """Current level per key = the number of consecutive containing
        levels from the bottom (the reference's insert walk, false
        positives of lower levels included)."""
        bits = self.levels[:, idx.reshape(-1)].reshape(
            (self.depth,) + tuple(idx.shape))              # [L, ..., H]
        present = bits.amin(dim=-1) > 0                    # [L, ...]
        return torch.cumprod(present.to(torch.int32), dim=0).sum(
            dim=0, dtype=torch.int32)

    def insert(self, canon: torch.Tensor, mask=None) -> "CascadingBloomFilter":
        """Insert a batch (duplicates allowed), in place; each occurrence
        promotes its key one level, saturating at the cascade depth."""
        s, run_len, valid = _sorted_run_lengths(canon, mask)
        idx = self._indices(s, valid)                      # [N, H]
        new_level = torch.clamp(self._level_of(idx) + run_len,
                                max=self.depth)            # [N]
        ones = torch.ones(idx.numel(), dtype=torch.uint8, device=idx.device)
        for i in range(self.depth):
            hit = (new_level >= i + 1)[:, None]
            li = torch.where(hit, idx, self.size).reshape(-1)
            scatter_max_u8(self.levels[i], li, ones)
        self.levels[:, self.size] = 0
        return self

    def insert_window(self, canon: torch.Tensor, start: int, end: int,
                      mask=None) -> "CascadingBloomFilter":
        """Windowed shard build (Bloom/CascadingBloomFilterWindow.h):
        process only keys whose hash index falls in [start, end).

        Requires num_hashes == 1: the reference cascade addresses one
        bit per key per level (Bloom/CascadingBloomFilter.h:87-90), so
        each key's cascade state lives in one window, which makes shard
        builds exact under the OR `union`."""
        if self.num_hashes != 1:
            raise ValueError(
                "windowed cascading builds require num_hashes=1 (the "
                "reference's single-index cascade)")
        idx = self._indices(canon)[..., 0]
        own = (idx >= start) & (idx < end)
        if mask is not None:
            own = own & mask
        return self.insert(canon, own)

    def count(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        """Level per key ([...] int32): a count saturating at depth."""
        c = self._level_of(self._indices(canon))
        if mask is not None:
            c = torch.where(mask, c, 0)
        return c

    def contains(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        """Present in the deepest level (seen >= depth times)."""
        return self.count(canon, mask) >= self.depth

    count_bulk = count
    contains_bulk = contains


def union(a, b):
    """Merge two filters of the same type and geometry (abyss-bloom
    union): counting filters add their counters (saturating), bit and
    cascading filters OR theirs."""
    if isinstance(a, CountingBloomFilter):
        s = torch.clamp(a.counters.to(torch.int32) + b.counters.to(
            torch.int32), max=COUNTER_MAX).to(torch.uint8)
        return CountingBloomFilter(s, a.k, a.num_hashes, a.threshold,
                                   a.update_mode)
    if isinstance(a, CascadingBloomFilter):
        # level-wise OR: exact for window-sharded builds; filters built
        # from disjoint read sets undercount (see abyss_tpu)
        return CascadingBloomFilter(torch.maximum(a.levels, b.levels), a.k,
                                    a.num_hashes)
    return a.union(b)


def intersect(a, b):
    if isinstance(a, CountingBloomFilter):
        return CountingBloomFilter(torch.minimum(a.counters, b.counters),
                                   a.k, a.num_hashes, a.threshold,
                                   a.update_mode)
    if isinstance(a, CascadingBloomFilter):
        return CascadingBloomFilter(torch.minimum(a.levels, b.levels), a.k,
                                    a.num_hashes)
    return a.intersect(b)


def save_filter(path: str, f) -> None:
    """Write a filter as .npz, in the JAX package's layout (keys kind,
    data, k, num_hashes and, for counting filters, threshold), so that
    either package reads the other's files."""
    if isinstance(f, CountingBloomFilter):
        np.savez_compressed(
            path, kind="counting", data=f.counters.cpu().numpy(),
            k=f.k, num_hashes=f.num_hashes, threshold=f.threshold)
    elif isinstance(f, BitBloomFilter):
        np.savez_compressed(path, kind="bit", data=f.bits.cpu().numpy(),
                            k=f.k, num_hashes=f.num_hashes)
    elif isinstance(f, CascadingBloomFilter):
        np.savez_compressed(path, kind="cascading",
                            data=f.levels.cpu().numpy(),
                            k=f.k, num_hashes=f.num_hashes)
    else:
        raise TypeError(type(f))


def load_filter(path: str, device="cuda"):
    """Read a filter that save_filter (of either package) wrote, onto
    `device`."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        data = torch.from_numpy(z["data"]).to(dev)
        k, num_hashes = int(z["k"]), int(z["num_hashes"])
        threshold = int(z["threshold"]) if kind == "counting" else None
    if kind == "counting":
        return CountingBloomFilter(data, k, num_hashes, threshold)
    if kind == "bit":
        return BitBloomFilter(data, k, num_hashes)
    if kind == "cascading":
        return CascadingBloomFilter(data, k, num_hashes)
    raise ValueError(f"unknown filter kind {kind!r} in {path}")


def recommended_sizes(budget_bytes: int) -> tuple[int, int]:
    """Split a memory budget like the reference: 8/9 counting, 1/9 visited
    (bloom-dbg.cc:359-369), rounded down to powers of two."""
    counting = int(budget_bytes * 8 / 9)
    visited = int(budget_bytes / 9)

    def pow2_floor(x):
        return 1 << (max(x, 2).bit_length() - 1)

    return pow2_floor(counting), pow2_floor(visited)
