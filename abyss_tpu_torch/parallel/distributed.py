"""Mesh-sharded counting filter and mesh k-mer counting.

Port of abyss_tpu/parallel/distributed.py.  The reference distributes
assembly by rank-sharding a k-mer hash table and routing updates with
MPI messages; scalar counts and the coverage histogram merge with
MPI_Allreduce (CommLayer.cpp:106-137).  The same roles on a 2-D mesh
(parallel/mesh.py):

  axis "data"   read batches are data-parallel (the reference's OpenMP
                batch loop, BloomIO.h:62-95, over devices);
  axis "shard"  the counting filter's counters are split by index
                range: each device applies only the updates that land in
                its range, and the data-parallel partial updates merge
                with a `psum` over "data".

Counting-filter merges are *increment* psums: each device computes its
conservative update against the current filter and contributes
`new - old`; summed increments commute, so the result is deterministic
and does not depend on how a batch splits over "data" (it can exceed
the strictly sequential conservative value only where two data shards
raise one slot, the window the reference's CAS loop leaves open,
CountingBloomFilter.hpp:118-181).  Probes of a sharded filter are a
shard-local gather plus a `psum` over "shard".

Per-shard programs are loops over the mesh's devices, each step's
tensors on its shard's device; on a CUDA mesh the load step launches
the ntHash kernel (strand variant, through ops/nthash.kmer_hashes) and
the scatter-max kernel (ops/scatter_max.scatter_max_u8: the local
`.at[lidx].max(tgt)` with its sink slot) once per device and batch.
Out-of-range gathers under a mask, which JAX clamps, are clamped here
before the gather.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import u64
from ..ops import nthash
from ..ops.bloom import COUNTER_MAX, CountingBloomFilter, _sorted_run_lengths
from ..ops.scatter_max import scatter_max_u8
from .mesh import Mesh, axis_index, gather_rows, psum, scatter_rows


def shard_batch(mesh: Mesh, codes) -> list:
    """A [B, L] uint8 read batch split by rows over "data" (replicated
    over "shard"); raises ValueError when B is not a multiple of the
    data axis, as jax.device_put does."""
    return scatter_rows(mesh, torch.as_tensor(np.asarray(codes, np.uint8)),
                        "data")


def shard_counters(mesh: Mesh, counters: torch.Tensor) -> list:
    """Filter counters [size] split by index range over "shard"
    (replicated over "data")."""
    return scatter_rows(mesh, counters, "shard")


def _zero_counters(mesh: Mesh, size: int) -> list:
    n_shard = mesh.shape["shard"]
    return [torch.zeros(size // n_shard, dtype=torch.uint8, device=dev)
            for dev in mesh.flat]


def _indices(canon: torch.Tensor, k: int, num_hashes: int, size: int):
    """[..., H] filter indices of each key (int64)."""
    return nthash.multi_hashes(canon, k, num_hashes) & (size - 1)


def _local_counts(counters: torch.Tensor, idx: torch.Tensor, lo: int):
    """counters[idx - lo] (int32) where idx lies in this shard's range
    [lo, lo + len), 0 elsewhere."""
    n = counters.shape[0]
    mine = (idx >= lo) & (idx < lo + n)
    got = counters[(idx - lo).clamp(0, n - 1)].to(torch.int32)
    return torch.where(mine, got, 0)


def _probe_mins(mesh: Mesh, counters: list, canon: list, k: int,
                num_hashes: int, size: int) -> list:
    """Per device: the min-count of each key of canon[i] over the
    sharded counters (shard-local gather, psum over "shard")."""
    sidx = axis_index(mesh, "shard")
    shard_len = size // mesh.shape["shard"]
    local = [_local_counts(counters[i],
                           _indices(canon[i], k, num_hashes, size),
                           sidx[i] * shard_len)
             for i in range(mesh.size)]
    return [c.amin(dim=-1) for c in psum(mesh, local, "shard")]


def _conservative_targets(cur: torch.Tensor, counts: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """[N, H] scatter targets of a conservative batch update from the
    psum'd current counters cur [N, H]: min(min_h cur + count,
    COUNTER_MAX) for each key, 0 for masked keys."""
    lo = cur.amin(dim=-1)
    tgt = torch.clamp(lo + counts.to(torch.int32), max=COUNTER_MAX)
    tgt = torch.where(mask, tgt, 0)
    return tgt[:, None].expand(cur.shape)


def make_load_step(mesh: Mesh, k: int, num_hashes: int, size: int):
    """step(counters, codes) -> counters: insert one sharded read batch
    (shard_batch) into the sharded counting filter (shard_counters or a
    previous step's result)."""
    n_shard = mesh.shape["shard"]
    shard_len = size // n_shard
    sidx = axis_index(mesh, "shard")

    def step(counters: list, codes: list) -> list:
        keys, runs, uniq, idx, local = [], [], [], [], []
        for i in range(mesh.size):
            _, _, canon, valid = nthash.kmer_hashes(codes[i], k)
            s, run_len, u = _sorted_run_lengths(canon, valid)
            ix = _indices(s, k, num_hashes, size)
            local.append(_local_counts(counters[i], ix,
                                       sidx[i] * shard_len))
            keys.append(s)
            runs.append(run_len)
            uniq.append(u)
            idx.append(ix)
        cur = psum(mesh, local, "shard")
        deltas = []
        for i in range(mesh.size):
            tgt = _conservative_targets(cur[i], runs[i], uniq[i])
            lo_idx = sidx[i] * shard_len
            mine = (idx[i] >= lo_idx) & (idx[i] < lo_idx + shard_len)
            lidx = torch.where(mine, idx[i] - lo_idx, shard_len)
            # the local max into a copy with a sink slot at shard_len,
            # which the scatter-max drops (shard_len is a power of two)
            buf = torch.cat([counters[i], counters[i].new_zeros(1)])
            scatter_max_u8(buf, lidx.reshape(-1),
                           tgt.reshape(-1).to(torch.uint8))
            old = counters[i].to(torch.int32)
            deltas.append(torch.clamp(buf[:shard_len].to(torch.int32) - old,
                                      min=0))
        merged = psum(mesh, deltas, "data")
        return [torch.clamp(counters[i].to(torch.int32) + merged[i],
                            max=COUNTER_MAX).to(torch.uint8)
                for i in range(mesh.size)]

    return step


def make_probe_step(mesh: Mesh, k: int, num_hashes: int, size: int,
                    threshold: int):
    """probe(counters, codes) -> (counts, valid): the min-count of every
    k-mer of a sharded read batch, per device [B / n_data, W] (sharded
    over "data", replicated over "shard"; gather_rows(mesh, x, "data")
    gives the global array)."""

    def probe(counters: list, codes: list):
        canon, valid = [], []
        for c in codes:
            _, _, cn, v = nthash.kmer_hashes(c, k)
            canon.append(cn)
            valid.append(v)
        return _probe_mins(mesh, counters, canon, k, num_hashes,
                           size), valid

    return probe


def make_histogram_step(mesh: Mesh, k: int, num_hashes: int, size: int,
                        threshold: int, max_count: int = 64):
    """hist(counters, codes) -> int32 [max_count]: the k-mer coverage
    histogram of a sharded batch, all-reduced over the mesh (the
    reference's histogram MPI_Allreduce, CommLayer.cpp:106-137); on the
    mesh's first device."""
    probe = make_probe_step(mesh, k, num_hashes, size, threshold)

    def hist(counters: list, codes: list) -> torch.Tensor:
        counts, valid = probe(counters, codes)
        hs = []
        for c, v in zip(counts, valid):
            c = torch.clamp(c, 0, max_count - 1)
            h = torch.zeros(max_count, dtype=torch.int32, device=c.device)
            h.index_add_(0, torch.where(v, c, 0).reshape(-1).long(),
                         v.reshape(-1).to(torch.int32))
            h[0] = 0
            hs.append(h)
        # counts are shard-invariant (inner psum): reduce over data
        return psum(mesh, hs, "data")[0]

    return hist


def make_classify_step(mesh: Mesh, k: int, num_hashes: int, size: int,
                       threshold: int):
    """classify(counters, codes, lengths) -> (all_solid, first_bad): the
    distributed pass-2 read guards (bloom_dbg._classify_batch): per read
    (sharded over "data"), whether every window is solid and the index
    of the first non-solid one (-1 if none)."""
    probe = make_probe_step(mesh, k, num_hashes, size, threshold)

    def classify(counters: list, codes: list, lengths: list):
        counts, valid = probe(counters, codes)
        solid_all, first_bad = [], []
        for c, v, ln in zip(counts, valid, lengths):
            W = c.shape[1]
            in_read = torch.arange(W, device=c.device)[None, :] < \
                (ln[:, None] - k + 1)
            bad = v & in_read & ~(c >= threshold)
            anyb = bad.any(dim=1)
            solid_all.append(~anyb)
            first_bad.append(torch.where(
                anyb, bad.to(torch.uint8).argmax(dim=1), -1))
        return solid_all, first_bad

    return classify


def distributed_count_kmers(mesh: Mesh, batches, k: int,
                            packed: bool | None = None):
    """Mesh-parallel k-mer counting for the sorted/exact engines: each
    device sorts and run-length-reduces its data slice of every batch
    (the ABYSS-P load phase without routing,
    NetworkSequenceCollection.cpp:454-500), and the host merges the
    pre-reduced (distinct k-mer, count) pairs.

    packed=True counts 2-bit packed canonical k-mers (the exact
    engine's key space, k <= 32), else canonical ntHash values (the
    sorted filter's and wide mode's); default packed for k <= 32.
    Batches pad with rows of code 4 to a multiple of the data axis.
    Returns host arrays (kmers uint64[N] sorted unique, counts
    int32[N])."""
    from ..dbg.hash_dbg import pack_kmers
    from ..ops.sorted_filter import COUNTER_MAX as CMAX, _sort_rle

    if packed is None:
        packed = k <= 32
    n_data = mesh.shape["data"]
    # the replicas along "shard" reduce the same slice: read one
    rows = mesh.group(0, "data")

    pairs = []
    for codes in batches:
        codes = np.asarray(codes, np.uint8)
        pad = (-codes.shape[0]) % n_data
        if pad:
            codes = np.concatenate(
                [codes, np.full((pad,) + codes.shape[1:], 4, np.uint8)])
        sharded = shard_batch(mesh, codes)
        for i in rows:
            if packed:
                _, _, canon, valid = pack_kmers(sharded[i], k)
            else:
                _, _, canon, valid = nthash.kmer_hashes(sharded[i], k)
            keys, counts = _sort_rle(
                torch.where(valid, canon, u64.ALL_ONES).reshape(-1))
            keys = u64.to_numpy(keys)
            counts = counts.cpu().numpy()
            keep = (counts > 0) & (keys != np.uint64(0xFFFFFFFFFFFFFFFF))
            pairs.append((keys[keep], counts[keep]))

    if not pairs:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    keys = np.concatenate([p[0] for p in pairs])
    counts = np.concatenate([p[1] for p in pairs])
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    counts = counts[order]
    uniq = np.concatenate([[True], keys[1:] != keys[:-1]])
    idx = np.cumsum(uniq) - 1
    merged = np.zeros(int(uniq.sum()), np.int64)
    np.add.at(merged, idx, counts)
    return keys[uniq], np.minimum(merged, CMAX).astype(np.int32)


def distributed_filter_build(mesh: Mesh, batches, k: int,
                             num_hashes: int = 4, threshold: int = 2,
                             size: int = 1 << 24,
                             sharded: bool = False):
    """Build a counting filter from an iterator of [B, L] code batches
    on the mesh.

    sharded=False: a CountingBloomFilter on the mesh's first device
    (every device could hold the whole filter).  sharded=True: a
    ShardedCountingFilter whose counters stay split over "shard"
    (size / n_shard per device) and whose probes are psum'd shard-local
    lookups."""
    step = make_load_step(mesh, k, num_hashes, size)
    counters = _zero_counters(mesh, size)
    for codes in batches:
        counters = step(counters, shard_batch(mesh, codes))
    if sharded:
        return ShardedCountingFilter(mesh, counters, k, num_hashes,
                                     threshold, size)
    dev = mesh.flat[0]
    full = torch.cat([gather_rows(mesh, counters, "shard").to(dev),
                      torch.zeros(1, dtype=torch.uint8, device=dev)])
    return CountingBloomFilter(counters=full, k=k, num_hashes=num_hashes,
                               threshold=threshold)


class ShardedCountingFilter:
    """Counting-filter view over mesh-sharded counters with the
    CountingBloomFilter probe API (count, contains, contains_bulk,
    count_bulk): the Bloom engine's pass 2 runs unmodified while every
    probe rides the mesh (shard-local gather, psum over "shard").

    `counters` is the list of every device's shard; the devices of one
    "data" row (`shard_rows`) hold one copy of the whole filter, and a
    probe reads those (the other rows hold the same counters).  Results
    lie on the query's device.  On a CUDA mesh the walk and look-ahead
    kernels probe the shards themselves (csrc/walk.cuh ShardedSolid)."""

    def __init__(self, mesh: Mesh, counters: list, k: int,
                 num_hashes: int, threshold: int, size: int):
        self.mesh = mesh
        self.counters = counters
        self.k = k
        self.num_hashes = num_hashes
        self.threshold = threshold
        self.size = size
        self.n_shard = mesh.shape["shard"]
        self.shard_len = size // self.n_shard
        self.shard_rows = mesh.group(0, "shard")
        self._pointers: dict = {}

    @property
    def device(self) -> torch.device:
        return self.mesh.flat[0]

    @property
    def shards(self) -> list:
        """The counters of one copy of the filter, shard s at position
        s (uint8 [size / n_shard] each)."""
        return [self.counters[i] for i in self.shard_rows]

    def shard_pointers(self, device: torch.device) -> torch.Tensor:
        """int64 [n_shard] on `device`: the shards' base addresses, the
        array the walk kernels' ShardedSolid reads (kept for reuse)."""
        key = str(device)
        if key not in self._pointers:
            self._pointers[key] = torch.tensor(
                [s.data_ptr() for s in self.shards], dtype=torch.int64,
                device=device)
        return self._pointers[key]

    def count(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        """Min-count per k-mer ([...] int32, on canon's device); masked
        lanes -> 0."""
        dev = canon.device
        idx = _indices(canon, self.k, self.num_hashes, self.size)
        acc = None
        for s, shard in enumerate(self.shards):
            part = _local_counts(shard, idx.to(shard.device),
                                 s * self.shard_len).to(dev)
            acc = part if acc is None else acc + part
        c = acc.amin(dim=-1)
        if mask is not None:
            c = torch.where(mask, c, 0)
        return c

    def contains(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        return self.count(canon, mask) >= self.threshold

    def contains_bulk(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        return self.contains(canon, mask)

    def count_bulk(self, canon: torch.Tensor, mask=None,
                   exact: bool = False) -> torch.Tensor:
        return self.count(canon, mask)
