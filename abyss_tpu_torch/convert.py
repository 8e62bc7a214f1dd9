"""Carry the assembler's state between the JAX package and the port.

The system has no weights: its state is the solid-k-mer structure
(the sorted table of canonical hashes and their counts, or the counting
Bloom filter's uint8 counters, with k, the hash count and the solidity
threshold), the visited filter's bit array, and the assembler's
counters.  The JAX package keeps hashes as uint64; the port keeps the
same bits as int64 (u64.py).  `from_numpy_state` (sorted table) and
`counting_filter_from_numpy` (counting filter) build the port's objects
from the JAX package's arrays (as numpy); the port's
`dbg.checkpoint.load` reads a checkpoint directory written by either
package through them.  Two device objects of the later stages convert
the same way: the mapper's k-mer index (`kmer_index_from_numpy`) and a
bit Bloom filter such as RResolver's r-mer filter or the visited
filter (`bit_filter_from_numpy`).  The exact engine's state is its
k-mer table (`kmer_table_from_numpy`); its `.kmer` snapshots are the
JAX package's `.npz` layout (keys k, kmers, counts, alive, nbr, hr,
text), which `dbg.hash_dbg.load_snapshot` and `save_snapshot` of
either package read and write; the paired DBG's is its pair table
(`pair_table_from_numpy`).  The Konnector device search takes the
sorted filter (`from_numpy_state`) and host numpy arrays, the same in
both packages.  The mesh engines' state is sharded: the distributed
exact engine's ShardedKmerTable (`sharded_table_from_numpy`, from the
per-shard arrays of abyss_tpu's table) and a counting filter whose
counters stay split over a mesh's "shard" axis
(`sharded_filter_from_numpy`).  The pipeline's own state between stages
is its artifact files, which both packages read.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device, u64
from .align.mapper import KmerIndex
from .dbg.hash_dbg import KmerTable
from .dbg.paired_dbg import PairTable
from .ops.bloom import BitBloomFilter, CountingBloomFilter
from .ops.sort_join import pack_table
from .ops.sorted_filter import SortedKmerFilter


def from_numpy_state(kmers: np.ndarray, counts: np.ndarray, k: int,
                     threshold: int, visited_bits: np.ndarray | None = None,
                     num_hashes: int = 4, device="cuda"):
    """(SortedKmerFilter, BitBloomFilter or None) on `device` from
    numpy state: kmers uint64[N] sorted, counts int[N], the visited
    filter's uint8 bits (size + 1, sink slot included)."""
    dev = resolve_device(device)
    kmers_t = u64.from_numpy(np.asarray(kmers, np.uint64), dev)
    counts_t = torch.from_numpy(np.asarray(counts).astype(np.int32)).to(dev)
    filt = SortedKmerFilter(kmers=kmers_t, counts=counts_t,
                            packed=pack_table(kmers_t, counts_t),
                            k=k, threshold=threshold)
    return filt, bit_filter_from_numpy(visited_bits, k, num_hashes, dev)


def counting_filter_from_numpy(counters: np.ndarray, k: int,
                               threshold: int, num_hashes: int = 4,
                               visited_bits: np.ndarray | None = None,
                               device="cuda"):
    """(CountingBloomFilter, BitBloomFilter or None) on `device` from
    numpy state: the counting filter's uint8 counters and the visited
    filter's uint8 bits (each size + 1, sink slot included)."""
    dev = resolve_device(device)
    filt = CountingBloomFilter(
        torch.from_numpy(np.asarray(counters, np.uint8).copy()).to(dev),
        k=k, num_hashes=num_hashes, threshold=threshold)
    return filt, bit_filter_from_numpy(visited_bits, k, num_hashes, dev)


def bit_filter_from_numpy(bits: np.ndarray | None, k: int,
                          num_hashes: int = 4,
                          device="cuda") -> BitBloomFilter | None:
    """BitBloomFilter on `device` from the JAX package's uint8 bits
    (size + 1, sink slot included); None for None."""
    if bits is None:
        return None
    return BitBloomFilter(
        bits=torch.from_numpy(np.asarray(bits, np.uint8).copy()).to(
            resolve_device(device)),
        k=k, num_hashes=num_hashes)


def kmer_index_from_numpy(k: int, hashes: np.ndarray, contig: np.ndarray,
                          pos: np.ndarray, is_fwd: np.ndarray,
                          first_row: np.ndarray, names: list, lengths: list,
                          device="cuda") -> KmerIndex:
    """The mapper's KmerIndex on `device` from the JAX package's index
    arrays (as numpy; hashes uint64 sorted in unsigned order)."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    return KmerIndex(
        k=k, hashes=u64.from_numpy(np.array(hashes, np.uint64), dev),
        contig=t(contig, np.int32), pos=t(pos, np.int32),
        is_fwd=t(is_fwd, bool), first_row=t(first_row, np.int32),
        names=list(names), lengths=list(lengths))


def kmer_table_from_numpy(k: int, kmers: np.ndarray, counts: np.ndarray,
                          alive: np.ndarray, nbr: np.ndarray | None = None,
                          hr: np.ndarray | None = None,
                          text: np.ndarray | None = None,
                          fwd_counts: np.ndarray | None = None,
                          cs: np.ndarray | None = None,
                          device="cuda") -> KmerTable:
    """The exact engine's KmerTable, its device programs on `device`,
    from the JAX package's table arrays (kmers, hr and cs uint64,
    counts and fwd_counts int32, alive bool, nbr int32[N, 8], text
    uint8[N, ceil(k/4)])."""
    resolve_device(device)

    def opt(a, dtype):
        return None if a is None else np.array(a, dtype)

    return KmerTable(int(k), np.array(kmers, np.uint64),
                     np.array(counts, np.int32), np.array(alive, bool),
                     nbr=opt(nbr, np.int32), hr=opt(hr, np.uint64),
                     text=opt(text, np.uint8),
                     fwd_counts=opt(fwd_counts, np.int32),
                     cs=opt(cs, np.uint64), device=str(device))


def pair_table_from_numpy(k: int, K: int, keys: np.ndarray,
                          counts: np.ndarray, alive: np.ndarray,
                          fa: np.ndarray, ra: np.ndarray, fb: np.ndarray,
                          rb: np.ndarray, text: np.ndarray,
                          device="cuda") -> PairTable:
    """The paired DBG's wide-mode PairTable (host arrays, as the JAX
    package keeps them), its device programs to run on `device`."""
    resolve_device(device)

    def u(a):
        return np.asarray(a, np.uint64).copy()

    return PairTable(k, K, u(keys), np.asarray(counts, np.int32).copy(),
                     np.asarray(alive, bool).copy(), u(fa), u(ra), u(fb),
                     u(rb), np.asarray(text, np.uint8).copy(),
                     device=str(device))


def sharded_table_from_numpy(mesh, k: int, keys: np.ndarray,
                             counts: np.ndarray, alive: np.ndarray,
                             nbr: np.ndarray | None = None,
                             nbr_strand: np.ndarray | None = None,
                             hr: np.ndarray | None = None,
                             text: np.ndarray | None = None,
                             fwd_counts: np.ndarray | None = None):
    """The distributed exact engine's ShardedKmerTable on the port's
    mesh (parallel/mesh.Mesh, as many devices as abyss_tpu's table has
    shards) from the per-shard arrays of abyss_tpu's ShardedKmerTable
    (as numpy, [D, S, ...]: keys and hr uint64, counts and fwd_counts
    int32, alive bool, nbr int64 [D, S, 8], nbr_strand int8, text uint64
    [D, S, W]); shard d goes to the mesh's device d."""
    from .parallel.sharded_table import ShardedKmerTable

    def shards(a, dtype, words=False):
        if a is None:
            return None
        a = np.asarray(a)
        if words:
            return [u64.from_numpy(a[d].astype(np.uint64), dev)
                    for d, dev in enumerate(mesh.flat)]
        return [torch.from_numpy(np.array(a[d], dtype)).to(dev)
                for d, dev in enumerate(mesh.flat)]

    if np.asarray(keys).shape[0] != mesh.size:
        raise ValueError(f"{np.asarray(keys).shape[0]} shards for a mesh of "
                         f"{mesh.size} devices")
    return ShardedKmerTable(
        mesh, int(k), shards(keys, None, True), shards(counts, np.int32),
        shards(alive, bool), nbr=shards(nbr, np.int64),
        nbr_strand=shards(nbr_strand, np.int8), hr=shards(hr, None, True),
        text=shards(text, None, True),
        fwd_counts=shards(fwd_counts, np.int32))


def sharded_filter_from_numpy(mesh, counters: np.ndarray, k: int,
                              threshold: int, num_hashes: int = 4):
    """A ShardedCountingFilter on the port's ("data", "shard") mesh from
    abyss_tpu's sharded counters (as numpy: the global uint8 [size]
    array, as jax.device_get returns it); each device takes its shard's
    index range."""
    from .parallel.distributed import ShardedCountingFilter, shard_counters
    counters = np.asarray(counters, np.uint8)
    size = counters.shape[0]
    return ShardedCountingFilter(
        mesh, shard_counters(mesh, torch.from_numpy(counters.copy())), k,
        num_hashes, threshold, size)
