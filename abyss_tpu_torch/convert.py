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
filter (`bit_filter_from_numpy`).  The pipeline's own state between
stages is its artifact files, which both packages read.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device, u64
from .align.mapper import KmerIndex
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
