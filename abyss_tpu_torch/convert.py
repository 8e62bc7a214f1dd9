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
package through them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device, u64
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
    return filt, _visited(visited_bits, k, num_hashes, dev)


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
    return filt, _visited(visited_bits, k, num_hashes, dev)


def _visited(bits: np.ndarray | None, k: int, num_hashes: int,
             dev: torch.device) -> BitBloomFilter | None:
    if bits is None:
        return None
    return BitBloomFilter(
        bits=torch.from_numpy(np.asarray(bits, np.uint8).copy()).to(dev),
        k=k, num_hashes=num_hashes)
