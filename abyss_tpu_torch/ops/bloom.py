"""Bloom filters as device-resident tensors.

Port of the parts of abyss_tpu/ops/bloom.py that stage 1 with the
sorted filter uses: the bit Bloom filter of visited (assembled) k-mers,
`recommended_sizes` and `_check_pow2`.  The counting Bloom filter
(`filter_mode="bloom"`) comes with the port of its scatter-max kernel
(ROADMAP.md, queue B item 2).

Filter sizes are powers of two, so indexing is a mask of the 64-bit
hash instead of a modulo.  The bit array keeps one byte per bit, with
a trailing sink slot (`size`) that masked lanes write to and that is
cleared after every insert.
"""

from __future__ import annotations

import torch

from . import nthash


def _check_pow2(size: int) -> int:
    if size & (size - 1) or size <= 0:
        raise ValueError(f"filter size must be a power of two, got {size}")
    if size > (1 << 31):
        raise ValueError("filter size must fit int32 indexing (<= 2^31)")
    return size


class BitBloomFilter:
    """Plain Bloom filter (visited/assembled k-mer set).

    bits: uint8[size + 1], one byte per bit plus the sink slot.
    `insert` updates `bits` in place (the JAX package returns a new
    filter): at the default budget the array is 32 MB, and a copy per
    insert would double the visited filter's traffic."""

    def __init__(self, bits: torch.Tensor, k: int = 0, num_hashes: int = 4):
        self.bits = bits
        self.k = k
        self.num_hashes = num_hashes

    @property
    def size(self) -> int:
        return self.bits.shape[0] - 1

    @staticmethod
    def create(size: int, k: int, num_hashes: int = 4,
               device="cuda") -> "BitBloomFilter":
        _check_pow2(size)
        return BitBloomFilter(
            bits=torch.zeros(size + 1, dtype=torch.uint8, device=device),
            k=k, num_hashes=num_hashes)

    def _indices(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        """[..., H] int64 bit indices; masked lanes -> the sink slot."""
        hs = nthash.multi_hashes(canon, self.k, self.num_hashes)
        idx = hs & (self.size - 1)
        if mask is not None:
            idx = torch.where(mask[..., None], idx, self.size)
        return idx

    def insert(self, canon: torch.Tensor, mask=None) -> "BitBloomFilter":
        """Set the bits of every (unmasked) key, in place; returns self."""
        idx = self._indices(canon, mask).reshape(-1)
        self.bits[idx] = 1
        self.bits[self.size] = 0
        return self

    def contains(self, canon: torch.Tensor, mask=None) -> torch.Tensor:
        idx = self._indices(canon)
        hit = self.bits[idx].amin(dim=-1) > 0
        if mask is not None:
            hit = hit & mask
        return hit

    @property
    def popcount(self) -> int:
        return int((self.bits[:-1] > 0).sum())


def recommended_sizes(budget_bytes: int) -> tuple[int, int]:
    """Split a memory budget like the reference: 8/9 counting, 1/9 visited
    (bloom-dbg.cc:359-369), rounded down to powers of two."""
    counting = int(budget_bytes * 8 / 9)
    visited = int(budget_bytes / 9)

    def pow2_floor(x):
        return 1 << (max(x, 2).bit_length() - 1)

    return pow2_floor(counting), pow2_floor(visited)
