"""Scatter-max over a uint8 counter array: the write side of the
counting Bloom filter's conservative insert.

Port of abyss_tpu/ops/pallas_scatter.py.  The TPU kernel there
(`scatter_max_u8_pallas`) sorts the update stream into 1024-counter
tiles and applies each tile as a dense compare-broadcast max, with a
capacity plan that can overflow (`ok=False`).  Two implementations here:

  * `scatter_max_u8_plain`: drop the updates outside the power-of-two
    prefix, then `scatter_reduce_(..., "amax")`.  The CPU path, and the
    reference the kernel is held against on the card.
  * the hand-written CUDA kernel `csrc/scatter_max.cu`
    (ops/kernels.scatter_max): a thread per update, a byte-wide max by
    compare-and-swap on the aligned 32-bit word.  No tiles, so nothing
    can overflow and nothing falls back.

Both update the counters in place, and keep the TPU kernel's
`(counters, ok)` return with `ok` always True.
"""

from __future__ import annotations

import torch

from . import kernels


def pow2_size(n: int) -> int:
    """The largest power of two <= n: the counters a scatter-max may
    write (a trailing sink slot beyond it passes through)."""
    return 1 << (n.bit_length() - 1)


def scatter_max_u8(counters: torch.Tensor, idx: torch.Tensor,
                   val: torch.Tensor):
    """counters[i] <- max(counters[i], val[j]) for every idx[j] == i, in
    place.

    counters: uint8 [S (+1)]; idx: [Q] integer, any order (entries at or
    past S, the largest power of two <= len(counters), are dropped, so
    a trailing sink slot passes through); val: uint8 [Q].  Returns
    (counters, True).  On a CUDA tensor this launches the kernel
    (csrc/scatter_max.cu); on a CPU tensor it runs the plain version."""
    if counters.is_cuda:
        kernels.scatter_max(counters, idx.to(torch.int64).contiguous(),
                            val.contiguous())
        return counters, True
    return scatter_max_u8_plain(counters, idx, val)


def scatter_max_u8_plain(counters: torch.Tensor, idx: torch.Tensor,
                         val: torch.Tensor):
    """scatter_max_u8 in plain tensor ops, on any device."""
    idx = idx.to(torch.int64)
    keep = (idx >= 0) & (idx < pow2_size(counters.shape[0]))
    counters.scatter_reduce_(0, idx[keep], val[keep], "amax")
    return counters, True
