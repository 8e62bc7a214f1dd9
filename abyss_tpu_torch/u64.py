"""Unsigned 64-bit words on torch.int64 tensors.

The JAX package computes hashes and keys as uint64.  torch's uint64 has
no shifts, compares, minimum or searchsorted on the CPU, so the port
keeps the same bit patterns in int64 and gets unsigned semantics here:

  * unsigned order (sort, searchsorted, min, compares) goes through
    `flip(x) = x ^ (1 << 63)`, which maps unsigned order onto signed
    order;
  * a logical right shift is an arithmetic shift followed by a mask;
  * the all-ones sentinel 0xFFFF_FFFF_FFFF_FFFF is -1, and flipped it
    becomes INT64_MAX, so it still sorts last.

Addition, multiplication, XOR, AND, OR and left shifts wrap identically
in int64 and uint64, so they need no helper.
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)     # int64 bit pattern of 1 << 63
ALL_ONES = -1         # int64 bit pattern of 0xFFFF_FFFF_FFFF_FFFF


def s64(value: int) -> int:
    """A Python int in [0, 2^64) (or any int, taken mod 2^64) as the
    signed int64 with the same bit pattern."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= (1 << 63) else value


def flip(x: torch.Tensor) -> torch.Tensor:
    """Toggle bit 63: unsigned order of x == signed order of flip(x)."""
    return x ^ SIGN


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift by a constant 0 <= n < 64."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flip(a) < flip(b)


def ule(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flip(a) <= flip(b)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned minimum (jnp.minimum on uint64)."""
    return torch.where(ult(b, a), b, a)


def usort(x: torch.Tensor, dim: int = -1):
    """Unsigned ascending sort: (values, indices).  Not stable: callers
    only sort keys whose ties are bit-identical or carry no payload that
    reaches an output."""
    v, i = torch.sort(flip(x), dim=dim)
    return flip(v), i


def usearchsorted(sorted_seq: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """jnp.searchsorted(sorted_seq, values) (side='left') in unsigned
    order; int64 indices."""
    return torch.searchsorted(flip(sorted_seq).contiguous(),
                              flip(values).contiguous())


def from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint64 (or any 64-bit integer) array -> int64 tensor with
    the same bits, on `device`."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    t = torch.from_numpy(a.astype(np.int64, copy=False))
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array with the same bits."""
    return t.detach().cpu().numpy().astype(np.int64, copy=False).view(
        np.uint64)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """x mod m of the uint64 words x, for 0 < m <= 2^62 (numpy's uint64
    `%`); int64 `%` on the raw word would read the top bit as a sign."""
    # x = 2 * (x >> 1) + (x & 1), and x >> 1 is below 2^63
    return ((srl(x, 1) % m) * 2 + (x & 1)) % m
