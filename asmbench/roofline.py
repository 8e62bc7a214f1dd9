"""Peaks of the card and the bytes of the port's kernels, computed from
their shapes.  Frozen copies: `HBM_BYTES_PER_S` and the bytes of
`chip_smoke.py:nthash_bound` (codes read once; canon, valid and, with
strands, fwd and rev written once).  Only the bytes bound is used:
ntHash is bound by memory on this card, and the repo's integer peak is
an assumption, not a published figure."""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 3.35 TB/s of HBM3, at a 700 W limit
HBM_BYTES_PER_S = 3.35e12


def nthash_bytes(B: int, L: int, k: int, strands: bool) -> int:
    """Bytes one ntHash launch over [B, L] codes must move."""
    if L < k:
        return B * L
    W = L - k + 1
    return B * L + B * W * (8 + 1 + (16 if strands else 0))


def bound_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
