"""Running (prefix) scans along a 1-D tensor.

Port of abyss_tpu/ops/scan.py.  The JAX package hand-unrolls a
Hillis-Steele ladder because its platform's associative_scan was slow;
torch has native inclusive scans (`cummax`/`cummin`), which compute the
same values.  Signed order, as in the JAX package: callers that scan
uint64 words keep them below 2^63 (sort_join packs 56-bit words).
"""

from __future__ import annotations

import torch


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum."""
    return torch.cummax(x, dim=0).values


def running_min(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running minimum; reverse=True scans right to left."""
    if reverse:
        return torch.cummin(x.flip(0), dim=0).values.flip(0)
    return torch.cummin(x, dim=0).values
