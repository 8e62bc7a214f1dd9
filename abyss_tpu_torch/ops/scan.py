"""Running (prefix) scans along a 1-D tensor.

Port of abyss_tpu/ops/scan.py.  The JAX package hand-unrolls a
Hillis-Steele ladder because its platform's associative_scan was slow;
`running` keeps that ladder for any associative op, and the max, min and
sum scans use torch's native inclusive scans (`cummax`/`cummin`, and
`cumsum`, which is exact for integers), which compute the same values.
Signed order, as in the JAX package: callers that scan uint64 words keep
them below 2^63 (sort_join packs 56-bit words).
"""

from __future__ import annotations

import torch


def running(x: torch.Tensor, op, identity, reverse: bool = False):
    """Inclusive scan of `op` (associative, elementwise on two tensors)
    along a 1-D tensor, by log-step doubling.

    identity: value with op(identity, v) == v, used to pad the shifted
    operand.  reverse=True scans right to left (suffix scan)."""
    n = x.shape[0]
    s = 1
    while s < n:
        pad = torch.full((s,), identity, dtype=x.dtype, device=x.device)
        if reverse:
            x = op(x, torch.cat([x[s:], pad]))
        else:
            x = op(x, torch.cat([pad, x[:-s]]))
        s *= 2
    return x


def _flipped(scan, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    if reverse:
        return scan(x.flip(0)).flip(0)
    return scan(x)


def running_max(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running maximum; reverse=True scans right to left."""
    return _flipped(lambda v: torch.cummax(v, dim=0).values, x, reverse)


def running_min(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running minimum; reverse=True scans right to left."""
    return _flipped(lambda v: torch.cummin(v, dim=0).values, x, reverse)


def running_sum(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running sum, in x's dtype; reverse=True scans right to
    left."""
    return _flipped(lambda v: torch.cumsum(v, dim=0, dtype=x.dtype), x,
                    reverse)
