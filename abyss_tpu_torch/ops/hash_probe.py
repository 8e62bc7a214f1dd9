"""Open-addressing hash table for set membership inside the walk loops.

Port of the parts of abyss_tpu/ops/hash_probe.py that the Bloom-DBG
walks use.  The table is built on the host (numpy, as in the JAX
package) and probed on the device: one [C, B] gather of B contiguous
slots per query batch, which suits the small per-step query batches of
the extension engine better than a searchsorted over the sorted filter.

Collision policy: the table stores full 64-bit keys; a probe hit is a
64-bit match.  EMPTY (all-ones, -1 as int64) is reserved.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import u64

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
B = 8  # probe window (slots per bucket scan)

_MIX_ADD = u64.s64(0x9E3779B97F4A7C15)
_MIX_MUL1 = u64.s64(0xBF58476D1CE4E5B9)
_MIX_MUL2 = u64.s64(0x94D049BB133111EB)


def _mix_np(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (host, uint64)."""
    z = (z + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


def mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (device, int64 words; wrapping arithmetic and
    logical shifts, bit-identical to the uint64 version)."""
    z = z + _MIX_ADD
    z = (z ^ u64.srl(z, 30)) * _MIX_MUL1
    z = (z ^ u64.srl(z, 27)) * _MIX_MUL2
    return z ^ u64.srl(z, 31)


def table_size(n_keys: int, load: float = 0.25, lo: int = 1 << 10) -> int:
    """Power-of-two slot count targeting the given load factor."""
    want = max(int(n_keys / max(load, 1e-6)), lo)
    return 1 << max(want - 1, 1).bit_length()


def build(keys: np.ndarray, size: int | None = None) -> np.ndarray:
    """Host-side build of a membership table: uint64[size + B] slots.

    Each key lands at mix(key) & (size-1) + b for the smallest free
    b < B; on window overflow the table is rebuilt at 2x."""
    keys = np.asarray(keys, np.uint64)
    if size is None:
        size = table_size(len(keys))
    while True:
        tab = np.full(size + B, EMPTY, np.uint64)
        remaining = keys[keys != EMPTY]
        base = (_mix_np(remaining) & np.uint64(size - 1)).astype(np.int64)
        for b in range(B):
            if not len(remaining):
                break
            cand = base + b
            # one winner per slot among remaining keys
            uniq, first = np.unique(cand, return_index=True)
            free = tab[uniq] == EMPTY
            tab[uniq[free]] = remaining[first[free]]
            placed = tab[cand] == remaining
            remaining = remaining[~placed]
            base = base[~placed]
        if not len(remaining):
            return tab
        size *= 2


def contains(tab: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Device membership probe: bool[C].  tab: int64[size + B]."""
    size = tab.shape[0] - B
    base = mix64(queries) & (size - 1)
    idx = base[:, None] + torch.arange(B, device=tab.device)[None, :]
    got = tab[idx]                                 # [C, B] contiguous slots
    return (got == queries[:, None]).any(dim=1)


class ProbeSet:
    """A membership table with the filter `contains` API."""

    def __init__(self, tab: torch.Tensor):
        self.tab = tab

    @property
    def device(self) -> torch.device:
        return self.tab.device

    def contains(self, q: torch.Tensor, mask=None) -> torch.Tensor:
        hit = contains(self.tab, q.reshape(-1)).reshape(q.shape)
        if mask is not None:
            hit = hit & mask
        return hit


def solid_table(filt) -> torch.Tensor:
    """Device hash table of a sorted filter's solid keys (exact:
    count >= threshold), built once and kept on the filter object
    (`filt.solid_tab`)."""
    if filt.solid_tab is None:
        kmers = u64.to_numpy(filt.kmers)
        counts = filt.counts.cpu().numpy()
        filt.solid_tab = u64.from_numpy(
            build(kmers[counts >= filt.threshold]), filt.kmers.device)
    return filt.solid_tab
