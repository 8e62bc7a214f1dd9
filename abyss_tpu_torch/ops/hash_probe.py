"""Open-addressing hash tables for set membership and key -> value maps.

Port of abyss_tpu/ops/hash_probe.py: the membership table of the
Bloom-DBG walks and the key -> int32 tables of the Konnector device
BFS (gap/konnector_dev.py).  The membership table is built on the
device (`build_device`), slot for slot as the host build `build`
(numpy, as in the JAX package) lays it out; the key -> value tables
are built on the host (`build_kv`).  Tables are probed and grown on
the device: one [C, B] gather of B contiguous slots per query batch,
which suits small per-level query batches better than a searchsorted
over a sorted store.

Collision policy: the table stores full 64-bit keys; a probe hit is a
64-bit match.  EMPTY (all-ones, -1 as int64) is reserved.

`insert` resolves lanes that race for one slot as XLA's scatter does on
the CPU: the write of the highest lane wins.  torch's CUDA index_put_
makes no such promise, so the winner is chosen explicitly (a running
maximum of lane positions per slot) and every racer writes the winner's
value, which makes the result the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import u64
from ..utils import trace

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
B = 8  # probe window (slots per bucket scan)
# build_device's scratch value of a slot no key bid for this round
NO_BID = torch.iinfo(torch.int32).max

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


def build_device(keys: torch.Tensor, size: int | None = None) -> torch.Tensor:
    """Device-side build of a membership table: int64[size + B] slots on
    the keys' device, the same slots and the same final size as
    `build` gives for the same keys (int64 words, any order).

    Round b is one scatter: each remaining key bids its position in the
    remaining array for slot mix(key) & (size-1) + b (an int32 minimum
    over a scratch of size + B), so the earliest bidder wins a slot, as
    np.unique's first occurrence does in `build`; a won slot takes the
    winner's key if EMPTY, and the keys found at their slot leave the
    remaining array.  Every key bidding for a slot writes the same
    value, so the result does not depend on the device's write order.
    One host sync a round (the compaction); on window overflow the
    table is rebuilt at 2x, the old one freed first.  Counts
    `walk_table.keys`, `walk_table.slots` and `walk_table.rebuilds`."""
    if size is None:
        size = table_size(keys.shape[0])   # EMPTY keys counted, as there
    keys = keys[keys != u64.ALL_ONES]
    n = keys.shape[0]
    mixed = mix64(keys)
    pos = torch.arange(n, dtype=torch.int32, device=keys.device)
    rebuilds = 0
    while True:
        tab = torch.full((size + B,), u64.ALL_ONES, dtype=torch.int64,
                         device=keys.device)
        bid = torch.full((size + B,), NO_BID, dtype=torch.int32,
                         device=keys.device)
        remaining, base = keys, mixed & (size - 1)
        for b in range(B):
            if not remaining.shape[0]:
                break
            cand = base + b
            bid.scatter_reduce_(0, cand, pos[:remaining.shape[0]],
                                reduce="amin")
            old = tab[cand]
            tab[cand] = torch.where(old == u64.ALL_ONES,
                                    remaining[bid[cand]], old)
            bid[cand] = NO_BID
            keep = tab[cand] != remaining
            remaining, base = remaining[keep], base[keep]
        del bid
        if not remaining.shape[0]:
            trace.count("walk_table.keys", n)
            trace.count("walk_table.slots", size + B)
            trace.count("walk_table.rebuilds", rebuilds)
            return tab
        del tab
        size *= 2
        rebuilds += 1


def contains(tab: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Device membership probe: bool[C].  tab: int64[size + B]."""
    size = tab.shape[0] - B
    base = mix64(queries) & (size - 1)
    idx = base[:, None] + torch.arange(B, device=tab.device)[None, :]
    got = tab[idx]                                 # [C, B] contiguous slots
    return (got == queries[:, None]).any(dim=1)


def build_kv(keys: np.ndarray, vals: np.ndarray,
             size: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Host-side build of a key->int32 value table:
    (uint64[size + B] keys, int32[size + B] values, -1 where empty)."""
    keys = np.asarray(keys, np.uint64)
    vals = np.asarray(vals, np.int32)
    if size is None:
        size = table_size(len(keys))
    while True:
        tab = np.full(size + B, EMPTY, np.uint64)
        vtab = np.full(size + B, -1, np.int32)
        live = keys != EMPTY
        remaining, rvals = keys[live], vals[live]
        base = (_mix_np(remaining) & np.uint64(size - 1)).astype(np.int64)
        for b in range(B):
            if not len(remaining):
                break
            cand = base + b
            uniq, first = np.unique(cand, return_index=True)
            free = tab[uniq] == EMPTY
            tab[uniq[free]] = remaining[first[free]]
            vtab[uniq[free]] = rvals[first[free]]
            placed = tab[cand] == remaining
            remaining, rvals = remaining[~placed], rvals[~placed]
            base = base[~placed]
        if not len(remaining):
            return tab, vtab
        size *= 2


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
    """Hash table of a sorted filter's solid keys (exact: count >=
    threshold), built once on the filter's device (`build_device`: no
    host copy of the keys, the counts or the table) and kept on the
    filter object (`filt.solid_tab`)."""
    if filt.solid_tab is None:
        filt.solid_tab = build_device(
            filt.kmers[filt.counts >= filt.threshold])
    return filt.solid_tab


def _window(tab: torch.Tensor, queries: torch.Tensor):
    """(base slot, [C, B] hit mask) of each query's probe window."""
    size = tab.shape[0] - B
    base = mix64(queries) & (size - 1)
    idx = base[:, None] + torch.arange(B, device=tab.device)[None, :]
    return base, tab[idx] == queries[:, None]


def lookup_slot(tab: torch.Tensor, vtab: torch.Tensor,
                queries: torch.Tensor):
    """Device key->value probe: (found bool[C], val int32[C] or -1, slot
    int64[C]), the slot of the FIRST matching window position (the base
    slot where not found).  Callers verify the payload exactly."""
    base, hit = _window(tab, queries)
    found = hit.any(dim=1)
    # argmax returns the first maximum, as jnp.argmax does
    slot = base + hit.to(torch.uint8).argmax(dim=1)
    val = torch.where(found, vtab[slot], -1)
    return found, val, slot


def lookup(tab: torch.Tensor, vtab: torch.Tensor, queries: torch.Tensor):
    """Device key->value probe: (found bool[C], val int32[C] or -1)."""
    found, val, _ = lookup_slot(tab, vtab, queries)
    return found, val


def set_last(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             write: torch.Tensor) -> torch.Tensor:
    """dst[idx[j]] = vals[j] for every j with write[j], in place; where
    several lanes write one slot the highest j wins (XLA's CPU scatter
    order).  Every lane of a slot writes its winner's value, so the
    result does not depend on the order the device applies them in."""
    n = idx.shape[0]
    if n == 0:
        return dst
    sink = dst.shape[0]
    pos = torch.arange(n, device=dst.device)
    tgt = torch.where(write, idx, sink)
    win = torch.full((sink + 1,), -1, dtype=torch.int64, device=dst.device)
    win.scatter_reduce_(0, tgt, pos, reduce="amax")
    w0 = win[0]
    # lanes that do not write put slot 0's final value back into slot 0
    v0 = torch.where(w0 >= 0, vals[w0.clamp(min=0)], dst[0])
    wv = vals[win[tgt].clamp(min=0)]
    dst[torch.where(write, idx, 0)] = torch.where(write, wv, v0).to(dst.dtype)
    return dst


def insert(tab: torch.Tensor, vtab: torch.Tensor, keys: torch.Tensor,
           vals: torch.Tensor, live: torch.Tensor):
    """Device insert of (keys -> vals) where live: B rounds of
    attempt-scatter + readback (losing racers retry the next slot).

    Returns (tab, vtab, failed): new tables (the inputs are not
    written) and the number of live keys that found no free slot in
    their window, a device scalar.  Concurrent duplicate keys are the
    caller's responsibility."""
    tab = tab.clone()
    vtab = vtab.clone()
    size = tab.shape[0] - B
    base = mix64(keys) & (size - 1)
    placed = ~live
    for b in range(B):
        tgt = base + b
        attempt = ~placed & (tab[tgt] == u64.ALL_ONES)
        set_last(tab, tgt, keys, attempt)
        newly = attempt & (tab[tgt] == keys)
        set_last(vtab, tgt, vals, newly)
        placed = placed | newly
    return tab, vtab, (~placed).sum()
