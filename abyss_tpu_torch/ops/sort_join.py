"""Bulk k-mer count lookup as a sort-merge join.

Port of the parts of abyss_tpu/ops/sort_join.py that the filters
and the mapper call: the exact 64-bit join (`join_counts`), the packed
40-bit prefix probe (`pack_table`, `join_counts_packed`,
`join_solid_packed`; the last answers by a search instead of a join,
see there), the row join of the mapper's vote (`join_rows`, also a
search), and the dense u8 gather and scatter-max by merging
(`dense_gather_u8`, `dense_scatter_max_u8`, the counting Bloom
filter's update_mode="sort").

  1. concatenate table words and query words, so that a table row sorts
     before the equal query keys;
  2. one sort groups equal keys;
  3. a running max copies each table row's count forward across its
     run of queries;
  4. a second sort by original query index restores query order.

Sorts are unsigned (u64.usort) and unstable.  Every sorted word is
either unique (queries carry their original index) or tied only with
bit-identical words, so tie order never reaches an output.
"""

from __future__ import annotations

import torch

from .. import u64
from .scan import running_max

_LO32 = 0xFFFFFFFF


def join_counts(table_keys: torch.Tensor, table_counts: torch.Tensor,
                queries: torch.Tensor) -> torch.Tensor:
    """Counts for each query key (0 when absent from the table).

    table_keys: int64[M] sorted unique (unsigned order); table_counts:
    int32[M]; queries: int64[N] (any order, duplicates fine).  Returns
    int32[N] aligned with `queries`.

    The table/query flag rides in the key's low bit: two distinct
    64-bit hashes colliding after dropping bit 0 has probability
    ~ M*N/2^63 per batch."""
    M = table_keys.shape[0]
    N = queries.shape[0]
    dev = queries.device
    if M == 0:
        return torch.zeros(N, dtype=torch.int32, device=dev)
    keys = torch.cat([table_keys & ~1,      # flag 0: table
                      queries | 1])         # flag 1: query
    # payload: (original index+1) << 32 | count+1; queries carry count 0
    payload = torch.cat([
        table_counts.to(torch.int64) + 1,
        (torch.arange(N, dtype=torch.int64, device=dev) + 1) << 32])
    sk, order = u64.usort(keys)
    sp = payload[order]
    # group id = the hash sans flag bit; nondecreasing after the sort, so
    # a running max over (segment_id << 32 | count+1) leaves every
    # element holding its own segment's table count
    group = u64.srl(sk, 1)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       group[1:] != group[:-1]])
    seg = torch.cumsum(start.to(torch.int64), dim=0)
    enc = (seg << 32) | (sp & _LO32)
    run = running_max(enc)
    counts_sorted = torch.clamp((run & _LO32).to(torch.int32) - 1, min=0)
    # restore query order with ONE sort of (idx+1) << 32 | count: table
    # rows have idx payload 0 and sort first; queries follow in order
    back = (sp & (_LO32 << 32)) | counts_sorted.to(torch.int64)
    sb, _ = u64.usort(back)
    return (sb[M:] & _LO32).to(torch.int32)


# Packed probe: one word per element.  Layout: [63:24] 40-bit hash
# prefix | [23] query flag | table rows: [14:0] count; query rows:
# [22:0] original index.  Expected false joins per batch = M*N/2^40.
PREFIX_SHIFT = 24
FLAG_BIT = 1 << 23
IDX_MASK = (1 << 23) - 1
COUNT_MASK = (1 << 15) - 1


def _prefix_words(x: torch.Tensor) -> torch.Tensor:
    """x with its low PREFIX_SHIFT bits cleared."""
    return x & ~((1 << PREFIX_SHIFT) - 1)


def pack_table(table_keys: torch.Tensor,
               table_counts: torch.Tensor) -> torch.Tensor:
    """Pre-pack a sorted table for the packed probes (once per filter;
    the result is sorted because the prefix order follows the full-hash
    order)."""
    c = torch.clamp(table_counts.to(torch.int64), max=0x7FFF)
    return _prefix_words(table_keys) | c


def pack_queries(queries: torch.Tensor) -> torch.Tensor:
    """Pack query hashes as (prefix | flag | original index) words."""
    N = queries.shape[0]
    return _prefix_words(queries) | FLAG_BIT | torch.arange(
        N, dtype=torch.int64, device=queries.device)


def _packed_join(packed_table: torch.Tensor, queries: torch.Tensor):
    """Sort table + query words together.  Returns (sorted words, query
    mask, prefix-group match, group table count): the running max
    belongs to an element's prefix group by monotonicity, and its low
    16 bits are the group's table count."""
    sk, _ = u64.usort(torch.cat([packed_table, pack_queries(queries)]))
    prefix = u64.srl(sk, PREFIX_SHIFT)
    is_query = (sk & FLAG_BIT) != 0
    enc = (prefix << 16) | torch.where(
        is_query, torch.zeros_like(sk), sk & COUNT_MASK)
    run = running_max(enc)
    return sk, is_query, u64.srl(run, 16) == prefix, run & 0xFFFF


def join_counts_packed(packed_table: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """Counts for each query against a `pack_table` result.

    queries: int64[N], N < 2^23.  Returns int32[N] in query order."""
    N = queries.shape[0]
    sk, is_query, match, run_count = _packed_join(packed_table, queries)
    count = torch.where(match, run_count, torch.zeros_like(run_count))
    back = torch.where(is_query, ((sk & IDX_MASK) << 16) | count,
                       torch.full_like(sk, u64.ALL_ONES))
    sb, _ = u64.usort(back)
    return (sb[:N] & 0xFFFF).to(torch.int32)


def solid_prefixes(packed_table: torch.Tensor,
                   threshold: int) -> torch.Tensor:
    """The sorted unique prefix words of the `pack_table` rows that count
    >= threshold.  A filter builds them once and keeps them
    (`SortedKmerFilter.solid_prefixes`)."""
    solid = packed_table[(packed_table & COUNT_MASK) >= threshold]
    # the table is sorted by prefix, so the solid rows' prefixes are too
    return torch.unique_consecutive(_prefix_words(solid))


def join_solid_packed(packed_table: torch.Tensor, queries: torch.Tensor,
                      threshold: int,
                      prefixes: torch.Tensor | None = None) -> torch.Tensor:
    """`join_counts_packed(...) >= threshold`: a query is solid when a
    table row with its 40-bit prefix counts >= threshold.  Returns
    bool[N] in query order.

    The JAX package sorts table and query words together for this; here
    the query prefixes are searched (unsigned) in `prefixes`, the
    table's `solid_prefixes` (built here when not given), which gives
    the same answers without sorting the table on every call."""
    N = queries.shape[0]
    dev = queries.device
    if threshold <= 0:                  # every count is >= 0
        return torch.ones(N, dtype=torch.bool, device=dev)
    if prefixes is None:
        prefixes = solid_prefixes(packed_table, threshold)
    if prefixes.shape[0] == 0:
        return torch.zeros(N, dtype=torch.bool, device=dev)
    q = _prefix_words(queries)
    idx = torch.clamp(u64.usearchsorted(prefixes, q),
                      max=prefixes.shape[0] - 1)
    return prefixes[idx] == q


def join_rows(table_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Row index in the sorted `table_keys` of each query key, -1 when
    absent: the mapper's seed lookup.

    table_keys: int64[M] sorted in unsigned order (u64), duplicates
    allowed; queries: int64[N] in any order.  Returns int32[N] aligned
    with `queries`.  Where a key occupies several rows the answer is the
    last of them, the row the JAX package's sort-merge join returns (its
    forward and backward running maxima propagate the largest row of the
    equal-key run).  Here an unsigned right-side search finds it."""
    M = table_keys.shape[0]
    if M == 0:
        return torch.full(queries.shape, -1, dtype=torch.int32,
                          device=queries.device)
    pos = torch.searchsorted(u64.flip(table_keys).contiguous(),
                             u64.flip(queries).contiguous(), right=True) - 1
    row = pos.clamp(min=0)
    hit = (pos >= 0) & (table_keys[row] == queries)
    return torch.where(hit, row, -1).to(torch.int32)


# Dense-array gather / scatter-max by sorting: the counting Bloom
# filter's update_mode="sort".  Both accesses become a merge: sort the
# query or update stream together with one marker word per dense slot,
# answer with a running max of slot-tagged values, and restore order
# with a second sort.  Words: [63:33] slot | [32] flag | [31:0] payload.


def dense_gather_u8(dense: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[q] = dense[idx[q]] without a gather.

    dense: uint8[M] (M < 2^31); idx: integer [Q] in [0, M), Q < 2^32.
    Returns uint8[Q]."""
    M = dense.shape[0]
    Q = idx.shape[0]
    dev = dense.device
    slot_m = torch.arange(M, dtype=torch.int64, device=dev)
    # markers (flag 0) sort before queries (flag 1) within a slot
    k_m = (slot_m << 33) | dense.to(torch.int64)
    k_q = (idx.to(torch.int64) << 33) | (1 << 32) | torch.arange(
        Q, dtype=torch.int64, device=dev)
    s, _ = u64.usort(torch.cat([k_m, k_q]))
    slot = u64.srl(s, 33)
    is_q = (u64.srl(s, 32) & 1) != 0
    enc = torch.where(is_q, torch.zeros_like(s), (slot << 8) | (s & 0xFF))
    run = running_max(enc)
    val = torch.where(u64.srl(run, 8) == slot, run & 0xFF,
                      torch.zeros_like(run))
    # order-restoring sort: queries keyed by original position
    back = torch.where(is_q, ((s & _LO32) << 8) | val,
                       torch.full_like(s, u64.ALL_ONES))
    out, _ = u64.usort(back)
    return (out[:Q] & 0xFF).to(torch.uint8)


def dense_scatter_max_u8(dense: torch.Tensor, idx: torch.Tensor,
                         vals: torch.Tensor) -> torch.Tensor:
    """dense[idx[q]] = max(dense[idx[q]], vals[q]) without a scatter.

    dense: uint8[M]; idx: integer [Q] in [0, M); vals: uint8[Q].
    Returns a new uint8[M]."""
    M = dense.shape[0]
    dev = dense.device
    slot_m = torch.arange(M, dtype=torch.int64, device=dev)
    # updates (flag 0) sort before their slot's marker (flag 1), so a
    # forward running max over slot-tagged update values is complete
    # when it reaches the marker
    k_m = (slot_m << 33) | (1 << 32) | dense.to(torch.int64)
    k_u = (idx.to(torch.int64) << 33) | vals.to(torch.int64)
    s, _ = u64.usort(torch.cat([k_m, k_u]))
    slot = u64.srl(s, 33)
    is_m = (u64.srl(s, 32) & 1) != 0
    enc = torch.where(is_m, torch.zeros_like(s), (slot << 8) | (s & 0xFF))
    run = running_max(enc)
    upd = torch.where(u64.srl(run, 8) == slot, run & 0xFF,
                      torch.zeros_like(run))
    newval = torch.maximum(s & 0xFF, upd)
    # markers carry the result back out, keyed by slot
    back = torch.where(is_m, (slot << 8) | newval,
                       torch.full_like(s, u64.ALL_ONES))
    out, _ = u64.usort(back)
    return (out[:M] & 0xFF).to(torch.uint8)
