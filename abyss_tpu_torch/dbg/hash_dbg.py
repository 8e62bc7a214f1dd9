"""Exact de Bruijn graph engine over a sorted k-mer table.

Port of abyss_tpu/dbg/hash_dbg.py, the counterpart of the reference's
in-memory hash-DBG assembler (`ABYSS`, Assembly/ + ABYSS/abyss.cc).  The
k-mer set is a sorted array of 2-bit-packed canonical k-mers (k <= 32 in
one 64-bit word) and every phase is a dense array program:

  membership     -> unsigned binary search / sort join
  adjacency      -> 8 neighbour probes per k-mer into an [N, 8]
                    neighbour-row table (AdjacencyAlgorithm.h:9-46)
  erode, trim    -> chain rounds on the device (dbg/chain_ops.py,
                    ErodeAlgorithm.h:63-113, TrimAlgorithm.h:15-99)
  split+assemble -> unique-successor links + pointer doubling
                    (AssembleAlgorithm.h:45-142)

Orientation: only canonical k-mers are stored (Assembly/DBG.h:293-322);
traversal works on oriented vertices 2*i + strand.  Palindromic k-mers
break chains (Assembly/DBG.h:202-207).

Wide k (k > 32): the table is keyed on the 64-bit canonical ntHash
fingerprint of each k-mer, with two side arrays: the non-canonical hash
(`hr`, for orientation tests and O(1) neighbour rolls) and the
2-bit-packed k-mer text (`text`, for contig sequence).  Every occurrence
is checked against an independent text checksum (`kmer_hashes_alt`);
a detected fingerprint collision excises the merged row
(ABYSS_TPU_COLLISION=raise makes it fatal).

The KmerTable's arrays live on the host as numpy (uint64 k-mers), as in
the JAX package; its `device` says where the device programs run.  They
are torch ops on that device, bit for bit the JAX programs' results:
hashes and keys are int64 words with uint64 bits (u64.py), so every
sort, search and min over them is unsigned.  On a CUDA device the wide
path launches the ntHash kernel (csrc/nthash.cu) through
ops/nthash.canonical_hashes (counting) and kmer_hashes (the side-array
fill); the packed path packs 2-bit keys and launches none.

The chain phases (erode, trim, bubbles, low-coverage contigs, assemble)
have one implementation, on the table's device (dbg/chain_ops.py).  The
numpy forms they are held to are abyss_tpu.dbg.hash_dbg's
(`_oriented_next`, `_pointer_double`, `_trim_round`, `_chain_list`,
selected there by ABYSS_TPU_CHAIN=host); this package reads no such
switch.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, u64
from ..core import alphabet
from ..core.histogram import Histogram
from ..ops import nthash
from ..utils import trace
from .chain_ops import _rc_packed

COVERAGE_MAX = 32767  # Assembly/VertexData.h:33


def pack_kmers(codes: torch.Tensor, k: int):
    """2-bit-pack every k-window of [B, L] codes.

    Returns (fwd, rc, canon, valid): int64[B, W] packed k-mers (uint64
    bits); valid masks windows containing non-ACGT codes."""
    if k > 32:
        raise ValueError(
            f"the exact hash-DBG engine packs k-mers into one 64-bit word "
            f"(k <= 32); got k={k}. Use the Bloom-DBG engine for larger k.")
    L = codes.shape[-1]
    W = L - k + 1
    safe = codes.clamp(max=3).long()
    comp = 3 - safe
    fwd = torch.zeros(codes.shape[:-1] + (W,), dtype=torch.int64,
                      device=codes.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        fwd = (fwd << 2) | safe[..., j:j + W]
        rc = (rc << 2) | comp[..., k - 1 - j:k - 1 - j + W]
    canon = u64.umin(fwd, rc)
    bad = (codes >= 4).to(torch.int32)
    cb = torch.cat([torch.zeros_like(bad[..., :1]),
                    torch.cumsum(bad, dim=-1, dtype=torch.int32)], dim=-1)
    valid = (cb[..., k:] - cb[..., :W]) == 0
    return fwd, rc, canon, valid


def unpack_kmer(packed: int, k: int) -> str:
    out = []
    for j in range(k):
        out.append("ACGT"[(packed >> (2 * (k - 1 - j))) & 3])
    return "".join(out)


@dataclass
class KmerTable:
    """Sorted canonical k-mer table with counts and adjacency (host
    numpy arrays, the JAX package's layout).

    Packed mode (k <= 32): `kmers` are 2-bit-packed canonical k-mers.
    Wide mode (any k): `kmers` are canonical ntHash fingerprints and
    the side arrays `hr` (non-canonical hash) + `text` (2-bit-packed
    stored-orientation bases, 4/byte big-endian) are set.  `device` is
    where the table's device programs run ("cuda" or "cpu").
    """
    k: int
    kmers: np.ndarray      # uint64[N] sorted canonical packed k-mers
    counts: np.ndarray     # int32[N] multiplicities (saturated)
    alive: np.ndarray      # bool[N]
    nbr: np.ndarray | None = None   # int32[N, 8] neighbour row or -1
    # nbr columns 0-3: right extension by base c (stored orientation);
    # columns 4-7: left extension by base c.
    hr: np.ndarray | None = None    # uint64[N] (wide mode)
    text: np.ndarray | None = None  # uint8[N, ceil(k/4)] (wide mode)
    # per-strand multiplicity (VertexData.h's 2x counters); filled by
    # count_kmers(strand_counts=True) for the erode E threshold
    fwd_counts: np.ndarray | None = None  # int32[N]
    # wide mode: independent text checksum (kmer_hashes_alt) of the
    # stored orientation — collision detection
    cs: np.ndarray | None = None          # uint64[N]
    device: str = "cuda"

    @property
    def n(self) -> int:
        return len(self.kmers)

    @property
    def wide(self) -> bool:
        return self.text is not None

    def end_bases(self) -> tuple[np.ndarray, np.ndarray]:
        """(first, last) base codes of the stored orientation (wide);
        memoized — chain emission asks per contig."""
        cached = getattr(self, "_end_bases", None)
        if cached is not None and len(cached[0]) == self.n:
            return cached
        k = self.k
        first = (self.text[:, 0] >> 6) & 3
        j = k - 1
        last = (self.text[:, j // 4] >> (6 - 2 * (j % 4))) & 3
        out = (first.astype(np.uint8), last.astype(np.uint8))
        object.__setattr__(self, "_end_bases", out)
        return out


def pack_text(codes: np.ndarray, k: int) -> np.ndarray:
    """2-bit-pack [N, k] base codes into uint8[N, ceil(k/4)] (4 bases
    per byte, base 0 in the high bits — Common/Kmer.h:138 layout)."""
    N = codes.shape[0]
    TB = (k + 3) // 4
    buf = np.zeros((N, TB * 4), np.uint8)
    buf[:, :k] = codes
    buf = buf.reshape(N, TB, 4)
    return (buf[:, :, 0] << 6) | (buf[:, :, 1] << 4) | \
        (buf[:, :, 2] << 2) | buf[:, :, 3]


def unpack_text(row: np.ndarray, k: int) -> str:
    """Inverse of pack_text for one row."""
    out = []
    for j in range(k):
        out.append("ACGT"[(int(row[j // 4]) >> (6 - 2 * (j % 4))) & 3])
    return "".join(out)


def save_snapshot(t: KmerTable, path: str) -> None:
    """Binary DBG state snapshot — the `.kmer` store/load of the MPI
    engine (Assembly/DBG.h:354-401): k-mers, counts, flags, adjacency;
    the JAX package's `.npz` layout, which either package loads."""
    np.savez_compressed(path, k=t.k, kmers=t.kmers, counts=t.counts,
                        alive=t.alive,
                        nbr=t.nbr if t.nbr is not None else np.zeros(0),
                        hr=t.hr if t.hr is not None else np.zeros(0),
                        text=t.text if t.text is not None else np.zeros(0))
    if not path.endswith(".npz"):
        os.replace(path + ".npz", path)


def load_snapshot(path: str, device="cuda") -> KmerTable:
    """Load a `.kmer` snapshot (Assembly/LoadAlgorithm.h:82-87 loads
    `.kmer` inputs instead of re-counting reads), written by either
    package; the table's device programs run on `device`."""
    resolve_device(device)
    z = np.load(path, allow_pickle=False)
    nbr = z["nbr"]
    hr = z["hr"] if "hr" in z else np.zeros(0)
    text = z["text"] if "text" in z else np.zeros(0)
    return KmerTable(int(z["k"]), z["kmers"], z["counts"],
                     z["alive"].astype(bool),
                     nbr if nbr.ndim == 2 else None,
                     hr=hr if hr.size else None,
                     text=text if text.ndim == 2 else None,
                     device=str(device))


def _trim_pad_columns(codes, k: int):
    """Drop all-padding trailing columns (host-side, numpy input only):
    150 bp reads in a 256-wide buffer waste ~45% of every hash + sort
    downstream.  The kept width rounds up to a multiple of 32."""
    if not isinstance(codes, np.ndarray) or codes.ndim != 2:
        return codes
    used = (codes < 4).any(axis=0)
    nz = np.nonzero(used)[0]
    L = int(nz[-1]) + 1 if len(nz) else codes.shape[1]
    L = min(codes.shape[1], max(k + 1, -(-L // 32) * 32))
    return codes[:, :L] if L < codes.shape[1] else codes


def _pack_canon_masked(codes: torch.Tensor, k: int, strand_key: bool):
    """Per-batch ingest.

    strand_key=False: (masked canon, masked canon-where-forward) — two
    streams for two counters.  strand_key=True (k <= 31): ONE stream of
    (canon << 1 | forward-is-canonical) keys, so per-strand counting
    costs one sort instead of two; the finalize step folds the strand
    bit back out."""
    fwd, _, canon, valid = pack_kmers(codes, k)
    if strand_key:
        key = (canon << 1) | (fwd == canon).long()
        return torch.where(valid, key, u64.ALL_ONES).reshape(-1), None
    canon_m = torch.where(valid, canon, u64.ALL_ONES).reshape(-1)
    strand_m = torch.where(valid & (fwd == canon), canon,
                           u64.ALL_ONES).reshape(-1)
    return canon_m, strand_m


def _to_device(codes, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev)


def _finalized(ctr):
    """(kmers uint64, counts int64) of a SortedKmerCounter, on the host."""
    f = ctr.finalize()
    return u64.to_numpy(f.kmers), f.counts.cpu().numpy().astype(np.int64)


def count_kmers(batches, k: int, strand_counts: bool = False,
                wide_fill: bool = True, device="cuda") -> KmerTable:
    """Load phase (LoadAlgorithm.h:12-178): read batches -> sorted
    unique canonical k-mers with counts, counted on `device` by the
    streaming sort + run-length counter (ops/sorted_filter).

    strand_counts additionally tracks sense-orientation occurrences
    (VertexData.h's per-strand multiplicity) for the erode `E`
    threshold: one strand-bit key stream at k <= 31, else a second
    counter of the windows whose forward form is the canonical form."""
    from ..ops.sorted_filter import SortedKmerCounter
    dev = resolve_device(device)
    if k > 32:
        return _count_kmers_wide(batches, k, fill=wide_fill, device=device)
    strand_key = strand_counts and k <= 31
    ctr = SortedKmerCounter(k, threshold=1)
    sctr = SortedKmerCounter(k, threshold=1) \
        if strand_counts and not strand_key else None
    for codes in batches:
        codes = _trim_pad_columns(codes, k)
        canon, smask = _pack_canon_masked(_to_device(codes, dev), k,
                                          strand_key)
        ctr.add(canon)
        if sctr is not None:
            sctr.add(smask)
    keys, cnts = _finalized(ctr)
    if len(keys) == 0:
        return KmerTable(k, np.zeros(0, np.uint64), np.zeros(0, np.int32),
                         np.zeros(0, bool), device=str(device))
    if strand_key:
        # fold the strand bit out: rows with equal canon are adjacent
        # (reverse-form row first, bit 0 < bit 1)
        canon = keys >> np.uint64(1)
        is_fwd = (keys & np.uint64(1)).astype(bool)
        start = np.concatenate([[True], canon[1:] != canon[:-1]])
        sidx = np.flatnonzero(start)
        totals = np.add.reduceat(cnts, sidx)
        fwd_tot = np.add.reduceat(np.where(is_fwd, cnts, 0), sidx)
        kmers = canon[sidx]
        counts = np.minimum(totals, COVERAGE_MAX).astype(np.int32)
        t = KmerTable(k, kmers, counts, np.ones(len(kmers), bool),
                      device=str(device))
        t.fwd_counts = np.minimum(fwd_tot, COVERAGE_MAX).astype(np.int32)
        return t
    kmers = keys
    counts = np.minimum(cnts, COVERAGE_MAX).astype(np.int32)
    t = KmerTable(k, kmers, counts, np.ones(len(kmers), bool),
                  device=str(device))
    if sctr is not None:
        skeys, scnts = _finalized(sctr)
        fwd_counts = np.zeros(len(kmers), np.int32)
        if len(skeys):
            scnts = np.minimum(scnts, COVERAGE_MAX).astype(np.int32)
            idx = np.searchsorted(kmers, skeys)
            ok = (idx < len(kmers)) & (kmers[np.minimum(
                idx, len(kmers) - 1)] == skeys)
            fwd_counts[idx[ok]] = scnts[ok]
        t.fwd_counts = fwd_counts
    return t


def _count_kmers_wide(batches, k: int, fill: bool = True,
                      device="cuda") -> KmerTable:
    """Wide-mode load: key on the canonical ntHash fingerprint, then a
    second pass fills per-distinct-k-mer side arrays (non-canonical
    hash + packed text) from each fingerprint's first occurrence.

    Only canon and valid are kept here, so on the card this launches
    the ntHash kernel without its strand outputs (canonical_hashes).
    fill=False defers the side-array pass (assemble_reads fills after
    the kc filter + compaction, so error k-mers never pay for it)."""
    from ..ops.sorted_filter import SortedKmerCounter
    dev = resolve_device(device)
    batches = list(batches)
    ctr = SortedKmerCounter(k, threshold=1)
    for codes in batches:
        canon, valid = nthash.canonical_hashes(_to_device(codes, dev), k)
        ctr.add(canon, valid)
    kmers, cnts = _finalized(ctr)
    if len(kmers) == 0:
        return KmerTable(k, np.zeros(0, np.uint64), np.zeros(0, np.int32),
                         np.zeros(0, bool), hr=np.zeros(0, np.uint64),
                         text=np.zeros((0, (k + 3) // 4), np.uint8),
                         device=str(device))
    counts = np.minimum(cnts, COVERAGE_MAX).astype(np.int32)
    t = KmerTable(k, kmers, counts, np.ones(len(kmers), bool),
                  device=str(device))
    if not fill:
        return t
    return fill_wide_side(t, batches)


def _fill_batch_rows(codes, k: int, kmers_dev, kmers_key, filled_dev,
                     verify: bool):
    """Device side of one batch of the wide fill: per window its table
    row, whether it hits the table, whether its row still needs a fill,
    its fwd/rev hashes and its checksum in the stored orientation."""
    N = kmers_dev.shape[0]
    fh, rh, canon, valid = nthash.kmer_hashes(codes, k)
    fh, rh = fh.reshape(-1), rh.reshape(-1)
    canon = canon.reshape(-1)
    valid = valid.reshape(-1)
    rows = torch.searchsorted(kmers_key, u64.flip(canon)).clamp(max=N - 1)
    hit = valid & (kmers_dev[rows] == canon)
    need = hit & ~filled_dev[rows]
    if not verify:
        return need, rows, fh, rh, fh, hit
    f2, r2 = nthash.kmer_hashes_alt(codes, k)
    # checksum of the STORED orientation (flip iff rh < fh)
    cso = torch.where(u64.ult(rh, fh), r2.reshape(-1), f2.reshape(-1))
    return need, rows, fh, rh, cso, hit


def fill_wide_side(t: KmerTable, batches,
                   verify: bool = True) -> KmerTable:
    """Fill wide-mode side arrays (hr + packed text) for a table whose
    `kmers` are sorted canonical ntHash fingerprints, from the first
    occurrence of each fingerprint in the read batches.

    verify=True (default) additionally checks every occurrence's
    independent text checksum (nthash.kmer_hashes_alt) against the
    stored one, so a fingerprint collision (two distinct k-mer texts
    sharing a canonical 64-bit ntHash) is detected rather than silently
    merging k-mers.  A detected collision is excised: the merged row is
    marked dead, and the chain breaks cleanly there.
    ABYSS_TPU_COLLISION=raise makes it fatal instead.  The collision
    count is kept in `t.collisions`.

    `filled`, the checksums and the collision flags stay on the device
    across batches; only each batch's fill selection crosses to the
    host.  The scatters of the JAX code that drop an index past the
    table write a sink slot N here instead."""
    dev = resolve_device(t.device)
    k, kmers, N = t.k, t.kmers, t.n
    hr = np.zeros(N, np.uint64)
    cs = np.zeros(N, np.uint64)
    text = np.zeros((N, (k + 3) // 4), np.uint8)
    t.collisions = 0
    if N == 0:
        t.hr, t.text = hr, text
        return t
    filled = np.zeros(N, bool)
    kmers_dev = u64.from_numpy(kmers, dev)
    kmers_key = u64.flip(kmers_dev).contiguous()
    filled_dev = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    cs_dev = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    coll_dev = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    collisions = 0
    for codes in batches:
        codes_np = np.ascontiguousarray(codes, np.uint8)
        need_d, rows_d, fh_d, rh_d, cs_d, hit_d = _fill_batch_rows(
            _to_device(codes_np, dev), k, kmers_dev, kmers_key,
            filled_dev[:N], verify)
        need = need_d.cpu().numpy()       # [BW] bool: the only bulk copy
        if need.any():
            occ = np.nonzero(need)[0]
            occ_d = torch.from_numpy(occ).to(dev)
            rows_occ = rows_d[occ_d].cpu().numpy()
            first = occ[np.unique(rows_occ, return_index=True)[1]]
            first_d = torch.from_numpy(first).to(dev)
            fh = u64.to_numpy(fh_d[first_d])
            rh = u64.to_numpy(rh_d[first_d])
            r_d = rows_d[first_d]
            r = r_d.cpu().numpy()
            # the first occurrences' windows, gathered from a strided
            # view (reshaping the view first would copy every window of
            # the batch)
            W = codes_np.shape[1] - k + 1
            win = np.lib.stride_tricks.sliding_window_view(
                codes_np, k, axis=1)[first // W, first % W]
            flip = rh < fh
            win = np.where(flip[:, None], 3 - win[:, ::-1], win)
            text[r] = pack_text(win.astype(np.uint8), k)
            hr[r] = np.where(flip, fh, rh)
            if verify:
                cs[r] = u64.to_numpy(cs_d[first_d])
                cs_dev[r_d] = cs_d[first_d]
            filled[r] = True
            filled_dev[r_d] = True
        if verify:
            # every occurrence must match the stored checksum (the
            # fill above ran first, so same-batch occurrences verify
            # against the chosen first occurrence too)
            bad = hit_d & filled_dev[rows_d] & (cs_dev[rows_d] != cs_d)
            coll_dev[torch.where(bad, rows_d, N)] = True
            collisions += int(bad.sum())
        elif filled.all():
            break
    t.collisions = collisions
    if collisions:
        if os.environ.get("ABYSS_TPU_COLLISION") == "raise":
            raise RuntimeError(
                f"wide-mode fingerprint collision detected: "
                f"{collisions} occurrence(s) disagree with the stored "
                f"k-mer text checksum at k={k}; two distinct k-mers "
                f"share a 64-bit canonical ntHash "
                f"(ABYSS_TPU_COLLISION=raise).")
        coll_rows = np.flatnonzero(coll_dev[:N].cpu().numpy())
        t.alive[coll_rows] = False
        print(f"[hash-dbg] wide-mode fingerprint collision: excised "
              f"{len(coll_rows)} merged row(s) "
              f"({collisions} mismatching occurrence(s) at k={k}); "
              f"chains break cleanly at the excision sites",
              file=sys.stderr, flush=True)
    t.hr = hr
    t.text = text
    t.cs = cs
    return t


def compact(t: KmerTable) -> KmerTable:
    """Drop dead rows in place (sorted order is preserved by slicing).

    Compacting right after the kc filter (before adjacency, so no index
    remap is needed) spares every later phase the dead rows.  When
    `nbr` exists, neighbour indices are remapped."""
    keep = t.alive
    if keep.all():
        return t
    if t.nbr is not None:
        new_idx = np.cumsum(keep, dtype=np.int64) - 1
        nb = t.nbr
        ok = (nb >= 0) & keep[np.maximum(nb, 0)]
        t.nbr = np.where(ok, new_idx[np.maximum(nb, 0)], -1).astype(
            np.int32)[keep]
    t.kmers = t.kmers[keep]
    t.counts = t.counts[keep]
    if t.fwd_counts is not None:
        t.fwd_counts = t.fwd_counts[keep]
    if t.hr is not None:
        t.hr = t.hr[keep]
    if t.text is not None:
        t.text = t.text[keep]
    if t.cs is not None:
        t.cs = t.cs[keep]
    t.alive = np.ones(len(t.kmers), bool)
    for cache in ("_end_bases", "_dev"):
        if hasattr(t, cache):
            delattr(t, cache)
    return t


def coverage_histogram(t: KmerTable) -> Histogram:
    h = Histogram()
    vals, cnts = np.unique(t.counts[t.alive], return_counts=True)
    for v, c in zip(vals, cnts):
        h.insert(int(v), int(c))
    return h


def coverage_threshold(h: Histogram) -> float:
    """setCoverageParameters (CoverageAlgorithm.h:13-60): the fixpoint of
    sqrt(median of the histogram trimmed at the current threshold),
    seeded at the first local minimum."""
    t = float(h.first_local_minimum())
    if t == 0:
        return 0.0
    for _ in range(100):
        t2 = float(np.sqrt(h.trim_low(int(round(t))).median()))
        if abs(t2 - t) < 1e-9:
            break
        t = t2
    return t


def apply_coverage_threshold(t: KmerTable, kc: int) -> KmerTable:
    """kc filter (CoverageAlgorithm.h:117-129)."""
    t.alive &= t.counts >= kc
    return t


def _neighbor_probe(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """For each stored canonical k-mer: the table row of each of its 8
    neighbours (right by base 0..3, then left by base 0..3), -1 if the
    neighbour k-mer is absent.  Returns [8, N]."""
    mask = u64.s64((1 << (2 * k)) - 1)
    shift_top = 2 * (k - 1)
    x = kmers  # stored orientation
    rows = []
    for c in range(4):
        y = ((x << 2) | c) & mask
        rows.append(u64.umin(y, _rc_packed(y, k)))
    for c in range(4):
        y = u64.srl(x, 2) | u64.s64(c << shift_top)
        rows.append(u64.umin(y, _rc_packed(y, k)))
    return _cand_rows(kmers, rows)


def _cand_rows(kmers, cand_list):
    """Table row per neighbour candidate (-1 absent): one unsigned
    search of the [8N] candidates in the sorted table, [8, N]."""
    from ..ops.sort_join import join_rows
    flat = torch.cat(cand_list)       # [8N], one block per direction
    return join_rows(kmers, flat).reshape(8, -1)


def _neighbor_probe_wide(kmers, hr, firstb, lastb, k: int):
    """Wide-mode neighbour probe: candidate fingerprints come from O(1)
    ntHash rolls of the stored (fwd=canonical, rev=hr) hash state —
    never from multi-word k-mer arithmetic."""
    hf = kmers  # stored orientation: fwd hash IS the canonical min
    rows = []
    for c in range(4):
        f2, r2 = nthash.roll_right(hf, hr, k, firstb, torch.full_like(
            firstb, c))
        rows.append(u64.umin(f2, r2))
    for c in range(4):
        f2, r2 = nthash.roll_left(hf, hr, k, lastb, torch.full_like(
            lastb, c))
        rows.append(u64.umin(f2, r2))
    return _cand_rows(kmers, rows)


def build_adjacency(t: KmerTable) -> KmerTable:
    """AdjacencyAlgorithm.h:9-46 as one batched probe on t.device."""
    if hasattr(t, "_dev"):
        delattr(t, "_dev")
    if t.n == 0:
        t.nbr = np.zeros((0, 8), np.int32)
        return t
    dev = resolve_device(t.device)
    kmers = u64.from_numpy(t.kmers, dev)
    if t.wide:
        firstb, lastb = t.end_bases()
        nbr8 = _neighbor_probe_wide(
            kmers, u64.from_numpy(t.hr, dev), torch.from_numpy(firstb).to(
                dev), torch.from_numpy(lastb).to(dev), t.k)
    else:
        nbr8 = _neighbor_probe(kmers, t.k)
    t.nbr = np.ascontiguousarray(nbr8.cpu().numpy().T)
    return t


def _device_dbg(t: KmerTable):
    """Cached device-resident view; alive is pushed fresh per call."""
    from . import chain_ops
    d = t.__dict__.get("_dev")
    if d is None or d.n != t.n:
        d = chain_ops.DeviceDBG(t)
        t._dev = d
    else:
        d.sync_from_host()
    return d


def erode(t: KmerTable, e: int, e_strand: int = 0) -> int:
    """Remove blunt-ended k-mers with coverage < e — or either strand's
    coverage < e_strand (the `E` parameter, ErodeAlgorithm.h:75-77) —
    until stable (ErodeAlgorithm.h:63-113).  Returns number eroded.

    Strand thresholds need per-strand counts: count_kmers(...,
    strand_counts=True) fills t.fwd_counts; without them e_strand is
    ignored."""
    if t.n == 0:
        return 0
    d = _device_dbg(t)
    total = d.erode(e, e_strand)
    d.sync_to_host()
    return total


def trim(t: KmerTable, max_tip: int) -> int:
    """Prune tips of <= max_tip k-mers (performTrim,
    TrimAlgorithm.h:15-34), straight to the t-fixpoint: every batched
    round removes all currently-qualifying tips at once, and repeats
    only while removals expose new tips (the fixpoint the reference's
    1, 2, 4, .., t ladder reaches)."""
    if max_tip <= 0 or t.n == 0:
        return 0
    d = _device_dbg(t)
    total = d.trim(max_tip)
    d.sync_to_host()
    return total


def _kept_rule(hk, hs, ek, es):
    """Keep chain (head, end) iff its signature (head kmer, head
    strand, end kmer, end strand) <= the rc chain's signature
    (end kmer, end strand^1, head kmer, head strand^1) — an id-space
    independent rule (vectorized lexicographic compare, numpy)."""
    rk, rs = ek, es ^ 1
    qk, qs = hk, hs ^ 1
    lt = (hk < rk) | ((hk == rk) & (
        (hs < rs) | ((hs == rs) & (
            (ek < qk) | ((ek == qk) & (es <= qs))))))
    return lt


class _ChainStruct:
    """Host view of the device chain decomposition: the alive oriented
    vertices in sorted (head, pos) order plus vectorized per-segment
    reductions.  Built from ONE device copy (chain_ops.DeviceDBG.chains);
    everything here is numpy over segment boundaries, never per-chain
    Python loops."""

    def __init__(self, t: KmerTable):
        self.t = t
        d = _device_dbg(t)
        self.ov_s, self.sidx, self.lengths = d.chains()
        self.rows = self.ov_s >> 1
        self.strands = (self.ov_s & 1).astype(np.uint8)
        self.headv = self.ov_s[self.sidx] if len(self.sidx) else \
            np.zeros(0, np.int32)
        ends = self.sidx + self.lengths - 1
        self.endv = self.ov_s[ends] if len(self.sidx) else \
            np.zeros(0, np.int32)
        # rc-duplicate dedup: the reverse-complement chain of
        # (head h, end e) is (e^1, h^1); keep the chain whose signature
        # is lexicographically <= its rc's.  Self-rc chains compare
        # equal and are kept.
        self.kept = _kept_rule(
            t.kmers[self.headv >> 1], (self.headv & 1).astype(np.int64),
            t.kmers[self.endv >> 1], (self.endv & 1).astype(np.int64))
        ccum = np.zeros(len(self.rows) + 1, np.int64)
        np.cumsum(t.counts[self.rows], dtype=np.int64, out=ccum[1:])
        self.covsum = ccum[self.sidx + self.lengths] - ccum[self.sidx]

    def seg_elements(self, segs: np.ndarray) -> np.ndarray:
        """Indices into ov_s of all elements of the given segments."""
        ln = self.lengths[segs]
        base = np.repeat(self.sidx[segs], ln)
        return base + _concat_ranges(ln)

    def kill(self, segs: np.ndarray) -> None:
        """Mark every row of the given segments dead."""
        self.t.alive[self.rows[self.seg_elements(segs)]] = False


def _concat_ranges(lengths: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated (vectorized)."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.zeros(len(lengths), np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


def _expand_head_kmers(t: KmerTable, rows: np.ndarray,
                       strands: np.ndarray) -> np.ndarray:
    """[nc, k] base codes of each chain's first k-mer in walk
    orientation (vectorized unpack of packed words / wide text)."""
    k = t.k
    if t.wide:
        j = np.arange(k)
        codes = (t.text[rows][:, j // 4] >> (6 - 2 * (j % 4))) & 3
    else:
        shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
        codes = ((t.kmers[rows][:, None] >> shifts[None, :])
                 & np.uint64(3)).astype(np.uint8)
    flip = strands.astype(bool)
    codes = np.where(flip[:, None], 3 - codes[:, ::-1], codes)
    return codes.astype(np.uint8)


def _walk_last_bases(t: KmerTable, rows: np.ndarray,
                     strands: np.ndarray) -> np.ndarray:
    """Last base (walk orientation) contributed by each oriented
    vertex: stored last base on strand 0, complement of the stored
    first base on strand 1."""
    if t.wide:
        firstb, lastb = t.end_bases()
    else:
        lastb = (t.kmers & np.uint64(3)).astype(np.uint8)
        firstb = ((t.kmers >> np.uint64(2 * (t.k - 1)))
                  & np.uint64(3)).astype(np.uint8)
    return np.where(strands == 0, lastb[rows], 3 - firstb[rows]).astype(
        np.uint8)


_ASCII = np.frombuffer(b"ACGT", np.uint8)
_RC_TABLE = bytes.maketrans(b"ACGT", b"TGCA")


def _emit_segments(cs: _ChainStruct, segs: np.ndarray,
                   canonical: bool = False) -> list[tuple[str, int]]:
    """Materialize the selected segments as (sequence, coverage_sum):
    one flat base buffer filled by two vectorized scatters (first
    k-mers + per-vertex tail bases), sliced per contig as bytes."""
    t = cs.t
    k = t.k
    if len(segs) == 0:
        return []
    L = cs.lengths[segs]
    outlen = k + L - 1
    offs = np.zeros(len(segs) + 1, np.int64)
    np.cumsum(outlen, out=offs[1:])
    buf = np.empty(int(offs[-1]), np.uint8)
    h = cs.ov_s[cs.sidx[segs]]
    first = _expand_head_kmers(t, h >> 1, (h & 1).astype(np.uint8))
    idx0 = offs[:-1][:, None] + np.arange(k)[None, :]
    buf[idx0.reshape(-1)] = first.reshape(-1)
    tail_len = L - 1
    src = np.repeat(cs.sidx[segs] + 1, tail_len) + _concat_ranges(tail_len)
    tgt = np.repeat(offs[:-1] + k, tail_len) + _concat_ranges(tail_len)
    buf[tgt] = _walk_last_bases(t, cs.rows[src], cs.strands[src])
    ascii_buf = _ASCII[buf].tobytes()
    out = []
    covs = cs.covsum[segs]
    for i in range(len(segs)):
        s = ascii_buf[offs[i]:offs[i + 1]]
        if canonical:
            rc = s.translate(_RC_TABLE)[::-1]
            if rc < s:
                s = rc
        out.append((s.decode(), int(covs[i])))
    return out


def _flank_info(cs: _ChainStruct):
    """Per-kept-segment unique entry/exit junction rows (or -1): the
    vectorized form of abyss_tpu.dbg.hash_dbg._chain_flank_rows, with
    same-chain candidates excluded via each row's chain id."""
    t = cs.t
    # chain id per row: min of the two oriented chains' heads
    head_per_elem = np.repeat(cs.headv, cs.lengths)
    headov = np.full(2 * t.n, -1, np.int64)
    headov[cs.ov_s] = head_per_elem
    rowchain = np.minimum(headov[0::2], headov[1::2])
    chainid = np.minimum(cs.headv.astype(np.int64),
                         cs.endv.astype(np.int64) ^ 1)

    def side(ovs, entry_side):
        r = ovs >> 1
        s = ovs & 1
        # entry: neighbours behind the head (left cols on strand 0);
        # exit: neighbours past the end (right cols on strand 0)
        use_left = (s == 0) if entry_side else (s == 1)
        cand = np.where(use_left[:, None], t.nbr[r][:, 4:8],
                        t.nbr[r][:, 0:4])
        cc = np.maximum(cand, 0)
        ok = (cand >= 0) & t.alive[cc] & (rowchain[cc] != chainid[:, None])
        cnt = ok.sum(axis=1)
        row = np.max(np.where(ok, cand, -1), axis=1)
        return cnt, row

    ecnt, erow = side(cs.headv, True)
    xcnt, xrow = side(cs.endv, False)
    return ecnt, erow, xcnt, xrow


def pop_bubbles_kmer(t: KmerTable, max_len: int,
                     max_branches: int = 3) -> list[str]:
    """k-mer-level bubble popping (BubbleAlgorithm.h:46-137): chains of
    <= max_len k-mers that share their entry and exit junction k-mers
    are a bubble; keep the highest-coverage branch, delete the rest.
    Returns the popped branch sequences (the *-bubbles.fa payload)."""
    if t.n == 0:
        return []
    cs = _ChainStruct(t)
    cand = cs.kept & (cs.lengths <= max_len)
    if not cand.any():
        return []
    ecnt, erow, xcnt, xrow = _flank_info(cs)
    cand &= (ecnt == 1) & (xcnt == 1)
    segs = np.flatnonzero(cand)
    if len(segs) == 0:
        return []
    a = np.minimum(erow[segs], xrow[segs])
    b = np.maximum(erow[segs], xrow[segs])
    order = np.lexsort((segs, b, a))
    segs, a, b = segs[order], a[order], b[order]
    boundary = np.flatnonzero(
        np.concatenate([[True], (a[1:] != a[:-1]) | (b[1:] != b[:-1])]))
    ends = np.append(boundary[1:], len(segs))
    pop_segs = []
    for gb, ge in zip(boundary, ends):
        if not (2 <= ge - gb <= max_branches):
            continue
        grp = segs[gb:ge]
        keep = _best_branch(cs.covsum[grp], cs.lengths[grp])
        pop_segs.extend(int(s) for i, s in enumerate(grp) if i != keep)
    if not pop_segs:
        return []
    pop_segs = np.asarray(pop_segs)
    popped = [s for s, _ in _emit_segments(cs, pop_segs)]
    cs.kill(pop_segs)
    return popped


def _best_branch(covsums, lengths) -> int:
    """Highest-mean-coverage branch, first on ties — by exact rational
    comparison (covsum_i * len_j vs covsum_j * len_i in Python ints)."""
    best = 0
    for i in range(1, len(covsums)):
        if int(covsums[i]) * int(lengths[best]) > \
                int(covsums[best]) * int(lengths[i]):
            best = i
    return best


def remove_low_coverage_contigs(t: KmerTable, c: float) -> int:
    """Delete the k-mers of contigs with mean coverage < c
    (AssembleAlgorithm.h:14-39 / ABYSS/abyss.cc:22-34).  Returns the
    number of contigs removed; the caller re-erodes/re-trims (the goto
    loop, abyss.cc:96-112)."""
    if t.n == 0:
        return 0
    cs = _ChainStruct(t)
    mean = cs.covsum.astype(np.float64) / cs.lengths
    kill = cs.kept & (mean < c)
    segs = np.flatnonzero(kill)
    if len(segs):
        cs.kill(segs)
    return len(segs)


def assemble(t: KmerTable) -> list[tuple[str, int]]:
    """Extract maximal unambiguous unitigs (AssembleAlgorithm.h:45-142).

    Returns [(sequence, coverage_sum)] with each unitig reported once in
    canonical orientation.
    """
    if t.n == 0:
        return []
    cs = _ChainStruct(t)
    segs = np.flatnonzero(cs.kept)
    contigs = []
    seen = set()
    for s, cov in _emit_segments(cs, segs, canonical=True):
        if s in seen:
            continue
        seen.add(s)
        contigs.append((s, cov))
    return contigs


def multi_k_sweep(read_batches_fn, ks: list[int], kc: int = 2,
                  erode_cov: int = 2, device="cuda", **assemble_kw
                  ) -> list[tuple[str, int]]:
    """Multi-k sweep (ABYSS/abyss.cc:166-194): assemble at increasing k,
    feeding each round's contigs back as extra input sequences.

    read_batches_fn() must return a fresh iterator of [B, L] code
    batches over the reads.  Extra keyword args (tip_len, auto_coverage,
    min_mean_cov, bubble_len, ...) pass through to assemble_reads for
    every k in the sweep.
    """
    contigs: list[tuple[str, int]] = []
    for k in ks:
        extra = []
        if contigs:
            L = max(len(s) for s, _ in contigs)
            arr = np.full((len(contigs), L), 4, np.uint8)
            for i, (s, _) in enumerate(contigs):
                arr[i, :len(s)] = alphabet.encode(s)
            extra = [arr]
        batches = list(read_batches_fn()) + extra
        contigs, _ = assemble_reads(batches, k, kc=kc, erode_cov=erode_cov,
                                    device=device, **assemble_kw)
    return contigs


def assemble_reads(batches, k: int, kc: int = 2,
                   erode_cov: int | None = 2,
                   erode_strand: int | None = 0,
                   tip_len: int | None = None,
                   auto_coverage: bool = False,
                   auto_params: bool = False,
                   min_mean_cov: float | None = None,
                   bubble_len: int | None = None,
                   bubbles_out: list | None = None,
                   device="cuda",
                   ) -> tuple[list[tuple[str, int]], KmerTable]:
    """The full ABYSS-engine phase sequence (ABYSS/abyss.cc:58-133) on
    `device`: load -> coverage model -> kc filter -> adjacency -> erode
    -> trim -> [low-coverage-contig loop] -> pop bubbles -> assemble.

    min_mean_cov is the `c` parameter (drop contigs with mean coverage
    below it, then re-erode/re-trim, abyss.cc:96-112); bubble_len is the
    `b` parameter in k-mers (BubbleAlgorithm); popped branch sequences
    are appended to bubbles_out when given.  With auto_params, any of
    e/E/c left as None defaults the reference way from the coverage
    model (setCoverageParameters, CoverageAlgorithm.h:72-113).  The
    count is the span `hash.count`, the other phases assemble_table's."""
    strand = (erode_strand or 0) > 0 or (auto_params and
                                         erode_strand is None)
    batches = list(batches) if k > 32 else batches
    with trace.span("hash.count", device=True):
        t = count_kmers(batches, k, strand_counts=strand, wide_fill=False,
                        device=device)
    return assemble_table(
        t, kc=kc, erode_cov=erode_cov, erode_strand=erode_strand,
        tip_len=tip_len,
        auto_coverage=auto_coverage, auto_params=auto_params,
        min_mean_cov=min_mean_cov,
        bubble_len=bubble_len, bubbles_out=bubbles_out,
        wide_fill_batches=batches if k > 32 else None), t


def auto_coverage_params(h: Histogram) -> tuple[int, int, float]:
    """The reference's automatic e/E/c from the coverage histogram
    (setCoverageParameters, CoverageAlgorithm.h:72-113): minCov is the
    threshold fixpoint floored at 2; e = round(minCov), E = 0 when
    minCov <= 2 else 1, c = minCov."""
    thr = coverage_threshold(h)
    min_cov = max(2.0, thr) if thr > 0 else 2.0
    e = int(round(min_cov))
    E = 0 if min_cov <= 2 else 1
    return e, E, min_cov


def assemble_table(t: KmerTable, kc: int = 2,
                   erode_cov: int | None = 2,
                   erode_strand: int | None = 0,
                   tip_len: int | None = None, auto_coverage: bool = False,
                   auto_params: bool = False,
                   min_mean_cov: float | None = None,
                   bubble_len: int | None = None,
                   bubbles_out: list | None = None,
                   wide_fill_batches=None,
                   ) -> list[tuple[str, int]]:
    """Run the post-load phases on an existing table (e.g. one restored
    from a `.kmer` snapshot) on t.device.  wide_fill_batches: read
    batches for a deferred wide-mode side-array fill — run after the kc
    filter + compaction so only solid rows pay for text/hr/checksum.

    Each phase is a span: `hash.kc_filter` (with the coverage model),
    `hash.wide_fill`, `hash.adjacency`, `hash.erode`, `hash.trim`,
    `hash.lowcov` (the low-coverage loop with its erodes and trims),
    `hash.bubbles` and `hash.emit`."""
    k = t.k
    kc_eff = kc
    with trace.span("hash.kc_filter", device=True):
        if auto_coverage or (auto_params and (erode_cov is None or
                                              erode_strand is None or
                                              min_mean_cov is None)):
            h = coverage_histogram(t)
            if auto_coverage:
                thr = coverage_threshold(h)
                if thr > 0:
                    kc_eff = max(kc, int(round(thr)))
            if auto_params:
                e_auto, E_auto, c_auto = auto_coverage_params(h)
                if erode_cov is None:
                    erode_cov = e_auto
                if erode_strand is None:
                    erode_strand = E_auto
                if min_mean_cov is None:
                    min_mean_cov = c_auto
        if erode_cov is None:
            erode_cov = 2
        if erode_strand is None:
            erode_strand = 0
        apply_coverage_threshold(t, kc_eff)
        compact(t)   # later phases pay full-table cost for dead rows
    if t.k > 32 and t.text is None:
        if wide_fill_batches is None:
            raise RuntimeError(
                "wide table has no side arrays and no batches to fill "
                "them from; pass wide_fill_batches or count with "
                "wide_fill=True")
        with trace.span("hash.wide_fill", device=True):
            fill_wide_side(t, wide_fill_batches)
    with trace.span("hash.adjacency", device=True):
        build_adjacency(t)
    tip = tip_len if tip_len is not None else k
    with trace.span("hash.erode", device=True):
        erode(t, erode_cov, erode_strand)
    with trace.span("hash.trim", device=True):
        trim(t, tip)
    if min_mean_cov:
        with trace.span("hash.lowcov", device=True):
            while remove_low_coverage_contigs(t, min_mean_cov):
                erode(t, erode_cov, erode_strand)
                trim(t, tip)
    # default bubble bound: the reference pops bubbles shorter than
    # 3k BASES (Assembly/Options.cc:356-358), i.e. 3k - k + 1 = 2k+1
    # k-mers per branch (BubbleAlgorithm.h:57)
    # -b0 / --no-bubbles disables popping (Assembly/Options.cc:62,177):
    # a non-positive bubble_len means "off", only None means "default".
    blen = bubble_len if bubble_len is not None else 2 * k + 1
    with trace.span("hash.bubbles", device=True):
        popped = pop_bubbles_kmer(t, blen) if blen > 0 else []
    if bubbles_out is not None:
        bubbles_out.extend(popped)
    with trace.span("hash.emit", device=True):
        return assemble(t)
