"""Paired de Bruijn graph engine (the reference's K-mode).

Port of abyss_tpu/dbg/paired_dbg.py.  The vertex is a `KmerPair`: two
k-mers whose starts are K - k apart (PairedDBG/KmerPair.h:14), and an
edge carries a `Dinuc` (one base entering each sub-window, 16 symbols,
Dinuc.h:9).

Packed mode (k <= 16): both k-mers 2-bit-packed into one 64-bit word,
canonical against rc(pair(a, b)) = pair(rc(b), rc(a)).  At k = 16 a
pair uses all 64 bits, so every min, sort and search is unsigned
(u64.py).  Counting and the adjacency probe run on the table's device;
trimming, linking and emission are host numpy, as in the JAX package.

Wide mode (k > 16): the key is a 64-bit pair fingerprint mixed from the
two k-mers' ntHash values (the ntHash kernel with its strand outputs on
the card), side arrays carry each pair's hash states and packed text,
and the 32-column Dinuc probe, the trim rounds and the chain
decomposition run on the device (`DevicePairDBG`, reusing
dbg/chain_ops).

Every entry point takes `device` ("cuda" by default; without a card it
raises unless "cpu").  Differences from the JAX code, none visible in a
result: uint64 words are int64 tensors with the same bits; the `ts`
strand field (32 columns) is int64, since bit 31 is an int32's sign;
the successor links are int64; the fill gathers only each new row's
first occurrence off the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, u64
from ..core import alphabet
from ..ops import nthash
from ..utils import trace
from . import chain_ops, hash_dbg
from .hash_dbg import KmerTable

_PAIR_MUL = u64.s64(0x9E3779B97F4A7C15)


def pack_pairs(codes: torch.Tensor, k: int, K: int):
    """Pack every (a, b) k-mer pair window of [B, L] codes: a at i,
    b at i + K - k.  Returns (fwd, rc, canon, valid), int64[B, W]."""
    if k > 16:
        raise ValueError(f"paired engine needs k <= 16, got {k}")
    if K < 2 * k:
        raise ValueError(f"span K must be >= 2k, got K={K} k={k}")
    L = codes.shape[-1]
    W = L - K + 1
    if W <= 0:
        raise ValueError(f"read length {L} < K={K}")
    fa, ra, _, va = hash_dbg.pack_kmers(codes, k)
    off = K - k
    fb, rb, vb = fa[..., off:off + W], ra[..., off:off + W], \
        va[..., off:off + W]
    fa, ra, va = fa[..., :W], ra[..., :W], va[..., :W]
    fwd = (fa << (2 * k)) | fb
    rc = (rb << (2 * k)) | ra  # rc(pair(a,b)) = (rc(b), rc(a))
    return fwd, rc, u64.umin(fwd, rc), va & vb


def unpack_pair(packed: int, k: int) -> tuple[str, str]:
    b = packed & ((1 << (2 * k)) - 1)
    a = packed >> (2 * k)
    return hash_dbg.unpack_kmer(a, k), hash_dbg.unpack_kmer(b, k)


def count_pairs(batches, k: int, K: int, device="cuda") -> KmerTable:
    """K-mode pair counting through the streaming sorted counter
    (ops/sorted_filter.SortedKmerCounter) on `device`."""
    from ..ops.sorted_filter import SortedKmerCounter
    dev = resolve_device(device)
    ctr = SortedKmerCounter(k, threshold=1)
    for codes in batches:
        _, _, canon, valid = pack_pairs(hash_dbg._to_device(codes, dev),
                                        k, K)
        ctr.add(canon.reshape(-1), valid.reshape(-1))
    kmers, cnts = hash_dbg._finalized(ctr)
    counts = np.minimum(cnts, hash_dbg.COVERAGE_MAX).astype(np.int32)
    return KmerTable(k, kmers, counts, np.ones(len(kmers), bool),
                     device=str(device))


def _rc_pair(x: torch.Tensor, k: int) -> torch.Tensor:
    """Pair reverse complement of packed pairs."""
    b = x & ((1 << (2 * k)) - 1)
    a = u64.srl(x, 2 * k)
    return (chain_ops._rc_packed(b, k) << (2 * k)) | \
        chain_ops._rc_packed(a, k)


def _rc_pair_host(x: np.ndarray, k: int) -> np.ndarray:
    return u64.to_numpy(_rc_pair(u64.from_numpy(x), k))


def build_pair_adjacency(t: KmerTable, k: int) -> np.ndarray:
    """nbr int32[N, 32]: right Dinuc (16) then left Dinuc (16) neighbour
    rows, -1 when absent.  Dinuc (c1, c2) shifts base c1 into the a
    window and c2 into the b window (Dinuc.h semantics)."""
    N = t.n
    if N == 0:
        return np.zeros((0, 32), np.int32)
    kmers = u64.from_numpy(t.kmers, resolve_device(t.device))
    maskk = (1 << (2 * k)) - 1
    sh = 2 * k
    a = u64.srl(kmers, sh)
    b = kmers & maskk
    cols = []
    for c1 in range(4):
        for c2 in range(4):
            na = ((a << 2) | c1) & maskk
            nb = ((b << 2) | c2) & maskk
            y = (na << sh) | nb
            cols.append(u64.umin(y, _rc_pair(y, k)))
    top = 2 * (k - 1)
    for c1 in range(4):
        for c2 in range(4):
            na = u64.srl(a, 2) | (c1 << top)
            nb = u64.srl(b, 2) | (c2 << top)
            y = (na << sh) | nb
            cols.append(u64.umin(y, _rc_pair(y, k)))
    cand = torch.stack(cols, dim=1)
    idx = u64.usearchsorted(kmers, cand.reshape(-1)).reshape(N, 32)
    idx = idx.clamp(max=N - 1)
    hit = kmers[idx] == cand
    return torch.where(hit, idx, -1).to(torch.int32).cpu().numpy()


def _filter_inconsistent_zero_gap(nbr: np.ndarray, b_first: np.ndarray,
                                  a_last: np.ndarray) -> np.ndarray:
    """removePairedDBGInconsistentEdges (PairedDBG/
    PairedDBGAlgorithms.h:10-41): when the pair gap is exactly zero
    (span K == 2k) a right edge with Dinuc (c1, c2) is consistent only
    if c1 equals the source b-kmer's first base, and a left edge only if
    c2 equals the source a-kmer's last base."""
    cols = np.arange(16)
    c1 = cols >> 2
    c2 = cols & 3
    out = nbr.copy()
    out[:, :16] = np.where(c1[None, :] == b_first[:, None],
                           out[:, :16], -1)
    out[:, 16:] = np.where(c2[None, :] == a_last[:, None],
                           out[:, 16:], -1)
    return out


def _chain_trim_round(alive: np.ndarray, nxt: np.ndarray,
                      right_deg: np.ndarray, left_deg: np.ndarray,
                      max_tip: int) -> int:
    """One trimSequences pass over the pair graph's chain decomposition
    (TrimAlgorithm.h:38-99): a chain whose head is blunt, whose length
    is <= max_tip pair-vertices, and whose walk ended for a removing
    reason dies; islands die unconditionally.  Ranks with the host
    hash_dbg._pointer_double, as the JAX package does (with its fault
    on cycles of 2^j vertices, ROADMAP §C)."""
    N = len(alive)
    outdeg = np.empty(2 * N, np.int64)
    outdeg[0::2] = right_deg
    outdeg[1::2] = left_deg
    indeg = outdeg[np.arange(2 * N) ^ 1]
    head, pos = hash_dbg._pointer_double(nxt)
    alive_ov = np.repeat(alive, 2)
    order = np.argsort((head.astype(np.uint64) << np.uint64(32))
                       | pos.astype(np.uint64), kind="stable")
    order = order[alive_ov[order]]
    if not len(order):
        return 0
    heads = head[order]
    b = np.nonzero(np.concatenate([[True], heads[1:] != heads[:-1]]))[0]
    e = np.concatenate([b[1:], [len(order)]])
    headv = order[b]
    endv = order[e - 1]
    length = e - b
    kill = (indeg[headv] == 0) & (length <= max_tip) & \
        (outdeg[endv] <= 1)
    if not kill.any():
        return 0
    rows = np.unique(order[np.repeat(kill, length)] >> 1)
    alive[rows] = False
    return len(rows)


def assemble_pairs(batches, k: int, K: int, kc: int = 2,
                   tip_len: int | None = None, device="cuda",
                   ) -> list[tuple[str, int]]:
    """Count pairs, build adjacency, trim tips (performTrim with the
    reference's default t = span), link unique successors, emit contigs
    (with 'N' for undetermined interior positions).  tip_len=0 disables
    trimming.  k > 16 goes to the wide mode (assemble_pairs_wide).

    Each phase is a span, under the wide mode's names: `paired.count`,
    `paired.kc_filter`, `paired.probe` (the adjacency), `paired.trim`
    (every round), `paired.chains` (the final links, ranks and order)
    and `paired.emission` (`_emit_packed_chains`).  Counters:
    `paired.rows` and `paired.rows_kc` (pair rows before and after the
    kc filter), `paired.trim_rounds` and `paired.contigs`."""
    if k > 16:
        return assemble_pairs_wide(batches, k, K, kc=kc, tip_len=tip_len,
                                   device=device)
    with trace.span("paired.count", device=True):
        t = count_pairs(batches, k, K, device=device)
    with trace.span("paired.kc_filter"):
        t.alive &= t.counts >= kc
        if trace.enabled():
            trace.count("paired.rows", t.n)
            trace.count("paired.rows_kc", int(t.alive.sum()))
    with trace.span("paired.probe"):
        nbr = build_pair_adjacency(t, k)
        if K == 2 * k:
            b_first = ((t.kmers >> np.uint64(2 * (k - 1))) &
                       np.uint64(3)).astype(np.uint8)
            a_last = ((t.kmers >> np.uint64(2 * k)) &
                      np.uint64(3)).astype(np.uint8)
            nbr = _filter_inconsistent_zero_gap(nbr, b_first, a_last)
    N = t.n
    alive = t.alive
    rc = _rc_pair_host(t.kmers, k)
    palin = rc == t.kmers
    maskk = (1 << (2 * k)) - 1

    def build_links():
        ok = (nbr >= 0) & np.where(nbr >= 0,
                                   alive[np.maximum(nbr, 0)], False)
        ok &= alive[:, None]
        right_deg = ok[:, :16].sum(axis=1)
        left_deg = ok[:, 16:].sum(axis=1)
        nxt = np.full(2 * N, -1, np.int64)
        for strand in (0, 1):
            deg = right_deg if strand == 0 else left_deg
            cols = slice(0, 16) if strand == 0 else slice(16, 32)
            rows = np.nonzero(alive & (deg == 1) & ~palin)[0]
            if not len(rows):
                continue
            sub = np.where(ok[rows, cols], nbr[rows, cols], -1)
            tgt = sub.max(axis=1)
            din = np.argmax(sub, axis=1)  # dinuc index c1*4+c2
            c1, c2 = din >> 2, din & 3
            x = t.kmers[rows]
            if strand == 0:
                a = x >> np.uint64(2 * k)
                b = x & np.uint64(maskk)
                na = ((a << np.uint64(2)) | c1.astype(np.uint64)) & \
                    np.uint64(maskk)
                nb = ((b << np.uint64(2)) | c2.astype(np.uint64)) & \
                    np.uint64(maskk)
            else:
                xr = _rc_pair_host(x, k)
                a = xr >> np.uint64(2 * k)
                b = xr & np.uint64(maskk)
                # a LEFT Dinuc (c1, c2) maps to the rc walk orientation
                # as a right Dinuc, components swapped and complemented
                na = ((a << np.uint64(2)) | (3 - c2).astype(np.uint64)) & \
                    np.uint64(maskk)
                nb = ((b << np.uint64(2)) | (3 - c1).astype(np.uint64)) & \
                    np.uint64(maskk)
            y = ((na << np.uint64(2 * k)) | nb).astype(np.uint64)
            same = t.kmers[tgt] == y
            tstrand = np.where(same, 0, 1)
            t_in = np.where(tstrand == 0, left_deg[tgt], right_deg[tgt])
            good = (t_in == 1) & ~palin[tgt]
            src = 2 * rows + strand
            nxt[src[good]] = (2 * tgt + tstrand)[good]
        return right_deg, left_deg, nxt

    max_tip = K if tip_len is None else tip_len
    with trace.span("paired.trim"):
        rounds = 0
        while max_tip > 0:
            rd, ld, nxt = build_links()
            rounds += 1
            if not _chain_trim_round(alive, nxt, rd, ld, max_tip):
                break
        trace.count("paired.trim_rounds", rounds)
    with trace.span("paired.chains"):
        right_deg, left_deg, nxt = build_links()
        head, pos = hash_dbg._pointer_double(nxt)
        alive_ov = np.repeat(alive, 2)
        order = np.lexsort((pos, head))
        order = order[alive_ov[order]]
        heads = head[order]
        bounds = np.nonzero(np.concatenate([[True],
                                            heads[1:] != heads[:-1]]))[0]
    with trace.span("paired.emission"):
        contigs = _emit_packed_chains(t, k, K, rc, order, bounds)
        trace.count("paired.contigs", len(contigs))
    return contigs


def _emit_packed_chains(t: KmerTable, k: int, K: int, rc: np.ndarray,
                        order: np.ndarray, bounds: np.ndarray
                        ) -> list[tuple[str, int]]:
    """Each chain's sequence, spelled from its rows' pairs (rc[r] where
    the chain walks row r on its reverse strand; 'N' where no pair fixes
    a base), deduped by canonical sequence: [(sequence, coverage)].
    `order` lists the chains' oriented vertices head by head, each
    chain starting at `bounds`."""
    contigs = []
    seen = set()
    span = K
    for bi, s in enumerate(bounds):
        e = bounds[bi + 1] if bi + 1 < len(bounds) else len(order)
        chain = order[s:e]
        rows_, strands = chain >> 1, chain & 1
        buf = np.full(len(chain) - 1 + span, 4, np.uint8)
        for j, (r, st) in enumerate(zip(rows_, strands)):
            x = int(t.kmers[r]) if st == 0 else int(rc[r])
            astr, bstr = unpack_pair(x, k)
            buf[j:j + k] = alphabet.encode(astr)
            buf[j + span - k:j + span] = alphabet.encode(bstr)
        seq = alphabet.decode(buf)
        canon = min(seq, alphabet.revcomp(seq))
        if canon in seen:
            continue
        seen.add(canon)
        contigs.append((canon, int(t.counts[rows_].sum())))
    return contigs


# --------------------------------------------------------------------------
# wide pair mode (k > 16): fingerprint-keyed pairs, any k / any span


@dataclass
class PairTable:
    k: int
    K: int
    keys: np.ndarray       # uint64[N] sorted canonical pair fingerprints
    counts: np.ndarray     # int32[N]
    alive: np.ndarray      # bool[N]
    fa: np.ndarray         # uint64[N] fwd ntHash of a (stored orientation)
    ra: np.ndarray         # uint64[N] reverse-strand ntHash of a
    fb: np.ndarray         # uint64[N]
    rb: np.ndarray         # uint64[N]
    text: np.ndarray       # uint8[N, ceil(2k/4)] packed a then b
    device: str = "cuda"   # where the table's device programs run

    @property
    def n(self):
        return len(self.keys)


def _mix_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Asymmetric 64-bit combiner of two k-mer hashes (order matters:
    pair(a,b) != pair(b,a))."""
    rot = (x << 21) | u64.srl(x, 43)
    return rot ^ (y * _PAIR_MUL)


def _pair_fp(fa, ra, fb, rb):
    """(fwd fingerprint, rc fingerprint, canonical) of pair hashes."""
    F = _mix_pair(fa, fb)
    R = _mix_pair(rb, ra)   # rc(pair) = (rc(b), rc(a)); fh(rc(x)) = rh(x)
    return F, R, u64.umin(F, R)


def _pair_hashes(codes: torch.Tensor, k: int, K: int):
    """(fa, ra, va, fb, rb, vb) of every pair window: one ntHash launch
    with strand outputs on the card."""
    off = K - k
    W = codes.shape[-1] - K + 1
    fh, rh, _, v = nthash.kmer_hashes(codes, k)
    return (fh[..., :W], rh[..., :W], v[..., :W],
            fh[..., off:off + W], rh[..., off:off + W], v[..., off:off + W])


def _pair_canon_batch(codes: torch.Tensor, k: int, K: int) -> torch.Tensor:
    """Masked canonical pair fingerprints of one batch (all-ones where a
    window holds a non-ACGT code), flattened."""
    fa, ra, va, fb, rb, vb = _pair_hashes(codes, k, K)
    _, _, canon = _pair_fp(fa, ra, fb, rb)
    return torch.where(va & vb, canon, u64.ALL_ONES).reshape(-1)


def _pair_fill_batch(codes: torch.Tensor, k: int, K: int):
    """Per-batch fill quantities (canon, valid, is_fwd, fa, ra, fb, rb),
    flattened and kept on the device."""
    fa, ra, va, fb, rb, vb = _pair_hashes(codes, k, K)
    F, R, canon = _pair_fp(fa, ra, fb, rb)
    return (canon.reshape(-1), (va & vb).reshape(-1),
            (F == canon).reshape(-1), fa.reshape(-1), ra.reshape(-1),
            fb.reshape(-1), rb.reshape(-1))


def count_pairs_wide(batches, k: int, K: int, kc: int = 1,
                     device="cuda") -> PairTable:
    """Count pair fingerprints, apply the kc filter, then fill the side
    arrays from each surviving fingerprint's first occurrence (the
    deferred fill: most distinct pairs are sub-threshold error pairs).
    Only each batch's `need` mask and its new rows' first occurrences
    cross to the host.  The phases are the spans `paired.count`,
    `paired.kc_filter` and `paired.fill`; the counters `paired.rows`
    and `paired.rows_kc` hold the pair rows before and after the kc
    filter."""
    from ..ops.sorted_filter import SortedKmerCounter
    dev = resolve_device(device)
    batches = [np.ascontiguousarray(b, np.uint8) for b in batches]
    with trace.span("paired.count", device=True):
        ctr = SortedKmerCounter(k, threshold=1)
        for codes in batches:
            if codes.shape[-1] - K + 1 <= 0:
                continue
            ctr.add(_pair_canon_batch(hash_dbg._to_device(codes, dev), k,
                                      K))
        keys, cnts = hash_dbg._finalized(ctr)
    with trace.span("paired.kc_filter", device=True):
        counts = np.minimum(cnts, hash_dbg.COVERAGE_MAX).astype(np.int32)
        trace.count("paired.rows", len(keys))
        if kc > 1:
            keep = counts >= kc
            keys, counts = keys[keep], counts[keep]
        N = len(keys)
        trace.count("paired.rows_kc", N)
    TB = (2 * k + 3) // 4
    t = PairTable(k, K, keys, counts, np.ones(N, bool),
                  np.zeros(N, np.uint64), np.zeros(N, np.uint64),
                  np.zeros(N, np.uint64), np.zeros(N, np.uint64),
                  np.zeros((N, TB), np.uint8), device=str(device))
    if N:
        with trace.span("paired.fill", device=True):
            _fill_pair_side(t, keys, batches, dev)
    return t


def _fill_pair_side(t: PairTable, keys: np.ndarray, batches: list,
                    dev: torch.device) -> None:
    """The side arrays (hashes and packed text) of each row of t, from
    the first occurrence of its fingerprint in `batches`."""
    k, K, N = t.k, t.K, len(keys)
    filled = np.zeros(N, bool)
    keys_dev = u64.from_numpy(keys, dev)
    keys_key = u64.flip(keys_dev).contiguous()
    filled_dev = torch.zeros(N, dtype=torch.bool, device=dev)
    off = K - k
    for codes in batches:
        L = codes.shape[-1]
        W = L - K + 1
        if W <= 0:
            continue
        canon_d, valid_d, isfwd_d, fa_d, ra_d, fb_d, rb_d = \
            _pair_fill_batch(hash_dbg._to_device(codes, dev), k, K)
        rows_d = torch.searchsorted(keys_key, u64.flip(canon_d)).clamp(
            max=N - 1)
        need_d = valid_d & (keys_dev[rows_d] == canon_d) & \
            ~filled_dev[rows_d]
        need = need_d.cpu().numpy()
        if not need.any():
            if filled.all():
                break
            continue
        # first occurrence per row wins
        occ = np.nonzero(need)[0]
        occ_d = torch.from_numpy(occ).to(dev)
        rows_occ = rows_d[occ_d].cpu().numpy()
        uniq, first_i = np.unique(rows_occ, return_index=True)
        src_u = occ[first_i]
        rows_u = uniq
        src_d = torch.from_numpy(src_u).to(dev)
        fa_f, ra_f, fb_f, rb_f = (u64.to_numpy(x[src_d])
                                  for x in (fa_d, ra_d, fb_d, rb_d))
        fwd_here = isfwd_d[src_d].cpu().numpy()
        # hashes in the STORED (canonical) orientation: when the rc
        # fingerprint won, the stored pair is (rc(b), rc(a))
        t.fa[rows_u] = np.where(fwd_here, fa_f, rb_f)
        t.ra[rows_u] = np.where(fwd_here, ra_f, fb_f)
        t.fb[rows_u] = np.where(fwd_here, fb_f, ra_f)
        t.rb[rows_u] = np.where(fwd_here, rb_f, fa_f)
        # packed text of (a, b) in stored orientation, gathered from a
        # strided view of the batch (no copy of every window)
        read_i, win = np.divmod(src_u, W)
        view = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1)
        awin = view[read_i, win]
        bwin = view[read_i, win + off]
        arc = (3 - bwin[:, ::-1]).astype(np.uint8)
        brc = (3 - awin[:, ::-1]).astype(np.uint8)
        both = np.concatenate(
            [np.where(fwd_here[:, None], awin, arc),
             np.where(fwd_here[:, None], bwin, brc)],
            axis=1).astype(np.uint8)
        t.text[rows_u] = hash_dbg.pack_text(both, 2 * k)
        filled[rows_u] = True
        filled_dev[torch.from_numpy(rows_u).to(dev)] = True


def _pair_end_bases(t: PairTable):
    """(a_first, a_last, b_first, b_last) base codes from the packed
    text."""
    k = t.k

    def base_at(j):
        return (t.text[:, j // 4] >> (6 - 2 * (j % 4))) & 3

    return (base_at(0).astype(np.uint8),
            base_at(k - 1).astype(np.uint8),
            base_at(k).astype(np.uint8),
            base_at(2 * k - 1).astype(np.uint8))


def _probe_col_hashes(k: int, right: bool, fa, ra, fb, rb, a_end, b_end,
                      c1: int, c2: int):
    """Rolled fingerprints of ONE Dinuc column: (walk-orientation match
    key, canonical).  Right edges walk the stored orientation (forward
    mix), left edges the rc (rc mix), so `keys[tgt] == match_key` is
    the host build_links `same` test."""
    c1b = torch.full_like(a_end, c1)
    c2b = torch.full_like(b_end, c2)
    roll = nthash.roll_right if right else nthash.roll_left
    fa2, ra2 = roll(fa, ra, k, a_end, c1b)
    fb2, rb2 = roll(fb, rb, k, b_end, c2b)
    F, R, canon = _pair_fp(fa2, ra2, fb2, rb2)
    return (F if right else R), canon


def _col_post(keys, rows, match_key, gate):
    """Gated neighbour row of one column and the walk-orientation strand
    bit of the target."""
    rows = torch.where(gate, rows.long(), -1)
    same = (rows >= 0) & (keys[rows.clamp(min=0)] == match_key)
    return rows, same


def _pair_probe_dev(t: PairTable, zero_gap: bool, dev: torch.device):
    """Device 32-column Dinuc neighbour probe: (nbr int64[32, N], ts
    int64[N]), ts bit ci set where the column-ci neighbour is stored in
    the walk orientation.  One join per column: a stacked [N, 32]
    candidate tensor runs out of memory at tens of millions of pairs."""
    from ..ops.sort_join import join_rows

    k = t.k
    a_first, a_last, b_first, b_last = (
        torch.from_numpy(x).to(dev) for x in _pair_end_bases(t))
    fa, ra, fb, rb = (u64.from_numpy(x, dev)
                      for x in (t.fa, t.ra, t.fb, t.rb))
    keys_dev = u64.from_numpy(t.keys, dev)
    nbr_cols = []
    ts = torch.zeros(t.n, dtype=torch.int64, device=dev)
    for ci in range(32):
        right = ci < 16
        c1, c2 = (ci % 16) >> 2, ci & 3
        mk, canon = _probe_col_hashes(
            k, right, fa, ra, fb, rb, a_first if right else a_last,
            b_first if right else b_last, c1, c2)
        rows = join_rows(keys_dev, canon)
        # zero-gap consistency (removePairedDBGInconsistentEdges,
        # PairedDBG/PairedDBGAlgorithms.h:10-41)
        if zero_gap:
            gate = (b_first == c1) if right else (a_last == c2)
        else:
            gate = torch.ones(t.n, dtype=torch.bool, device=dev)
        rows, same = _col_post(keys_dev, rows, mk, gate)
        nbr_cols.append(rows)
        ts = ts | (same.to(torch.int64) << ci)
    return torch.stack(nbr_cols), ts


def _pair_degrees(nbr32, alive):
    ok = (nbr32 >= 0) & alive[nbr32.clamp(min=0)]
    return ok, ok[:16].sum(dim=0, dtype=torch.int32), \
        ok[16:].sum(dim=0, dtype=torch.int32)


def _nxt_pair(nbr32, ts32, palin, alive):
    """Unique-successor links of the pair graph, with target strands
    read off the probe-time ts bits.  argmax takes the first maximum,
    as jnp.argmax does."""
    ok, rd, ld = _pair_degrees(nbr32, alive)

    def one_strand(strand):
        cols = nbr32[:16] if strand == 0 else nbr32[16:]
        okc = ok[:16] if strand == 0 else ok[16:]
        sub = torch.where(okc, cols, -1)
        tgt = sub.max(dim=0).values
        ci = sub.argmax(dim=0) + (0 if strand == 0 else 16)
        tgt_c = tgt.clamp(min=0)
        same = ((ts32 >> ci) & 1).bool()
        tstrand = torch.where(same, 0, 1)
        deg = rd if strand == 0 else ld
        t_in = torch.where(same, ld[tgt_c], rd[tgt_c])
        good = alive & (deg == 1) & ~palin & (tgt >= 0) & \
            (t_in == 1) & ~palin[tgt_c]
        return torch.where(good, 2 * tgt_c + tstrand, -1)

    return chain_ops._interleave(one_strand(0), one_strand(1))


class DevicePairDBG:
    """Device-resident pair-graph chain phases on the table's device,
    reusing chain_ops' capped-rank trim and sorted chain decomposition."""

    def __init__(self, t: PairTable, zero_gap: bool):
        if t.n >= chain_ops.MAX_ROWS:
            raise ValueError(f"{t.n} pair rows: oriented vertex ids "
                             f"2 * row + strand must fit in int32")
        dev = resolve_device(t.device)
        self.t = t
        self.nbr_d, self.ts_d = _pair_probe_dev(t, zero_gap, dev)
        fa, ra, fb, rb = (u64.from_numpy(x, dev)
                          for x in (t.fa, t.ra, t.fb, t.rb))
        self.palin_d = _mix_pair(fa, fb) == _mix_pair(rb, ra)
        self.alive_d = torch.from_numpy(np.array(t.alive, bool)).to(dev)
        self.counts_d = torch.from_numpy(np.asarray(t.counts)).to(dev)

    def _nxt(self):
        return _nxt_pair(self.nbr_d, self.ts_d, self.palin_d, self.alive_d)

    def _deg_ov(self):
        _, rd, ld = _pair_degrees(self.nbr_d, self.alive_d)
        return chain_ops._interleave(rd, ld), chain_ops._interleave(ld, rd)

    def trim(self, max_tip: int) -> int:
        """Trim rounds to the fixpoint; one device-to-host read a round."""
        if max_tip <= 0:
            return 0
        rounds_t = max(int(np.ceil(np.log2(max_tip))), 0) \
            if max_tip > 1 else 0
        total = rounds = 0
        while True:
            outdeg, indeg = self._deg_ov()
            self.alive_d, removed = chain_ops._trim_round_impl(
                self._nxt(), outdeg, indeg, self.alive_d, self.counts_d,
                max_tip, rounds_t)
            rounds += 1
            removed = int(removed)
            if removed == 0:
                trace.count("paired.trim_rounds", rounds)
                return total
            total += removed

    def chains(self):
        """(ov_s, sidx, lengths): the sorted alive oriented vertices,
        segment starts and chain lengths (one copy of the alive
        prefix)."""
        ov_s_d, start_d, cnt_d = chain_ops._chains_sorted_dev(
            self._nxt(), self.alive_d)
        a = int(cnt_d)
        if a == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        ov_s = ov_s_d[:a].to(torch.int32).cpu().numpy()
        start = start_d[:a].cpu().numpy()
        sidx = np.flatnonzero(start)
        lengths = np.diff(np.append(sidx, a))
        return ov_s, sidx, lengths


def assemble_pairs_wide(batches, k: int, K: int, kc: int = 2,
                        tip_len: int | None = None, device="cuda",
                        ) -> list[tuple[str, int]]:
    """Wide-mode paired assembly: count, kc filter and fill, the device
    probe, trim (performTrim, default t = span) and chain decomposition,
    then host emission.  Each phase is a span: count_pairs_wide's, then
    `paired.probe`, `paired.trim`, `paired.chains` and
    `paired.emission`, and the counters `paired.trim_rounds` and
    `paired.contigs`, as in the packed mode."""
    t = count_pairs_wide(batches, k, K, kc=kc, device=device)
    t.alive &= t.counts >= kc
    if t.n == 0:
        return []
    with trace.span("paired.probe", device=True):
        d = DevicePairDBG(t, zero_gap=(K == 2 * k))
    max_tip = K if tip_len is None else tip_len
    with trace.span("paired.trim", device=True):
        if max_tip > 0:
            d.trim(max_tip)
            t.alive = d.alive_d.cpu().numpy().copy()
    with trace.span("paired.chains", device=True):
        ov_s, sidx, lengths = d.chains()
    with trace.span("paired.emission"):
        contigs = _emit_pair_chains(t, k, K, ov_s, sidx, lengths)
        trace.count("paired.contigs", len(contigs))
    return contigs


def _emit_pair_chains(t: PairTable, k: int, K: int, ov_s, sidx,
                      lengths) -> list[tuple[str, int]]:
    """Each chain's sequence from its rows' packed text, deduped by
    canonical sequence: [(sequence, coverage)]."""
    # unpack the packed text of alive rows once: [M, 2k] base codes
    alive_rows = np.flatnonzero(t.alive)
    inv = np.full(t.n, -1, np.int64)
    inv[alive_rows] = np.arange(len(alive_rows))
    jj = np.arange(2 * k)
    codes2k = ((t.text[alive_rows][:, jj // 4] >>
                (6 - 2 * (jj % 4))) & 3).astype(np.uint8)

    contigs = []
    seen = set()
    cols_k = np.arange(k)
    for s, L in zip(sidx, lengths):
        chain = ov_s[s:s + L]
        rows_, strands = chain >> 1, chain & 1
        cw = codes2k[inv[rows_]]                      # [L, 2k]
        a_codes = np.where(strands[:, None] == 0, cw[:, :k],
                           3 - cw[:, k:][:, ::-1])
        b_codes = np.where(strands[:, None] == 0, cw[:, k:],
                           3 - cw[:, :k][:, ::-1])
        buf = np.full(int(L) - 1 + K, 4, np.uint8)
        # every b write precedes any later a write; duplicate positions
        # within one fancy assignment only carry agreeing values
        j = np.arange(int(L))
        buf[(j[:, None] + K - k + cols_k[None, :]).ravel()] = \
            b_codes.ravel()
        buf[(j[:, None] + cols_k[None, :]).ravel()] = a_codes.ravel()
        seq = alphabet.decode(buf)
        canon = min(seq, alphabet.revcomp(seq))
        if canon in seen:
            continue
        seen.add(canon)
        contigs.append((canon, int(t.counts[rows_].sum())))
    return contigs
