"""Paired de Bruijn graph engine (the reference's K-mode).

Port of abyss_tpu/dbg/paired_dbg.py.  The vertex is a `KmerPair`: two
k-mers whose starts are K - k apart (PairedDBG/KmerPair.h:14), and an
edge carries a `Dinuc` (one base entering each sub-window, 16 symbols,
Dinuc.h:9).

Packed mode (k <= 16): both k-mers 2-bit-packed into one 64-bit word,
canonical against rc(pair(a, b)) = pair(rc(b), rc(a)).  At k = 16 a
pair uses all 64 bits, so every min, sort and search is unsigned
(u64.py).  Counting, the adjacency probe, the links, the trim rounds,
the chain order and the spelling of the chains run on the table's
device; the host dedups the spelled chains.

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
first occurrence off the device; the packed adjacency is direction-major
([32, N]) and stays on the device, and the packed trim rounds rank with
chain_ops' capped doubling (the JAX code's host doubling kills the same
rows).
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
# base codes 0-4 to text, and to the text of their complements
_SPELL = bytes.maketrans(bytes(range(5)), b"ACGTN")
_SPELL_RC = bytes.maketrans(bytes(range(5)), b"TGCAN")


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


def build_pair_adjacency(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """nbr int32[32, N] on the device of the sorted packed pairs
    `kmers`, direction-major: the right Dinuc (16) then the left Dinuc
    (16) neighbour row of each row, -1 when absent.  Dinuc (c1, c2)
    shifts base c1 into the a window and c2 into the b window (Dinuc.h
    semantics).  One column at a time, so the probe holds the pairs, its
    result and one column's candidates."""
    N = kmers.shape[0]
    nbr = torch.full((32, N), -1, dtype=torch.int32, device=kmers.device)
    if N == 0:
        return nbr
    keys = u64.flip(kmers)
    maskk = (1 << (2 * k)) - 1
    sh, top = 2 * k, 2 * (k - 1)
    a = u64.srl(kmers, sh)
    b = kmers & maskk
    for ci in range(32):
        c1, c2 = (ci % 16) >> 2, ci & 3
        if ci < 16:
            na = ((a << 2) | c1) & maskk
            nb = ((b << 2) | c2) & maskk
        else:
            na = u64.srl(a, 2) | (c1 << top)
            nb = u64.srl(b, 2) | (c2 << top)
        y = (na << sh) | nb
        cand = u64.umin(y, _rc_pair(y, k))
        idx = torch.searchsorted(keys, u64.flip(cand)).clamp_(max=N - 1)
        nbr[ci] = torch.where(kmers[idx] == cand, idx, -1)
    return nbr


def _zero_gap_gate(nbr: torch.Tensor, kmers: torch.Tensor, k: int) -> None:
    """removePairedDBGInconsistentEdges (PairedDBG/
    PairedDBGAlgorithms.h:10-41), in place: when the pair gap is exactly
    zero (span K == 2k) a right edge with Dinuc (c1, c2) is consistent
    only if c1 equals the source b-kmer's first base, and a left edge
    only if c2 equals the source a-kmer's last base."""
    din = torch.arange(16, device=nbr.device)[:, None]
    b_first = u64.srl(kmers, 2 * (k - 1)) & 3
    a_last = u64.srl(kmers, 2 * k) & 3
    nbr[:16].masked_fill_((din >> 2) != b_first, -1)
    nbr[16:].masked_fill_((din & 3) != a_last, -1)


def _pair_links(nbr, kmers, rc, palin, alive, k: int):
    """Unique-successor links of the packed pair graph: (right_deg,
    left_deg, nxt), nxt[2r + s] = 2 * tgt + tstrand.  A neighbour counts
    when it and the row are alive.  Row r links on strand s when it is
    alive, no palindrome and has one neighbour that way; the target's
    strand is 0 where its stored word is the walk's next pair, and the
    link holds where the target is no palindrome and has in-degree 1.
    A vertex may link to itself (a cycle of one)."""
    ok = (nbr >= 0) & alive[nbr.clamp(min=0)] & alive
    rd = ok[:16].sum(dim=0, dtype=torch.int32)
    ld = ok[16:].sum(dim=0, dtype=torch.int32)
    maskk = (1 << (2 * k)) - 1

    def one_strand(s):
        cols = slice(16 * s, 16 * s + 16)
        tgt, din = torch.where(ok[cols], nbr[cols], -1).max(dim=0)
        c1, c2 = din >> 2, din & 3
        word = kmers
        if s == 1:
            # a LEFT Dinuc (c1, c2) maps to the rc walk orientation as a
            # right Dinuc, components swapped and complemented
            word, c1, c2 = rc, 3 - c2, 3 - c1
        na = ((u64.srl(word, 2 * k) << 2) | c1) & maskk
        nb = (((word & maskk) << 2) | c2) & maskk
        tgt = tgt.long().clamp(min=0)
        same = kmers[tgt] == ((na << (2 * k)) | nb)
        t_in = torch.where(same, ld[tgt], rd[tgt])
        deg = rd if s == 0 else ld
        good = alive & (deg == 1) & ~palin & (t_in == 1) & ~palin[tgt]
        return torch.where(good, 2 * tgt + (~same).long(), -1)

    return rd, ld, chain_ops._interleave(one_strand(0), one_strand(1))


def _pair_trim_round(nxt, rd, ld, alive, counts, max_tip: int):
    """One trimSequences pass (TrimAlgorithm.h:38-99) over the pair
    graph's chains: chain_ops' round with the ranking capped at the tip
    bound.  It kills the rows the host round (a full ranking) kills:
    a chain longer than max_tip dies under neither, and a cycle's
    members, which the capped ranking leaves out, all have in-degree
    >= 1, so none heads a blunt chain.  Returns (new_alive,
    rows_removed)."""
    rounds_t = int(np.ceil(np.log2(max_tip))) if max_tip > 1 else 0
    return chain_ops._trim_round_impl(
        nxt, chain_ops._interleave(rd, ld), chain_ops._interleave(ld, rd),
        alive, counts, max_tip, rounds_t)


def _pair_chain_order(nxt, alive):
    """The alive oriented vertices in (chain head, position) order and
    the flags of the chains' first vertices, ranked as
    abyss_tpu.dbg.hash_dbg._pointer_double ranks on the host: a cycle of
    2^j oriented vertices, whose doubled pointers settle on themselves,
    leaves each member a one-vertex chain (the host form's fault,
    ROADMAP §C); any other cycle breaks at its minimum vertex.  Counts
    `paired.cycle_vertices`, the vertices on cycles, when tracing."""
    prev = chain_ops._prev_of(nxt)
    P, dist, conv, M = chain_ops._rank(prev, True)
    on_cycle = ~conv
    if trace.enabled():
        trace.count("paired.cycle_vertices", int(on_cycle.sum()))
    if bool(on_cycle.any()):
        iota = torch.arange(nxt.shape[0], device=nxt.device)
        cut = on_cycle & ((P == iota) | (M == iota))
        P, dist, _, _ = chain_ops._rank(torch.where(cut, -1, prev), False)
    alive_ov = alive.repeat_interleave(2)
    sk, ov_s = chain_ops._sorted_chain_keys(P, dist, alive_ov)
    a = int(alive_ov.sum())
    return ov_s[:a], (sk[:a] & 0xFFFFFFFF) == 0


def assemble_pairs(batches, k: int, K: int, kc: int = 2,
                   tip_len: int | None = None, device="cuda",
                   ) -> list[tuple[str, int]]:
    """Count pairs, build adjacency, trim tips (performTrim with the
    reference's default t = span), link unique successors, emit contigs
    (with 'N' for undetermined interior positions).  tip_len=0 disables
    trimming.  k > 16 goes to the wide mode (assemble_pairs_wide).

    After the count and the kc filter the graph of the solid rows stays
    on the table's device: the probe, the links, the trim rounds
    (chain_ops' capped ranking, one device-to-host read a round), the
    chain order and the spelling of the chains; the host dedups the
    spelled chains.

    Each phase is a span, under the wide mode's names: `paired.count`,
    `paired.kc_filter`, `paired.probe` (the adjacency), `paired.trim`
    (every round), `paired.chains` (the final links, ranks and order)
    and `paired.emission` (`_emit_packed_chains`).  Counters:
    `paired.rows` and `paired.rows_kc` (pair rows before and after the
    kc filter), `paired.trim_rounds`, `paired.cycle_vertices` and
    `paired.contigs`."""
    if k > 16:
        return assemble_pairs_wide(batches, k, K, kc=kc, tip_len=tip_len,
                                   device=device)
    with trace.span("paired.count", device=True):
        t = count_pairs(batches, k, K, device=device)
    dev = resolve_device(device)
    with trace.span("paired.kc_filter", device=True):
        # the graph holds the solid rows alone: a row below kc is never
        # alive, so no link, degree or chain sees it, and keeping the
        # rows in order keeps every vertex comparison (chain heads,
        # cycle minima) as it was
        counts = torch.from_numpy(t.counts).to(dev)
        keep = counts >= kc
        kmers = u64.from_numpy(t.kmers, dev)[keep]
        counts = counts[keep]
        N = kmers.shape[0]
        trace.count("paired.rows", t.n)
        trace.count("paired.rows_kc", N)
    if N >= chain_ops.MAX_ROWS:
        raise ValueError(f"{N} pair rows: oriented vertex ids "
                         f"2 * row + strand must fit in int32")
    with trace.span("paired.probe", device=True):
        nbr = build_pair_adjacency(kmers, k)
        if K == 2 * k:
            _zero_gap_gate(nbr, kmers, k)
        rc = _rc_pair(kmers, k)
        palin = rc == kmers
        alive = torch.ones(N, dtype=torch.bool, device=dev)
    max_tip = K if tip_len is None else tip_len
    with trace.span("paired.trim", device=True):
        rounds = 0
        if max_tip > 0:
            while True:
                rd, ld, nxt = _pair_links(nbr, kmers, rc, palin, alive, k)
                rounds += 1
                alive, removed = _pair_trim_round(nxt, rd, ld, alive,
                                                  counts, max_tip)
                if not int(removed):
                    break
        trace.count("paired.trim_rounds", rounds)
    with trace.span("paired.chains", device=True):
        nxt = _pair_links(nbr, kmers, rc, palin, alive, k)[2]
        del nbr
        ov_s, start = _pair_chain_order(nxt, alive)
    with trace.span("paired.emission", device=True):
        contigs = _emit_packed_chains(k, K, kmers, rc, counts, ov_s, start)
        trace.count("paired.contigs", len(contigs))
    return contigs


def _emit_packed_chains(k: int, K: int, kmers, rc, counts, ov_s, start
                        ) -> list[tuple[str, int]]:
    """Each chain's sequence and coverage (the sum of its rows' counts),
    deduped by canonical sequence: [(sequence, coverage)].  `ov_s` lists
    the chains' oriented vertices head by head, `start` flags each
    chain's first.

    The chains are spelled on the device into one buffer of L - 1 + K
    bases a chain of L vertices, from each vertex's pair in walk
    orientation (the stored word on strand 0, rc on strand 1): writing
    every vertex's a window, then its b window, in chain order leaves at
    position p the a-window base of vertex min(p, L - 1) where that
    window covers p, else the b-window base of vertex
    min(p - (K - k), L - 1) where that covers p, else N.  The buffer
    crosses to the host once; the host loop runs over chains."""
    A = ov_s.shape[0]
    if A == 0:
        # the JAX package spells one chain of no vertex when no row is
        # left: K - 1 bases, none fixed (ROADMAP §C)
        return [("N" * (K - 1), 0)]
    dev = ov_s.device
    sidx = torch.nonzero(start).squeeze(1)
    last = torch.cat([sidx[1:], sidx.new_full((1,), A)]) - 1
    n_out = last - sidx + K
    ends = torch.cumsum(n_out, 0)
    total = int(ends[-1])
    cid = torch.repeat_interleave(
        torch.arange(sidx.shape[0], device=dev), n_out, output_size=total)
    p = torch.arange(total, device=dev) - (ends - n_out)[cid]
    first, span_l = sidx[cid], (last - sidx)[cid]
    ja = torch.minimum(p, span_l)
    jb = torch.minimum(p - (K - k), span_l)
    oa = p - ja
    ob = p - (K - k) - jb

    def word(j):
        v = ov_s[first + j]
        return torch.where((v & 1) == 1, rc[v >> 1], kmers[v >> 1])

    base_a = (word(ja) >> (2 * (2 * k - 1 - oa).clamp(min=k))) & 3
    base_b = (word(jb.clamp(min=0)) >> (2 * (k - 1 - ob))) & 3
    buf = torch.where(oa < k, base_a, torch.where(jb >= 0, base_b, 4))
    cs = torch.cumsum(counts[ov_s >> 1].long(), 0)
    cov = cs[last] - cs[sidx] + counts[ov_s[sidx] >> 1]

    raw = buf.to(torch.uint8).cpu().numpy().tobytes()
    seqs = raw.translate(_SPELL).decode("ascii")
    rcs = raw[::-1].translate(_SPELL_RC).decode("ascii")
    contigs = []
    seen = set()
    for e, n, c in zip(ends.tolist(), n_out.tolist(), cov.tolist()):
        seq = seqs[e - n:e]
        canon = min(seq, rcs[total - e:total - e + n])
        if canon in seen:
            continue
        seen.add(canon)
        contigs.append((canon, c))
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
