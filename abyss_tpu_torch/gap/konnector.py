"""Konnector: connect read pairs through the Bloom-filter de Bruijn
graph, producing pseudo-long reads.

Port of abyss_tpu/gap/konnector.py: `connectPairs`
(Konnector/konnector.h:235) picks a start k-mer near read1's 3' end and
a goal k-mer from rc(read2) (getStartKmerPos, DBGBloomAlgorithms.h:51),
then runs a bounded bidirectional constrained BFS between them
(Graph/ConstrainedBidiBFSVisitor.h: per-side depth caps, frontier cap,
edge-cost cap, common-edge collection capped at max_paths, tree and
non-tree parent edges, path length filter).  Outcome classes and the
per-outcome counter block (konnector.cc g_count:276-295) are the JAX
package's.

Two search engines, switched as in the JAX package: the device engine
(gap/konnector_dev.search, for a sorted filter with no branch cap,
unless ABYSS_TPU_KONNECTOR=host), and the host engine, whose levels
advance all pairs at once with one device call (roll x4, canonicalize,
probe the filter) and numpy joins; it also takes over a chunk the
device engine cannot hold.  Path reconstruction, consensus and the
merged read are host code shared by both.  Everything on a device runs
on the filter's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import u64
from ..core import alphabet
from ..ops import nthash
from . import konnector_dev

NO_LIMIT = (1 << 32) - 1
_U2 = np.uint64(2)
_U62 = np.uint64(62)


@dataclass
class ConnectPairsParams:
    """cf. ConnectPairsParams in konnector.h + konnector.cc defaults."""
    max_paths: int = 2          # -P
    min_frag: int = 0           # -f (minMergedSeqLen)
    max_frag: int = 1000        # -F (maxMergedSeqLen)
    max_branches: int = NO_LIMIT  # -B (deprecated, nolimit default)
    max_cost: int = 25000       # -C max edges traversed per search
    max_path_mismatches: int = 2  # -M
    min_path_identity: float = 0.0  # -X
    max_read_mismatches: int = NO_LIMIT  # -m
    min_read_identity: float = 0.0  # -x
    mask: bool = False          # --mask: lowercase new/changed bases
    preserve_reads: bool = False  # --preserve-reads (anchor to ends)
    kmer_matches_threshold: int = 3  # numMatchesThreshold


@dataclass
class ConnectResult:
    """Per-pair outcome (cf. ConnectPairsResult, konnector.h)."""
    seq: str | None
    num_paths: int
    reason: str  # FOUND_PATH/NO_PATH/NO_KMER/TOO_MANY_PATHS/
    #            TOO_MANY_BRANCHES/PATH_CONTAINS_CYCLE/
    #            MAX_COST_EXCEEDED/MISMATCH/READ_MISMATCH
    path_mismatches: int = 0
    read_mismatches: int = 0
    start_pos: int = -1
    goal_pos: int = -1


@dataclass
class ConnectStats:
    """The g_count block (konnector.cc:276-295) + summary printer."""
    no_start_or_goal_kmer: int = 0
    no_path: int = 0
    unique_path: int = 0
    multiple_paths: int = 0
    too_many_paths: int = 0
    too_many_branches: int = 0
    too_many_mismatches: int = 0
    too_many_read_mismatches: int = 0
    contains_cycle: int = 0
    max_cost_exceeded: int = 0
    read_pairs_processed: int = 0

    @property
    def merged(self) -> int:
        return self.unique_path + self.multiple_paths

    def add(self, r: ConnectResult) -> None:
        self.read_pairs_processed += 1
        m = {"NO_KMER": "no_start_or_goal_kmer", "NO_PATH": "no_path",
             "TOO_MANY_PATHS": "too_many_paths",
             "TOO_MANY_BRANCHES": "too_many_branches",
             "PATH_CONTAINS_CYCLE": "contains_cycle",
             "MAX_COST_EXCEEDED": "max_cost_exceeded",
             "MISMATCH": "too_many_mismatches",
             "READ_MISMATCH": "too_many_read_mismatches"}
        if r.reason == "FOUND_PATH":
            if r.num_paths == 1:
                self.unique_path += 1
            else:
                self.multiple_paths += 1
        else:
            setattr(self, m[r.reason], getattr(self, m[r.reason]) + 1)

    def summary(self) -> str:
        n = max(self.read_pairs_processed, 1)

        def pct(x):
            return f"{x} ({100.0 * x / n:.1f}%)"

        return "\n".join([
            f"Processed {self.read_pairs_processed} read pairs",
            f"Merged (Unique path + Multiple paths): {pct(self.merged)}",
            f"No start/goal kmer: {pct(self.no_start_or_goal_kmer)}",
            f"No path: {pct(self.no_path)}",
            f"Unique path: {pct(self.unique_path)}",
            f"Multiple paths: {pct(self.multiple_paths)}",
            f"Too many paths: {pct(self.too_many_paths)}",
            f"Too many branches: {pct(self.too_many_branches)}",
            f"Too many path/path mismatches: "
            f"{pct(self.too_many_mismatches)}",
            f"Too many path/read mismatches: "
            f"{pct(self.too_many_read_mismatches)}",
            f"Contains cycle: {pct(self.contains_cycle)}",
            f"Max cost exceeded: {pct(self.max_cost_exceeded)}",
        ])


# ---------------------------------------------------------------------------
# packed-word helpers (base 0 in top bits of word 0; zero padding)

def _n_words(k: int) -> int:
    return (k + 31) // 32


def _pack_words(codes: np.ndarray, k: int) -> np.ndarray:
    """[N, k] base codes -> [N, W] u64 words."""
    N = codes.shape[0]
    W = _n_words(k)
    out = np.zeros((N, W), np.uint64)
    for j in range(k):
        out[:, j // 32] |= codes[:, j].astype(np.uint64) << np.uint64(
            62 - 2 * (j % 32))
    return out


def _words_to_codes(words: np.ndarray, k: int) -> np.ndarray:
    """[N, W] u64 -> [N, k] base codes."""
    N = words.shape[0]
    out = np.empty((N, k), np.uint8)
    for j in range(k):
        out[:, j] = ((words[:, j // 32] >> np.uint64(62 - 2 * (j % 32)))
                     & np.uint64(3)).astype(np.uint8)
    return out


def _first_base(words: np.ndarray) -> np.ndarray:
    return ((words[:, 0] >> _U62) & np.uint64(3)).astype(np.uint8)


def _last_base(words: np.ndarray, k: int) -> np.ndarray:
    j = k - 1
    return ((words[:, j // 32] >> np.uint64(62 - 2 * (j % 32)))
            & np.uint64(3)).astype(np.uint8)


def _shift_right(words: np.ndarray, k: int, c: np.ndarray) -> np.ndarray:
    """Drop base 0, append base c at position k-1 (right extension)."""
    W = words.shape[1]
    out = words << _U2
    if W > 1:
        out[:, :-1] |= words[:, 1:] >> _U62
    j = k - 1
    out[:, j // 32] |= c.astype(np.uint64) << np.uint64(62 - 2 * (j % 32))
    # clear sub-k padding bits of the last word (shifted-in garbage is
    # impossible — shifts only move zeros into the pad — but the
    # appended base write above is exact; keep a mask for safety)
    r = k - 32 * (W - 1)
    if r < 32:
        out[:, W - 1] &= np.uint64(~((1 << (64 - 2 * r)) - 1)
                                   & 0xFFFFFFFFFFFFFFFF)
    return out


def _shift_left(words: np.ndarray, k: int, c: np.ndarray) -> np.ndarray:
    """Prepend base c at position 0, drop base k-1 (left extension)."""
    W = words.shape[1]
    out = words >> _U2
    if W > 1:
        out[:, 1:] |= words[:, :-1] << _U62
    out[:, 0] |= c.astype(np.uint64) << _U62
    r = k - 32 * (W - 1)
    if r < 32:
        out[:, W - 1] &= np.uint64(~((1 << (64 - 2 * r)) - 1)
                                   & 0xFFFFFFFFFFFFFFFF)
    return out


# ---------------------------------------------------------------------------
# start/goal k-mer selection (getStartKmerPos, DBGBloomAlgorithms.h:51)

def _pad_batch(codes_list: list[np.ndarray]) -> np.ndarray:
    L = 1 << max(max((len(c) for c in codes_list), default=1) - 1,
                 1).bit_length()
    L = max(L, 64)
    out = np.full((len(codes_list), L), 4, np.uint8)
    for i, c in enumerate(codes_list):
        out[i, :len(c)] = c
    return out


def _solid_windows(filt, padded: np.ndarray, k: int) -> np.ndarray:
    """[P, W] solid mask, one device pass for the whole batch."""
    codes = torch.from_numpy(padded).to(filt.device)
    _, _, canon, valid = nthash.kmer_hashes(codes, k)
    return filt.contains(canon, valid).cpu().numpy()


def start_kmer_positions(solid: np.ndarray, lens: np.ndarray, k: int,
                         threshold: int = 3,
                         anchor_to_end: bool = False) -> np.ndarray:
    """Vectorized getStartKmerPos(FORWARD) over a batch: scanning each
    read from its 3' end, return the position where `threshold`
    consecutive solid windows accumulate (== the largest i with
    windows i..i+threshold-1 all solid), else the lowest index of the
    longest (sub-threshold) run nearest the end, else -1.
    anchor_to_end (--preserve-reads) only considers the trailing run."""
    P, Wmax = solid.shape
    nwin = np.maximum(lens - k + 1, 0)
    col = np.arange(Wmax)[None, :]
    s = solid & (col < nwin[:, None])
    pos = np.full(P, -1, np.int64)

    if anchor_to_end:
        # trailing run length per row: first miss scanning from the end
        miss = ~s & (col < nwin[:, None])
        # trailing run = nwin - 1 - (last miss index); no miss -> full
        last_miss = np.where(miss.any(1),
                             Wmax - 1 - np.argmax(miss[:, ::-1], axis=1),
                             -1)
        t = nwin - 1 - last_miss
        has = nwin > 0
        full = has & (t >= threshold)
        pos[full] = nwin[full] - threshold
        partial = has & (t > 0) & (t < threshold)
        pos[partial] = nwin[partial] - t[partial]
        return pos

    # threshold-run: largest i with s[i..i+threshold-1]
    run = s.copy()
    for d in range(1, threshold):
        run[:, :Wmax - d] &= s[:, d:]
        run[:, Wmax - d:] = False
    hasrun = run.any(1)
    pos[hasrun] = Wmax - 1 - np.argmax(run[:, ::-1], axis=1)[hasrun]

    # fallback: longest run (< threshold), ties to the run nearest the
    # end; position = the run's LOWEST window index (maxMatchPos is
    # set to i - inc when the run ends, DBGBloomAlgorithms.h:82-87)
    need = ~hasrun
    if need.any():
        sn = s[need]
        starts = sn & ~np.pad(sn[:, :-1], ((0, 0), (1, 0)))
        flat = starts.ravel()
        rid = np.cumsum(flat).reshape(sn.shape)
        rid = np.where(sn, rid, 0)
        nrun = int(flat.sum())
        if nrun:
            lengths = np.bincount(rid.ravel(), minlength=nrun + 1)
            srow, scol = np.nonzero(starts)
            # key: longer first, then larger start col (nearest end)
            runlen = lengths[1:nrun + 1]
            key = runlen.astype(np.int64) * (Wmax + 1) + scol
            best = np.full(sn.shape[0], -1, np.int64)
            np.maximum.at(best, srow, key)
            rows = np.nonzero(best >= 0)[0]
            pos[np.nonzero(need)[0][rows]] = best[rows] % (Wmax + 1)
    return pos


# ---------------------------------------------------------------------------
# the batched bidirectional constrained BFS

def _mix_pair(pair: np.ndarray) -> np.ndarray:
    """splitmix64 of the pair id — only used to SALT sort keys so that
    per-pair groups land apart; joins always compare (pair, canon)
    exactly, never the salted key."""
    z = pair.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _member_and_lookup(qp, qk, vp, vk, vidx):
    """For queries (qp, qk), return the matching index into the visited
    arrays (vp, vk, vidx) or -1 — an exact (pair, key) sort-merge join
    (the same pattern as ops/sort_join, host-side)."""
    nq = len(qp)
    if nq == 0 or len(vp) == 0:
        return np.full(nq, -1, np.int64)
    ap = np.concatenate([vp, qp])
    ak = np.concatenate([vk, qk])
    tag = np.concatenate([np.zeros(len(vp), np.int8),
                          np.ones(nq, np.int8)])
    payload = np.concatenate([vidx, np.arange(nq, dtype=np.int64)])
    order = np.lexsort((tag, ak, ap))
    sp, sk, st, spay = ap[order], ak[order], tag[order], payload[order]
    n = len(sp)
    newgrp = np.concatenate([[True], (sp[1:] != sp[:-1]) |
                             (sk[1:] != sk[:-1])])
    # grouped forward-fill: index of the last visited row at or before
    # each position, valid only if it falls inside the same group
    vis_here = st == 0
    last_vis = np.maximum.accumulate(
        np.where(vis_here, np.arange(n), -1))
    grp_start = np.maximum.accumulate(
        np.where(newgrp, np.arange(n), -1))
    ok = (st == 1) & (last_vis >= grp_start)
    out = np.full(nq, -1, np.int64)
    out[spay[ok]] = spay[np.maximum(last_vis[ok], 0)]
    return out


@dataclass
class _Side:
    """Per-side node store, flat across all pairs.  A surrogate-key
    sorted index (skey = canon ^ splitmix64(pair)) gives O(log V)
    membership without re-sorting the visited set every level; matches
    are always VERIFIED on exact (pair, canon), so skey collisions
    cost a probe, never correctness."""
    pair: np.ndarray
    canon: np.ndarray
    fh: np.ndarray
    rh: np.ndarray
    words: np.ndarray           # [N, W]
    depth: np.ndarray
    e_child: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    e_parent: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))

    def __post_init__(self):
        sk = self.canon ^ _mix_pair(self.pair)
        order = np.argsort(sk)
        self.sk = sk[order]
        self.sk_pair = self.pair[order]
        self.sk_canon = self.canon[order]
        self.sk_idx = order.astype(np.int64)

    def append_nodes(self, pair, canon, fh, rh, words, depth):
        base = len(self.pair)
        self.pair = np.concatenate([self.pair, pair])
        self.canon = np.concatenate([self.canon, canon])
        self.fh = np.concatenate([self.fh, fh])
        self.rh = np.concatenate([self.rh, rh])
        self.words = np.concatenate([self.words, words])
        self.depth = np.concatenate([self.depth, depth])
        ids = np.arange(base, base + len(pair), dtype=np.int64)
        # merge the new rows into the sorted surrogate index
        sk_new = canon ^ _mix_pair(pair)
        o = np.argsort(sk_new)
        pos = np.searchsorted(self.sk, sk_new[o])
        self.sk = np.insert(self.sk, pos, sk_new[o])
        self.sk_pair = np.insert(self.sk_pair, pos, pair[o])
        self.sk_canon = np.insert(self.sk_canon, pos, canon[o])
        self.sk_idx = np.insert(self.sk_idx, pos, ids[o])
        return ids

    def lookup(self, qp, qk):
        """Node index for each (pair, canon) query, or -1."""
        nq = len(qp)
        if nq == 0 or len(self.sk) == 0:
            return np.full(nq, -1, np.int64)
        qsk = qk ^ _mix_pair(qp)
        pos = np.searchsorted(self.sk, qsk, side="left")
        out = np.full(nq, -1, np.int64)
        n = len(self.sk)
        unresolved = None
        for probe in range(3):
            p = pos + probe
            ok = (p < n)
            pc = np.minimum(p, n - 1)
            same_sk = ok & (self.sk[pc] == qsk)
            hit = same_sk & (self.sk_pair[pc] == qp) & \
                (self.sk_canon[pc] == qk) & (out < 0)
            out[hit] = self.sk_idx[pc[hit]]
            if probe == 2:
                unresolved = same_sk & (out < 0)
        # skey runs longer than 3 are ~impossible (needs >=3 XOR
        # collisions); resolve the stragglers exactly anyway
        if unresolved is not None and unresolved.any():
            for qi in np.nonzero(unresolved)[0]:
                p = int(pos[qi]) + 3
                while p < n and self.sk[p] == qsk[qi]:
                    if self.sk_pair[p] == qp[qi] and \
                            self.sk_canon[p] == qk[qi]:
                        out[qi] = self.sk_idx[p]
                        break
                    p += 1
        return out

    def append_edges(self, child, parent):
        self.e_child = np.concatenate([self.e_child, child])
        self.e_parent = np.concatenate([self.e_parent, parent])


def _make_roll_probe(k: int, forward: bool):
    """One device step of the host engine: roll the batch one base (x4
    candidates), canonicalize, probe the filter."""

    def step(filt, fh, rh, c_out, c_in):
        roll = nthash.roll_right if forward else nthash.roll_left
        f2, r2 = roll(fh, rh, k, c_out, c_in)
        canon = u64.umin(f2, r2)
        return f2, r2, canon, filt.contains(canon)

    return step


def connect_pairs_full(filt, pairs, k: int,
                       params: ConnectPairsParams | None = None,
                       stats: ConnectStats | None = None,
                       chunk: int = 8192,
                       ) -> list[ConnectResult]:
    """Connect [(seq1, seq2)] read pairs (seq2 in sequencing
    orientation).  Returns one ConnectResult per pair.  `filt` is any
    canonical-ntHash membership filter (counting Bloom, cascading
    Bloom, or the sorted exact filter)."""
    params = params or ConnectPairsParams()
    out: list[ConnectResult | None] = [None] * len(pairs)
    for lo in range(0, len(pairs), chunk):
        sub = pairs[lo:lo + chunk]
        res = _connect_chunk(filt, sub, k, params)
        out[lo:lo + len(sub)] = res
    for r in out:
        if stats is not None:
            stats.add(r)
    return out


def _connect_chunk(filt, pairs, k, params) -> list[ConnectResult]:
    P = len(pairs)
    results: list[ConnectResult | None] = [None] * P
    W = _n_words(k)

    r1_codes, r2_codes = [], []
    for s1, s2 in pairs:
        r1_codes.append(alphabet.encode(s1))
        r2_codes.append(alphabet.encode(alphabet.revcomp(s2)))
    lens1 = np.array([len(c) for c in r1_codes])
    lens2 = np.array([len(c) for c in r2_codes])

    pad1 = _pad_batch(r1_codes)
    solid1 = _solid_windows(filt, pad1, k)
    th = params.kmer_matches_threshold
    start_pos = start_kmer_positions(solid1, lens1, k, th,
                                     params.preserve_reads)
    # goal: getStartKmerPos(read2, FORWARD) then rc — equivalently the
    # trailing-consecutive scan on rc(read2) from ITS OWN START, i.e.
    # the FORWARD scan of read2 maps to position from the END of
    # rc(read2): goal_pos here is read2's forward position
    goal_pos_r2 = start_kmer_positions(
        _solid_windows(filt, _pad_batch(
            [alphabet.revcomp_codes(c) for c in r2_codes]), k),
        lens2, k, th, params.preserve_reads)

    status = np.zeros(P, np.int8)  # 0 active, 1 done
    reason = [""] * P
    for i in range(P):
        if lens1[i] < k or lens2[i] < k or start_pos[i] < 0 \
                or goal_pos_r2[i] < 0:
            results[i] = ConnectResult(None, 0, "NO_KMER")
            status[i] = 1

    # per-pair geometry (connectPairs, konnector.h:305-317)
    s_pos = start_pos
    g_pos = goal_pos_r2
    max_plen = params.max_frag - k + 1 - s_pos - g_pos
    min_plen = np.maximum(params.min_frag - k + 1 - s_pos - g_pos, 0)
    min_plen = np.maximum(min_plen, np.maximum(
        lens1 - k + 1 - s_pos, lens2 - k + 1 - g_pos))
    for i in range(P):
        if status[i] == 0 and max_plen[i] < 1:
            results[i] = ConnectResult(None, 0, "NO_PATH")
            status[i] = 1
    max_depth_f = (max_plen - 1) // 2 + (max_plen - 1) % 2
    max_depth_r = (max_plen - 1) // 2

    active = np.nonzero(status == 0)[0]
    if len(active) == 0:
        return results

    # seed nodes: start kmer (read1 orientation), goal kmer =
    # rc(read2)[Lr2 - g_pos - k :][:k] — in FRAGMENT orientation the
    # goal sits near rc(read2)'s start offset g_pos from ITS end; the
    # reference takes rc(read2[g_pos:g_pos+k]) which equals
    # rc2[L2-k-g_pos : L2-g_pos]
    s_k = np.zeros((len(active), k), np.uint8)
    g_k = np.zeros((len(active), k), np.uint8)
    for j, i in enumerate(active):
        s_k[j] = r1_codes[i][s_pos[i]:s_pos[i] + k]
        gstart = lens2[i] - k - g_pos[i]
        g_k[j] = r2_codes[i][gstart:gstart + k]
    s_words = _pack_words(s_k, k)
    g_words = _pack_words(g_k, k)
    # hash seeds via the window scan (one call, exact)
    dev = filt.device
    fh1, rh1, _, _ = nthash.kmer_hashes(torch.from_numpy(s_k).to(dev), k)
    fh2, rh2, _, _ = nthash.kmer_hashes(torch.from_numpy(g_k).to(dev), k)
    s_fh = u64.to_numpy(fh1[:, 0])
    s_rh = u64.to_numpy(rh1[:, 0])
    g_fh = u64.to_numpy(fh2[:, 0])
    g_rh = u64.to_numpy(rh2[:, 0])

    # trivial start == goal (visitor ctor special case)
    s_canon = np.minimum(s_fh, s_rh)
    g_canon = np.minimum(g_fh, g_rh)
    triv = np.nonzero((s_canon == g_canon) &
                      np.all(s_words == g_words, axis=1))[0]
    trivial_pairs = set()
    seed_code_of = {}
    for j in triv:
        i = int(active[j])
        if min_plen[i] <= 1:
            trivial_pairs.add(i)
            seed_code_of[i] = s_k[j]

    # ---- device-resident multi-level BFS (gap/konnector_dev): many
    # levels per dispatch; falls back to the host engine below on
    # capacity overflow or unsupported filter/params ------------------
    if (os.environ.get("ABYSS_TPU_KONNECTOR", "device") != "host"
            and params.max_branches == NO_LIMIT
            and konnector_dev.device_capable(filt)):
        art = konnector_dev.search(
            filt, P, active.astype(np.int64), s_k, g_k, s_words,
            g_words, s_fh, s_rh, g_fh, g_rh, max_depth_f, max_depth_r,
            k, params)
        if art is not None:
            Fd, Rd, cost, fail, meets, _ = art
            common: dict[int, list] = {}
            seen: set[tuple] = set()
            for i, fi, ri in meets:
                ck = (i, int(Fd.canon[fi]), int(Rd.canon[ri]))
                if ck in seen:
                    continue
                seen.add(ck)
                common.setdefault(i, []).append((fi, ri))
            n_common = np.zeros(P, np.int64)
            for i, lst in common.items():
                n_common[i] = len(lst)
            return _finish_chunk(
                pairs, results, P, status, fail, cost, n_common,
                common, trivial_pairs, Fd, Rd, seed_code_of, min_plen,
                max_plen, max_depth_f, max_depth_r, r2_codes, s_pos,
                g_pos, k, params)

    # ---- host-level fallback engine ----------------------------------
    F = _Side(active.astype(np.int64), s_canon,
              s_fh, s_rh, s_words, np.zeros(len(active), np.int32))
    R = _Side(active.astype(np.int64), g_canon,
              g_fh, g_rh, g_words, np.zeros(len(active), np.int32))

    cost = np.zeros(P, np.int64)
    n_common = np.zeros(P, np.int64)
    common = {}  # pair -> list[(f_node, r_node)]
    common_seen: set[tuple] = set()
    fail = np.zeros(P, np.int8)  # 0 ok, else reason code

    step_f = _make_roll_probe(k, True)
    step_r = _make_roll_probe(k, False)

    frontier_f = np.arange(len(active), dtype=np.int64)
    frontier_r = np.arange(len(active), dtype=np.int64)

    while len(frontier_f) or len(frontier_r):
        for side, other, frontier, step, fwd, mdepth in (
                (F, R, frontier_f, step_f, True, max_depth_f),
                (R, F, frontier_r, step_r, False, max_depth_r)):
            if not len(frontier):
                continue
            par_pair = side.pair[frontier]
            live = fail[par_pair] == 0
            frontier = frontier[live]
            if not len(frontier):
                if fwd:
                    frontier_f = frontier
                else:
                    frontier_r = frontier
                continue
            par_pair = side.pair[frontier]
            par_words = side.words[frontier]
            par_depth = side.depth[frontier]
            c_out = (_first_base(par_words) if fwd
                     else _last_base(par_words, k))
            n = len(frontier)
            rep = np.repeat(np.arange(n), 4)
            c_in = np.tile(np.arange(4, dtype=np.uint8), n)
            # one device call: roll + canon + probe for ALL candidates
            npad = max(64, 1 << (4 * n - 1).bit_length())
            fh_in = np.zeros(npad, np.uint64)
            rh_in = np.zeros(npad, np.uint64)
            co_in = np.zeros(npad, np.uint8)
            ci_in = np.zeros(npad, np.uint8)
            fh_in[:4 * n] = side.fh[frontier][rep]
            rh_in[:4 * n] = side.rh[frontier][rep]
            co_in[:4 * n] = c_out[rep]
            ci_in[:4 * n] = c_in
            f2d, r2d, canond, solidd = step(
                filt, u64.from_numpy(fh_in, dev), u64.from_numpy(rh_in, dev),
                torch.from_numpy(co_in).to(dev),
                torch.from_numpy(ci_in).to(dev))
            f2 = u64.to_numpy(f2d[:4 * n])
            r2 = u64.to_numpy(r2d[:4 * n])
            canon = u64.to_numpy(canond[:4 * n])
            solid = solidd[:4 * n].cpu().numpy()

            cpair = par_pair[rep]
            cparent = frontier[rep]
            cdepth = par_depth[rep] + 1
            keep = solid & (fail[cpair] == 0)
            if not keep.any():
                if fwd:
                    frontier_f = np.zeros(0, np.int64)
                else:
                    frontier_r = np.zeros(0, np.int64)
                continue
            idx = np.nonzero(keep)[0]
            cpair, cparent, cdepth = cpair[idx], cparent[idx], cdepth[idx]
            canon, f2, r2 = canon[idx], f2[idx], r2[idx]
            c_in_k = c_in[idx]
            # every traversed edge costs 1 (tree/non-tree/common)
            np.add.at(cost, cpair, 1)
            over = cost > params.max_cost
            newly = np.nonzero(over & (fail == 0) & (status == 0))[0]
            fail[newly] = 3

            # child words
            cw = (_shift_right(side.words[cparent], k, c_in_k) if fwd
                  else _shift_left(side.words[cparent], k, c_in_k))

            # meet detection: candidate in OTHER side's visited.
            # Hits are verified against the packed k-mer TEXT: a text
            # mismatch is a 64-bit fingerprint collision — the nodes
            # are distinct k-mers, so it is not a meet (round-4
            # advisor #2; mirrors fill_wide_side's checksum check).
            om = other.lookup(cpair, canon)
            hit = om >= 0
            if hit.any():
                om[hit & ~np.all(other.words[np.maximum(om, 0)] == cw,
                                 axis=1)] = -1
            # common edge requires parent depth < this side's cap
            pd_ok = (par_depth[rep][idx] <
                     (mdepth[cpair] if isinstance(mdepth, np.ndarray)
                      else mdepth))
            is_meet = (om >= 0) & pd_ok
            for e in np.nonzero(is_meet)[0]:
                i = int(cpair[e])
                if fail[i]:
                    continue
                fnode = int(cparent[e]) if fwd else int(om[e])
                rnode = int(om[e]) if fwd else int(cparent[e])
                # identify the common edge by its endpoints' canon
                ckey = (i, int(F.canon[fnode]), int(R.canon[rnode]))
                if ckey in common_seen:
                    continue
                common_seen.add(ckey)
                common.setdefault(i, []).append((fnode, rnode))
                n_common[i] += 1
                if n_common[i] > params.max_paths:
                    fail[i] = 1

            # visited lookup on own side (non-tree edges); same
            # text-verified collision guard as the meet lookup
            sm = side.lookup(cpair, canon)
            shit = sm >= 0
            if shit.any():
                sm[shit & ~np.all(side.words[np.maximum(sm, 0)] == cw,
                                  axis=1)] = -1
            is_old = (sm >= 0) & ~is_meet
            # record non-tree parent edges (traversal-DAG alternates)
            side.append_edges(sm[is_old], cparent[is_old])

            # fresh nodes: not meet, not visited, depth within cap,
            # pair alive; in-level dedup keeps the first occurrence
            capv = (mdepth[cpair] if isinstance(mdepth, np.ndarray)
                    else np.full(len(cpair), mdepth))
            fresh = ~is_meet & (sm < 0) & pd_ok & (fail[cpair] == 0) \
                & (cdepth <= capv)
            fi = np.nonzero(fresh)[0]
            if len(fi):
                # in-level dedup on (pair, canon): first wins
                order = np.lexsort((fi, canon[fi], cpair[fi]))
                fp, fc = cpair[fi][order], canon[fi][order]
                first = np.concatenate([[True], (fp[1:] != fp[:-1]) |
                                        (fc[1:] != fc[:-1])])
                winners = fi[order][first]
                losers = fi[order][~first]
                new_ids = side.append_nodes(
                    cpair[winners], canon[winners], f2[winners],
                    r2[winners], cw[winners], cdepth[winners])
                side.append_edges(new_ids, cparent[winners])
                # duplicate in-level discoveries are non-tree edges to
                # the winner node: forward-fill winner ids over runs
                if len(losers):
                    run = np.cumsum(first) - 1
                    winner_of = new_ids[run]      # aligned to `order`
                    loser_winner = winner_of[~first]
                    side.append_edges(loser_winner,
                                      cparent[fi[order][~first]])
                new_frontier = new_ids
            else:
                new_frontier = np.zeros(0, np.int64)

            # frontier (branch) cap per pair
            if params.max_branches != NO_LIMIT and len(new_frontier):
                cnt = np.bincount(side.pair[new_frontier],
                                  minlength=P)
                overb = np.nonzero((cnt > params.max_branches) &
                                   (fail == 0))[0]
                fail[overb] = 2
            if fwd:
                frontier_f = new_frontier
            else:
                frontier_r = new_frontier

    return _finish_chunk(pairs, results, P, status, fail, cost,
                         n_common, common, trivial_pairs, F, R,
                         seed_code_of, min_plen, max_plen, max_depth_f,
                         max_depth_r, r2_codes, s_pos, g_pos, k, params)


FAIL = {1: "TOO_MANY_PATHS", 2: "TOO_MANY_BRANCHES",
        3: "MAX_COST_EXCEEDED"}


def _finish_chunk(pairs, results, P, status, fail, cost, n_common,
                  common, trivial_pairs, F, R, seed_code_of, min_plen,
                  max_plen, max_depth_f, max_depth_r, r2_codes, s_pos,
                  g_pos, k, params) -> list[ConnectResult]:
    """Per-pair classification + path building, shared by the device
    (konnector_dev) and host search engines: F/R expose .pair/.canon/
    .words/.depth node arrays + .e_child/.e_parent traversal-DAG edges."""
    # group each side's edge list by pair once (not per pair)
    def _edge_groups(side):
        ep = side.pair[side.e_child] if len(side.e_child) else \
            np.zeros(0, np.int64)
        order = np.argsort(ep, kind="stable")
        return ep[order], side.e_child[order], side.e_parent[order]

    F_ep, F_ec, F_epar = _edge_groups(F)
    R_ep, R_ec, R_epar = _edge_groups(R)

    def build_side_paths(side, node, cap, budget):
        """All parent-paths node -> seed in the traversal DAG (the
        allPathsSearch over m_traversalGraph); returns (paths, cyclic)
        where each path is a list of node ids starting at `node` and
        ending at the seed."""
        # parent adjacency for this pair only (pre-grouped edge list)
        ep, ec, epar = (F_ep, F_ec, F_epar) if side is F else \
            (R_ep, R_ec, R_epar)
        pr = side.pair[node]
        a = np.searchsorted(ep, pr, side="left")
        b = np.searchsorted(ep, pr, side="right")
        parents: dict[int, list[int]] = {}
        for c, p in zip(ec[a:b], epar[a:b]):
            parents.setdefault(int(c), []).append(int(p))
        paths, stack = [], [(int(node), [int(node)])]
        cyclic = False
        steps = 0
        while stack:
            cur, path = stack.pop()
            steps += 1
            if steps > budget:
                return paths, cyclic, steps
            if side.depth[cur] == 0:
                paths.append(path)
                if len(paths) > params.max_paths:
                    return paths, cyclic, steps
                continue
            for p in parents.get(cur, ()):
                if p in path:
                    cyclic = True
                    continue
                if len(path) > cap + 1:
                    continue
                stack.append((p, path + [p]))
        return paths, cyclic, steps

    for i in range(P):
        if status[i]:
            continue
        if fail[i]:
            results[i] = ConnectResult(None, int(n_common[i]), FAIL[fail[i]])
            continue
        edges = common.get(i)
        paths_seqs: list[np.ndarray] = []
        cyclic = False
        if i in trivial_pairs:
            # start == goal: the path is the seed k-mer itself
            paths_seqs.append(np.asarray(seed_code_of[i], np.uint8))
        if edges:
            budget = params.max_cost - int(cost[i])
            for fnode, rnode in edges:
                fpaths, cyc1, st1 = build_side_paths(
                    F, fnode, int(max_depth_f[i]), budget)
                budget -= st1
                rpaths, cyc2, st2 = build_side_paths(
                    R, rnode, int(max_depth_r[i]), budget)
                budget -= st2
                cyclic |= cyc1 or cyc2
                if budget <= 0:
                    results[i] = ConnectResult(None, 0,
                                               "MAX_COST_EXCEEDED")
                    break
                for fp in fpaths:
                    for rp in rpaths:
                        plen = len(fp) + len(rp)
                        if plen < min_plen[i] or plen > max_plen[i]:
                            continue
                        # fragment order: start..fnode, rnode..goal
                        ids_f = list(reversed(fp))
                        ids_r = rp
                        codes = [_words_to_codes(
                            F.words[ids_f[0]:ids_f[0] + 1], k)[0]]
                        for nid in ids_f[1:]:
                            codes.append(_words_to_codes(
                                F.words[nid:nid + 1], k)[0][-1:])
                        # R-side nodes walk LEFT from the goal: in
                        # fragment order rnode comes first; each
                        # subsequent (toward goal) adds its last base
                        for nid in ids_r:
                            codes.append(_words_to_codes(
                                R.words[nid:nid + 1], k)[0][-1:])
                        paths_seqs.append(np.concatenate(codes))
                        if len(paths_seqs) > params.max_paths:
                            break
                    if len(paths_seqs) > params.max_paths:
                        break
                if len(paths_seqs) > params.max_paths:
                    break
            if results[i] is not None:
                continue
        if len(paths_seqs) > params.max_paths:
            results[i] = ConnectResult(None, len(paths_seqs),
                                       "TOO_MANY_PATHS")
            continue
        if not paths_seqs:
            results[i] = ConnectResult(
                None, 0, "PATH_CONTAINS_CYCLE" if cyclic else "NO_PATH")
            continue
        results[i] = _merge_pair(pairs[i][0], r2_codes[i], paths_seqs,
                                 int(s_pos[i]), int(g_pos[i]), k, params)
    return results


def _merge_pair(s1: str, r2_codes: np.ndarray, paths_seqs, s_pos: int,
                g_pos: int, k: int, params) -> ConnectResult:
    """Consensus + merged pseudo-read assembly (connectPairs tail,
    konnector.h:330-420): prefix + connecting seq + suffix, NW-based
    consensus across alternate paths, maskNew mismatch accounting."""
    from ..align import nw

    npaths = len(paths_seqs)
    path_mismatches = 0
    if npaths == 1:
        connecting = alphabet.decode(paths_seqs[0])
    else:
        # center-star NW consensus of the alternates (the reference
        # runs dialign-style multi-align; identity semantics match)
        seqs = [alphabet.decode(p) for p in paths_seqs]
        center = max(range(npaths), key=lambda ci: len(seqs[ci]))
        consensus = seqs[center]
        total_mismatch = 0
        for j, s in enumerate(seqs):
            if j == center:
                continue
            a1, a2, score = nw.align_global(consensus, s)
            merged = []
            for ca, cb in zip(a1, a2):
                if ca == cb:
                    merged.append(ca)
                else:
                    total_mismatch += 1
                    merged.append(ca if ca != "-" else cb)
            consensus = "".join(merged)
        path_mismatches = total_mismatch
        connecting = consensus
        plen = max(len(connecting), 1)
        identity = 100.0 * (plen - path_mismatches) / plen
        if path_mismatches > params.max_path_mismatches or \
                identity < params.min_path_identity:
            return ConnectResult(None, npaths, "MISMATCH",
                                 path_mismatches=path_mismatches,
                                 start_pos=s_pos, goal_pos=g_pos)

    r2s = alphabet.decode(r2_codes)
    if params.preserve_reads:
        # --preserve-reads (konnector.h:339-357): the merged pseudo-read
        # keeps the FULL read1 / rc(read2) as prefix/suffix and trims
        # the connecting sequence by the read overlaps; overlapping
        # reads (trims exceeding the connecting length) fail NO_PATH.
        trim_left = len(s1) - s_pos
        trim_right = len(r2s) - g_pos
        if trim_left + trim_right > len(connecting):
            return ConnectResult(None, npaths, "NO_PATH",
                                 path_mismatches=path_mismatches,
                                 start_pos=s_pos, goal_pos=g_pos)
        mid = connecting[trim_left:len(connecting) - trim_right]
        merged = s1 + mid + r2s
    else:
        prefix = s1[:s_pos]
        suffix = r2s[len(r2s) - g_pos:] if g_pos > 0 else ""
        merged = prefix + connecting + suffix

    merged, read_mismatches = mask_new(s1, r2s, merged, params.mask)
    rp_len = len(s1) + len(r2s)
    read_identity = 100.0 * (rp_len - read_mismatches) / max(rp_len, 1)
    if read_mismatches > params.max_read_mismatches or \
            read_identity < params.min_read_identity:
        return ConnectResult(None, npaths, "READ_MISMATCH",
                             read_mismatches=read_mismatches,
                             start_pos=s_pos, goal_pos=g_pos)
    return ConnectResult(merged, npaths, "FOUND_PATH",
                         path_mismatches=path_mismatches,
                         read_mismatches=read_mismatches,
                         start_pos=s_pos, goal_pos=g_pos)


def mask_new(read1: str, r2_fragment: str, merged: str,
             mask: bool) -> tuple[str, int]:
    """maskNew (konnector.h): compare the merged pseudo-read against
    read1 (aligned at the start) and rc(read2) (aligned at the end);
    count mismatched read positions, lowercasing them when mask."""
    out = list(merged)
    mismatches = 0
    for j in range(min(len(read1), len(merged))):
        if merged[j].upper() != read1[j].upper():
            mismatches += 1
            if mask:
                out[j] = out[j].lower()
    off = len(merged) - len(r2_fragment)
    for j in range(max(0, -off), len(r2_fragment)):
        if merged[off + j].upper() != r2_fragment[j].upper():
            mismatches += 1
            if mask:
                out[off + j] = out[off + j].lower()
    return ("".join(out) if mask else merged), mismatches


# ---------------------------------------------------------------------------
# duplicate-pair / assembled-region filter (the -D dup Bloom,
# konnector.cc:339-383 isSeqRedundant/addKmers)

class DupFilter:
    """Tracks already-assembled regions: a sequence is redundant when
    every good k-mer it contains is already present."""

    def __init__(self, size_bits: int, k: int, num_hashes: int = 4,
                 device="cuda"):
        from ..ops.bloom import BitBloomFilter
        self.k = k
        size = 1 << max(int(size_bits) - 1, 1).bit_length()
        self.bits = BitBloomFilter.create(size, k, num_hashes, device=device)

    def redundant_or_add(self, good_filt, seq: str) -> bool:
        codes = alphabet.encode(seq)
        if len(codes) < self.k:
            return False
        f, r, canon, valid = nthash.kmer_hashes_padded(codes, self.k,
                                                       self.bits.device)
        good = good_filt.contains(canon, valid)
        have = self.bits.contains(canon, valid)
        redundant = bool((~good | have).all())
        if not redundant:
            self.bits = self.bits.insert(canon, good)
        return redundant


# ---------------------------------------------------------------------------
# legacy API (sealer + existing tests): thin adapter over the new engine

def connect_pairs(cbf, pairs, k: int, max_gap: int = 800,
                  max_paths: int = 2, max_frontier: int = 64,
                  max_mismatches: int = 2) -> list[ConnectResult]:
    """Back-compat wrapper: connect with a max fragment length derived
    from max_gap (the old parameter meant max BFS depth ~ gap bases).
    max_frontier is accepted but ignored — the rebuilt engine uses the
    reference's cost cap (-C) instead of the old arbitrary frontier
    cutoff, so callers (sealer) only gain reach."""
    params = ConnectPairsParams(
        max_paths=max_paths,
        max_frag=max_gap + 2 * max((len(p[0]) for p in pairs),
                                   default=100),
        max_path_mismatches=max_mismatches,
        max_branches=NO_LIMIT)
    res = connect_pairs_full(cbf, pairs, k, params)
    # legacy reason names
    legacy = {"FOUND_PATH": "CONNECTED", "NO_KMER": "NO_KMER"}
    for r in res:
        r.reason = legacy.get(r.reason, r.reason)
    return res


def extend_outward(cbf, seqs: list[str], k: int,
                   trim: int | None = None, lookahead_width: int = 16,
                   chunk: int = 1024, max_len: int = 100000) -> list[str]:
    """konnector --extend: extend each connected pseudo-read outward
    through the DBG until a branch or dead end (konnector.cc's
    extendRead / bloom-dbg extendPath both directions)."""
    from ..dbg import extend as ext
    keep = [i for i, s in enumerate(seqs) if s and len(s) >= k]
    if not keep:
        return list(seqs)
    cbf = ext.walk_filter(cbf)
    trim = trim if trim is not None else k
    M = len(keep)
    right_seeds = np.zeros((M, k), np.uint8)
    left_seeds = np.zeros((M, k), np.uint8)
    for j, i in enumerate(keep):
        codes = alphabet.encode(seqs[i])
        right_seeds[j] = codes[-k:]
        left_seeds[j] = alphabet.revcomp_codes(codes[:k])
    rbuf, rlen, _ = ext.extend_forward(
        cbf, right_seeds, k, trim, lookahead_width, chunk, max_len)
    lbuf, llen, _ = ext.extend_forward(
        cbf, left_seeds, k, trim, lookahead_width, chunk, max_len)
    out = list(seqs)
    for j, i in enumerate(keep):
        right_ext = alphabet.decode(rbuf[j, k:rlen[j]])
        left_ext = alphabet.decode(
            alphabet.revcomp_codes(lbuf[j, k:llen[j]]))
        out[i] = left_ext + seqs[i] + right_ext
    return out


def merge_or_na(res: ConnectResult) -> str | None:
    return res.seq if res.reason in ("CONNECTED", "FOUND_PATH") else None
