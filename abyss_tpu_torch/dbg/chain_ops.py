"""Device-resident chain machinery for the exact DBG engine.

Port of abyss_tpu/dbg/chain_ops.py: the post-adjacency phases of
dbg/hash_dbg.py (erode, trim, the chain decomposition that bubbles,
the low-coverage loop and emission read) as torch ops on the table's
device, bit for bit the JAX programs' results:

  oriented successors   -> one elementwise + gather pass over all rows
                           (the vector form of SplitAlgorithm.h:28-100)
  list ranking          -> pointer doubling; for trim it is capped at
                           ceil(log2(t)) rounds (a chain longer than the
                           tip bound can never be trimmed)
  chain decomposition   -> one unsigned sort of packed (head, pos) keys
                           and running max / min segment fills
  trim kill rules       -> segment gathers + one scatter
                           (processTerminatedBranchTrim:186-199)
  erode                 -> weak-chain removal rounds
                           (ErodeAlgorithm.h:63-113)

Cycles (circular unitigs) are broken at their minimum oriented vertex:
a min-reduction rides the pointer doubling, the edge into each cycle's
minimum is cut and the ranking runs again.

Differences from the JAX programs, none visible in a result:
  * `_full_rank`'s while_loop is a host loop: one device-to-host read
    of "did any pointer move" a round (at most 34 rounds, as the JAX
    cap), and the cycle re-rank runs only when a cycle exists;
  * torch has no `mode="drop"` scatter, so every dropped index of the
    JAX code lands in a sink slot one past the end, which is cut off;
  * the gathers through a clamped index (`clamp(min=0)`) keep the
    clamp explicit: a missing neighbour reads row 0, then is masked;
  * vertex ids, positions and indices are int64 on the device (the
    JAX code's int32 values, which `DeviceDBG` asserts fit);
  * keys are int64 words with uint64 bits (u64.py): the all-ones
    sentinel is -1 and every sort of keys is unsigned (`u64.usort`),
    so the sentinel still sorts last.

`_erode_rounds_dev` of the JAX module (the layer-peeling erode) is not
ported: nothing in the JAX package calls it.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import resolve_device, u64
from ..ops import nthash
from ..ops.scan import running_max, running_min

_SENT = u64.ALL_ONES
# an int32 oriented-vertex id 2 * row + strand must fit (the JAX code's
# dtype)
MAX_ROWS = 1 << 30


def _interleave(a, b):
    """[N],[N] -> [2N] with out[2i]=a[i], out[2i+1]=b[i]."""
    return torch.stack([a, b], dim=-1).reshape(-1)


def _rc_packed(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2-bit packed k-mers (int64 words holding
    uint64 bits; every right shift logical)."""
    x = ~x
    for shift, lo in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                      (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF)):
        hi = u64.s64(~lo)
        x = ((x & lo) << shift) | u64.srl(x & hi, shift)
    x = (x << 32) | u64.srl(x, 32)
    return u64.srl(x, 64 - 2 * k)


def _degrees_dev(nbr8, alive):
    """(right_deg, left_deg) int32[N] over alive targets.

    nbr8: [8, N] neighbour rows or -1 (direction-major, as the JAX
    package keeps it)."""
    ok = (nbr8 >= 0) & alive[nbr8.clamp(min=0)]
    return (ok[:4].sum(dim=0, dtype=torch.int32),
            ok[4:].sum(dim=0, dtype=torch.int32))


# --------------------------------------------------------------------------
# oriented successors


def _successors(N, rd, ld, palin, nbr8, alive, kmers, walk_word):
    """Unique-successor links of both strands: the part `_nxt_packed`
    and `_nxt_wide` share.  walk_word(strand, base) is the successor
    word in walk orientation (packed k-mer or rolled hash)."""
    dev = kmers.device

    def one_strand(strand):
        cols = nbr8[:4] if strand == 0 else nbr8[4:]
        okc = (cols >= 0) & alive[cols.clamp(min=0)]
        sub = torch.where(okc, cols, -1)            # [4, N]
        tgt = sub.max(dim=0).values                 # unique when deg == 1
        base = sub.argmax(dim=0)
        tgt_c = tgt.clamp(min=0)
        same = kmers[tgt_c] == walk_word(strand, base)
        tstrand = torch.where(same, 0, 1)
        deg = rd if strand == 0 else ld
        t_in = torch.where(tstrand == 0, ld[tgt_c], rd[tgt_c])
        good = alive & (deg == 1) & ~palin & (tgt >= 0) & \
            (t_in == 1) & ~palin[tgt_c]
        ov_t = 2 * tgt_c + tstrand
        src = 2 * torch.arange(N, device=dev) + strand
        return torch.where(good & (ov_t != src), ov_t, -1)

    return _interleave(one_strand(0), one_strand(1))


def _nxt_packed(k: int, kmers, nbr8, alive):
    """Unique-successor links nxt[ov] for oriented vertices ov=2*i+s,
    packed mode: the device form of abyss_tpu.dbg.hash_dbg._oriented_next."""
    rd, ld = _degrees_dev(nbr8, alive)
    rc = _rc_packed(kmers, k)
    palin = rc == kmers
    mask = u64.s64((1 << (2 * k)) - 1)

    def walk_word(strand, base):
        if strand == 0:
            return ((kmers << 2) | base) & mask
        # a stored-orientation LEFT extension by base c appends the
        # complement base (3 - c) in the rc walk orientation
        return ((rc << 2) | (3 - base)) & mask

    return _successors(kmers.shape[0], rd, ld, palin, nbr8, alive, kmers,
                       walk_word)


def _nxt_wide(k: int, kmers, hr, firstb, lastb, nbr8, alive):
    """Wide-mode successors: orientation resolved by O(1) ntHash rolls
    of the stored (fwd=canonical, rev=hr) hash state."""
    rd, ld = _degrees_dev(nbr8, alive)
    palin = hr == kmers

    def walk_word(strand, base):
        if strand == 0:
            f2, _ = nthash.roll_right(kmers, hr, k, firstb, base)
        else:
            f2, _ = nthash.roll_right(hr, kmers, k, 3 - lastb.long(),
                                      3 - base)
        return f2

    return _successors(kmers.shape[0], rd, ld, palin, nbr8, alive, kmers,
                       walk_word)


# --------------------------------------------------------------------------
# list ranking


def _prev_of(nxt):
    """Backward links: prev[nxt[v]] = v; heads have prev -1.  The nxt
    relation has in/out-degree <= 1 (both endpoints must be unambiguous),
    so the scatter never collides outside the sink slot n."""
    n = nxt.shape[0]
    idx = torch.where(nxt >= 0, nxt, n)
    prev = torch.full((n + 1,), -1, dtype=torch.int64, device=nxt.device)
    prev[idx] = torch.arange(n, device=nxt.device)
    return prev[:n]


def _capped_rank(nxt, rounds: int):
    """Pointer doubling capped at `rounds`: (head, pos, converged).
    Vertices further than 2**rounds from their chain head stay
    unconverged (their P holds a mid-chain ancestor)."""
    n = nxt.shape[0]
    prev = _prev_of(nxt)
    isroot = prev < 0
    P = torch.where(isroot, torch.arange(n, device=nxt.device), prev)
    dist = (~isroot).to(torch.int64)
    for _ in range(rounds):
        dist = dist + dist[P]
        P = P[P]
    return P, dist, isroot[P]


# the JAX while_loop's cap on pointer-doubling rounds
MAX_RANK_ROUNDS = 34


def _rank(prev_links, with_min: bool):
    """Pointer doubling until no pointer moves (at most MAX_RANK_ROUNDS
    rounds): (P, dist, converged, M), M the running minimum vertex over
    each vertex's ancestors when with_min.  One device-to-host read a
    round."""
    n = prev_links.shape[0]
    iota = torch.arange(n, device=prev_links.device)
    isr = prev_links < 0
    P = torch.where(isr, iota, prev_links)
    d = (~isr).to(torch.int64)
    M = iota
    for _ in range(MAX_RANK_ROUNDS):
        d = d + d[P]
        if with_min:
            M = torch.minimum(M, M[P])
        P2 = P[P]
        changed = bool((P2 != P).any())
        P = P2
        if not changed:
            break
    return P, d, isr[P], M


def _full_rank(nxt):
    """Full list ranking with cycle breaking: (head, pos).  Cycles are
    broken at their minimum oriented vertex, matching
    abyss_tpu.dbg.hash_dbg._pointer_double's host resolution."""
    n = nxt.shape[0]
    prev = _prev_of(nxt)
    P, dist, conv, M = _rank(prev, True)
    if bool((~conv).any()):
        # cut the edge into each cycle's minimum member, re-rank
        cut = (~conv) & (nxt == M)
        idx = torch.where(cut, nxt.clamp(min=0), n)
        prev2 = torch.cat([prev, prev.new_full((1,), -1)])
        prev2[idx] = -1
        P, dist, _, _ = _rank(prev2[:n], False)
    return P, dist


# --------------------------------------------------------------------------
# chain segments in sorted (head, pos) order


def _seg_fills(sk):
    """Given sorted packed keys (head<<32|pos, SENT for excluded):
    (valid, start, start_pos, end_pos) per element."""
    n = sk.shape[0]
    dev = sk.device
    valid = sk != _SENT
    head = u64.srl(sk, 32)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, head[1:] != head[:-1]])
    lastf = torch.cat([head[:-1] != head[1:], one])
    start = valid & first
    last = valid & lastf
    pos = torch.arange(n, device=dev)
    start_pos = running_max(torch.where(start, pos, -1))
    end_pos = running_min(torch.where(last, pos, n), reverse=True)
    return valid, start, start_pos, end_pos


def _sorted_chain_keys(P, dist, alive_ov):
    """Unsigned sort of (head << 32 | pos) keys, the sentinel for the
    excluded vertices: (sorted keys, oriented vertex of each).  Keys are
    unique apart from the sentinel, so the unstable sort is exact on the
    valid prefix."""
    key = torch.where(alive_ov, (P << 32) | dist, _SENT)
    return u64.usort(key)


def _trim_round_impl(nxt, outdeg_ov, indeg_ov, alive, counts, max_tip,
                     rounds_t: int):
    """One batched trimSequences pass (TrimAlgorithm.h:38-99) with the
    ranking capped at the tip bound: chains longer than max_tip can
    never be killed, and any chain of length <= max_tip fully converges
    within ceil(log2(max_tip)) doubling rounds, so truncated chains
    appear with observed length 2**rounds+1 > max_tip and fail `short`.
    Returns (new_alive, rows_removed)."""
    N = alive.shape[0]
    P, dist, conv = _capped_rank(nxt, rounds_t)
    alive_ov = alive.repeat_interleave(2) & conv
    sk, ov_s = _sorted_chain_keys(P, dist, alive_ov)
    valid, start, start_pos, end_pos = _seg_fills(sk)
    length = end_pos - start_pos + 1
    headv = ov_s[start_pos.clamp(min=0)]
    endv = ov_s[end_pos.clamp(0, 2 * N - 1)]
    start_blunt = indeg_ov[headv] == 0
    removing_end = outdeg_ov[endv] <= 1       # BS_NOEXT / BS_AMBI_OPP
    kill = valid & start_blunt & (length <= max_tip) & removing_end
    return _kill_rows(alive, kill, ov_s)


def _kill_rows(alive, kill, ov_s):
    """alive with the rows of the killed oriented vertices cleared (a
    scatter whose misses go to the sink slot N), and how many alive rows
    died."""
    N = alive.shape[0]
    rows = torch.where(kill, ov_s >> 1, N)
    killrow = torch.zeros(N + 1, dtype=torch.bool, device=alive.device)
    killrow[rows] = True
    killrow = killrow[:N]
    removed = (alive & killrow).sum(dtype=torch.int32)
    return alive & ~killrow, removed


def _erode_round_impl(nxt, indeg_ov, alive, weak):
    """One erode round: remove every blunt-started chain of the weak
    subgraph (see DeviceDBG.erode).  Returns (new_alive, rows_removed).
    """
    weak_ov = weak.repeat_interleave(2)
    nxt_w = torch.where(
        weak_ov & (nxt >= 0) & weak_ov[nxt.clamp(min=0)], nxt, -1)
    P, dist = _full_rank(nxt_w)
    alive_ov = alive.repeat_interleave(2) & weak_ov
    sk, ov_s = _sorted_chain_keys(P, dist, alive_ov)
    valid, start, start_pos, end_pos = _seg_fills(sk)
    headv = ov_s[start_pos.clamp(min=0)]
    kill = valid & (indeg_ov[headv] == 0)
    return _kill_rows(alive, kill, ov_s)


def _chains_sorted_dev(nxt, alive):
    """Full chain decomposition: sorted (head, pos) order of all alive
    oriented vertices.  Returns (ov_s, start flags, alive_ov_count);
    the alive prefix of ov_s/start is the only data emission needs."""
    P, dist = _full_rank(nxt)
    alive_ov = alive.repeat_interleave(2)
    sk, ov_s = _sorted_chain_keys(P, dist, alive_ov)
    start = (sk != _SENT) & ((sk & 0xFFFFFFFF) == 0)
    return ov_s, start, alive_ov.sum(dtype=torch.int32)


# --------------------------------------------------------------------------
# host-facing wrapper


class DeviceDBG:
    """Device-resident view of a KmerTable for the chain phases, on the
    table's device.

    Uploads kmers/adjacency/counts once; `alive` lives on the device
    across erode/trim rounds and is synced back to the host table by
    the hash_dbg phase wrappers.  Adjacency is direction-major [8, N].
    The table caches its view (hash_dbg._device_dbg), so the view holds
    the table weakly: the pair is freed, device copies and all, as soon
    as the table's last user drops it, not at the next cyclic garbage
    collection.
    """

    def __init__(self, t):
        if t.n >= MAX_ROWS:
            raise ValueError(f"{t.n} k-mer rows: oriented vertex ids "
                             f"2 * row + strand must fit in int32")
        dev = resolve_device(t.device)
        self._table = weakref.ref(t)
        self.k = t.k
        self.n = t.n
        self.wide = t.wide
        self.device = dev
        self.kmers_d = u64.from_numpy(t.kmers, dev)
        self.nbr_d = torch.from_numpy(
            np.ascontiguousarray(t.nbr.T).astype(np.int64)).to(dev)
        self.counts_d = torch.from_numpy(np.asarray(t.counts)).to(dev)
        if self.wide:
            self.hr_d = u64.from_numpy(t.hr, dev)
            fb, lb = t.end_bases()
            self.firstb_d = torch.from_numpy(fb).to(dev)
            self.lastb_d = torch.from_numpy(lb).to(dev)
        self.sync_from_host()

    @property
    def t(self):
        return self._table()

    def sync_from_host(self):
        self.alive_d = torch.from_numpy(
            np.array(self.t.alive, bool)).to(self.device)

    def sync_to_host(self):
        self.t.alive = self.alive_d.cpu().numpy().copy()

    def _nxt(self):
        if self.wide:
            return _nxt_wide(self.k, self.kmers_d, self.hr_d,
                             self.firstb_d, self.lastb_d,
                             self.nbr_d, self.alive_d)
        return _nxt_packed(self.k, self.kmers_d, self.nbr_d, self.alive_d)

    def _deg_ov(self):
        rd, ld = _degrees_dev(self.nbr_d, self.alive_d)
        outdeg = _interleave(rd, ld)
        indeg = _interleave(ld, rd)
        return outdeg, indeg

    def erode(self, e: int, e_strand: int = 0) -> int:
        """Erode fixpoint by weak-chain removal (the JAX package's
        DeviceDBG.erode): each round ranks the chains of the weak
        subgraph and removes every blunt-started weak chain whole, so
        rounds equal the branching depth of the eroded region, not its
        length.  One device-to-host read a round."""
        weak = self.counts_d < e
        if e_strand > 0 and self.t.fwd_counts is not None:
            fwd = torch.from_numpy(np.asarray(self.t.fwd_counts)).to(
                self.device)
            rev = self.counts_d - fwd
            weak = weak | (fwd < e_strand) | (rev < e_strand)
        total = 0
        while True:
            nxt = self._nxt()
            outdeg, indeg = self._deg_ov()
            self.alive_d, removed = _erode_round_impl(
                nxt, indeg, self.alive_d, weak)
            removed = int(removed)
            if removed == 0:
                return total
            total += removed

    def trim(self, max_tip: int) -> int:
        if max_tip <= 0:
            return 0
        rounds_t = max(int(np.ceil(np.log2(max_tip))), 0) if max_tip > 1 \
            else 0
        total = 0
        while True:
            nxt = self._nxt()
            outdeg, indeg = self._deg_ov()
            self.alive_d, removed = _trim_round_impl(
                nxt, outdeg, indeg, self.alive_d, self.counts_d,
                max_tip, rounds_t)
            removed = int(removed)
            if removed == 0:
                return total
            total += removed

    def chains(self):
        """Host chain structure: (ov_s, sidx, lengths) — the sorted
        alive oriented vertices, segment start indices, and per-chain
        lengths.  One device-to-host copy of the alive prefix."""
        ov_s_d, start_d, cnt_d = _chains_sorted_dev(self._nxt(),
                                                    self.alive_d)
        a = int(cnt_d)
        if a == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        ov_s = ov_s_d[:a].to(torch.int32).cpu().numpy()
        start = start_d[:a].cpu().numpy()
        sidx = np.flatnonzero(start)
        lengths = np.diff(np.append(sidx, a))
        return ov_s, sidx, lengths
