"""Device-resident bidirectional constrained BFS for Konnector.

Port of abyss_tpu/gap/konnector_dev.py, as torch ops on the solid
table's device.  The state is split by update frequency, as in the JAX
package:

  frozen operands   the big stores: per-side node payloads (pair, canon,
                    packed words), the visited hash tables (key ->
                    global node index) and the global meet-dedup table.
                    Inside a segment they are only gathered; they are
                    extended once per segment by the merge ops.
  small carries     the frontier buffers, a segment-local node store,
                    segment-local visited/meet hash tables, edge and
                    meet append buffers, and the per-pair cost/fail/ncom
                    arrays.  Everything a level writes is O(frontier).
  in-level dedup    candidates insert their surrogate key into the
                    segment hash table with their lane id as value; a
                    re-lookup names the winning lane (the highest lane of
                    a race, ops/hash_probe.insert), the winners take
                    contiguous global indices, and the stored value is
                    patched to the final index.

Reference semantics: Konnector/konnector.h:235 (connectPairs),
Graph/ConstrainedBidiBFSVisitor.h (depth caps, cost cap, common-edge
cap, non-tree edges).  Every visited/meet hit is verified against exact
(pair, canon, packed text).  Classification and path reconstruction
stay in gap/konnector.py, shared with the host engine.

Differences from the JAX code, none visible in a result:
  * the segment loop (`lax.while_loop`) is a host loop with one
    device-to-host read a level, its loop condition;
  * torch has no `mode="drop"` scatter: every append buffer and every
    frozen store has one sink slot past its capacity (the capacities are
    the JAX shapes and ride in the tuples), which takes the dropped
    writes and is never read; hash-table writes go through
    hash_probe.set_last;
  * indices, pair ids and depths are int64 tensors (the JAX int32
    values); hashes and keys int64 words with uint64 bits.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import u64
from ..ops import hash_probe as hp
from ..ops import nthash
from ..ops.scan import running_sum

U64MAX = u64.ALL_ONES


# --------------------------------------------------------------------------
# packed-word helpers (2-bit k-mer text, base 0 in the top bits)


def _first_base_dev(words):
    return u64.srl(words[:, 0], 62) & 3


def _last_base_dev(words, k: int):
    j = k - 1
    return u64.srl(words[:, j // 32], 62 - 2 * (j % 32)) & 3


def _tail_mask(k: int, W: int) -> int:
    r = k - 32 * (W - 1)
    if r < 32:
        return u64.s64(~((1 << (64 - 2 * r)) - 1) & 0xFFFFFFFFFFFFFFFF)
    return U64MAX


def _shift_right_dev(words, k: int, c):
    """[C, W] words: drop base 0, append base c at k-1."""
    W = words.shape[1]
    out = words << 2
    if W > 1:
        out = torch.cat([out[:, :-1] | u64.srl(words[:, 1:], 62),
                         out[:, -1:]], dim=1)
    j = k - 1
    out[:, j // 32] |= c.long() << (62 - 2 * (j % 32))
    out[:, W - 1] &= _tail_mask(k, W)
    return out


def _shift_left_dev(words, k: int, c):
    """[C, W] words: prepend base c at 0, drop base k-1."""
    W = words.shape[1]
    out = u64.srl(words, 2)
    if W > 1:
        out = torch.cat([out[:, :1], out[:, 1:] | (words[:, :-1] << 62)],
                        dim=1)
    out[:, 0] |= c.long() << 62
    out[:, W - 1] &= _tail_mask(k, W)
    return out


def _mix3(a, b, c):
    return hp.mix64(a + hp.mix64(b + hp.mix64(c)))


def _unpack_words_dev(words, k: int):
    """[F, W] packed words -> [F, k] base codes."""
    j = torch.arange(k, device=words.device)
    wsel = words[:, j // 32]
    sh = 62 - 2 * (j % 32)
    return ((wsel >> sh[None, :]) & 3).to(torch.uint8)


# --------------------------------------------------------------------------
# state


class FrozenSide(NamedTuple):
    """Read-only per-side operands of one segment.  pair/canon/words/
    depth have N + 1 rows and ge_c/ge_p GE + 1, the last a sink."""
    pair: torch.Tensor    # int64[N + 1]
    canon: torch.Tensor   # int64[N + 1]
    words: torch.Tensor   # int64[N + 1, W]
    depth: torch.Tensor   # int64[N + 1]
    vtk: torch.Tensor     # int64[S + B] visited keys
    vtv: torch.Tensor     # int32[S + B] visited values (global idx)
    n0: torch.Tensor      # int64 scalar: rows merged so far
    ge_c: torch.Tensor    # int64[GE + 1] global edge child
    ge_p: torch.Tensor    # int64[GE + 1] global edge parent
    ge_n: torch.Tensor    # int64 scalar
    N: int
    GE: int


class SegSide(NamedTuple):
    """Small per-side carry: frontier + segment-local appends (s_* with
    SegCap + 1 rows, e_* with SegE + 1, the last a sink)."""
    fr_gidx: torch.Tensor
    fr_pair: torch.Tensor
    fr_fh: torch.Tensor
    fr_rh: torch.Tensor
    fr_words: torch.Tensor
    fr_depth: torch.Tensor
    fr_count: torch.Tensor
    s_pair: torch.Tensor
    s_canon: torch.Tensor
    s_fh: torch.Tensor
    s_rh: torch.Tensor
    s_words: torch.Tensor
    s_depth: torch.Tensor
    s_vtk: torch.Tensor
    s_vtv: torch.Tensor
    s_n: torch.Tensor
    e_child: torch.Tensor
    e_parent: torch.Tensor
    e_n: torch.Tensor


class SegState(NamedTuple):
    f: SegSide
    r: SegSide
    m_pair: torch.Tensor   # int64[SegM + 1]
    m_f: torch.Tensor      # global F-node idx
    m_r: torch.Tensor      # global R-node idx
    m_key: torch.Tensor    # int64[SegM + 1]
    sm_tk: torch.Tensor    # segment meet-dedup keys
    sm_tv: torch.Tensor
    m_n: torch.Tensor
    cost: torch.Tensor     # int64[P + 1]
    fail: torch.Tensor     # int64[P + 1]  0 ok / 1 paths / 3 cost
    ncom: torch.Tensor     # int64[P + 1]
    hard: torch.Tensor     # int64 scalar: hash-table insert overflow


def _cap(buf: torch.Tensor) -> int:
    """Capacity of a buffer with a sink slot."""
    return buf.shape[0] - 1


def _put(buf, dest, vals, ok):
    """buf[dest] = vals where ok; the other lanes write the sink."""
    buf[torch.where(ok, dest, _cap(buf))] = vals
    return buf


def _g2(garr, sarr, idx, n0, gcap: int, scap: int):
    """Two-path gather: global rows [0, n0) from the frozen store, rows
    >= n0 from the segment store (indices clamped as the JAX gather
    clamps them)."""
    ins = idx >= n0
    g = garr[idx.clamp(0, gcap - 1)]
    s = sarr[(idx - n0).clamp(0, scap - 1)]
    m = ins.reshape(ins.shape + (1,) * (g.dim() - 1))
    return torch.where(m, s, g)


def _vlookup(fz: FrozenSide, side: SegSide, q):
    """Visited probe over frozen + segment tables (keys live in exactly
    one)."""
    f1, v1 = hp.lookup(fz.vtk, fz.vtv, q)
    f2, v2 = hp.lookup(side.s_vtk, side.s_vtv, q)
    return f1 | f2, torch.where(f2, v2, v1).long()


def _side_level(st: SegState, fwd: bool, own_fz: FrozenSide,
                oth_fz: FrozenSide, ptab, mtk_g, mtv_g, maxd, *, k: int,
                F_cap: int, max_cost: int, max_paths: int) -> SegState:
    side = st.f if fwd else st.r
    other = st.r if fwd else st.f
    dev = ptab.device
    P = st.cost.shape[0] - 1
    W = side.fr_words.shape[1]
    SegCap = _cap(side.s_pair)
    SegE = _cap(side.e_child)
    SegM = _cap(st.m_pair)

    lane = torch.arange(F_cap, device=dev)
    act = lane < side.fr_count
    ppair = torch.where(act, side.fr_pair, P)
    pwords = side.fr_words
    pfh = torch.where(act, side.fr_fh, 0)
    prh = torch.where(act, side.fr_rh, 0)
    pdep = torch.where(act, side.fr_depth, 0)
    pgidx = side.fr_gidx
    pcanon = u64.umin(pfh, prh)

    c_out = _first_base_dev(pwords) if fwd else _last_base_dev(pwords, k)
    bases = torch.arange(4, device=dev)
    roll = nthash.roll_right if fwd else nthash.roll_left
    f2, r2 = roll(pfh[:, None], prh[:, None], k, c_out[:, None],
                  bases[None, :])
    C = F_cap * 4
    lane4 = torch.arange(C, device=dev)
    cf = f2.reshape(C)
    cr = r2.reshape(C)
    canon = u64.umin(cf, cr)
    cpair = ppair.repeat_interleave(4)
    cparent = pgidx.repeat_interleave(4)
    pcan4 = pcanon.repeat_interleave(4)
    pdep_c = pdep.repeat_interleave(4)
    cdep = pdep_c + 1
    c_in = bases.repeat(F_cap)
    act_c = act.repeat_interleave(4)

    # solid probe + pre-cost fail gate (host engine: solid & fail==0)
    solid = hp.contains(ptab, torch.where(act_c, canon, U64MAX))
    keep0 = act_c & solid & (st.fail[cpair] == 0)

    # cost accounting, then MAX_COST_EXCEEDED
    cost = st.cost.index_add(0, cpair, keep0.long())
    fail = torch.where((cost > max_cost) & (st.fail == 0), 3, st.fail)
    keep = keep0 & (fail[cpair] == 0)

    # child words + surrogate key
    pw4 = pwords.repeat_interleave(4, dim=0)
    cw = _shift_right_dev(pw4, k, c_in) if fwd \
        else _shift_left_dev(pw4, k, c_in)
    skey = canon ^ hp.mix64(cpair)
    q = torch.where(keep, skey, U64MAX)

    # own-side visited lookup (verified: pair, canon, packed text)
    ocap = (own_fz.N, SegCap)
    ofound, oval = _vlookup(own_fz, side, q)
    ovc = oval.clamp(min=0)
    overify = ofound & \
        (_g2(own_fz.pair, side.s_pair, ovc, own_fz.n0, *ocap) == cpair) & \
        (_g2(own_fz.canon, side.s_canon, ovc, own_fz.n0, *ocap) == canon) & \
        (_g2(own_fz.words, side.s_words, ovc, own_fz.n0, *ocap)
         == cw).all(dim=1)
    own_idx = torch.where(overify, oval, -1)

    # other-side (meet) lookup, same verification
    tcap = (oth_fz.N, _cap(other.s_pair))
    tfound, tval = _vlookup(oth_fz, other, q)
    tvc = tval.clamp(min=0)
    tcanon = _g2(oth_fz.canon, other.s_canon, tvc, oth_fz.n0, *tcap)
    tverify = tfound & \
        (_g2(oth_fz.pair, other.s_pair, tvc, oth_fz.n0, *tcap) == cpair) & \
        (tcanon == canon) & \
        (_g2(oth_fz.words, other.s_words, tvc, oth_fz.n0, *tcap)
         == cw).all(dim=1)
    meet_val = torch.where(tverify, tval, -1)

    pd_ok = pdep_c < maxd[cpair]
    is_meet = (meet_val >= 0) & pd_ok & keep

    # ---- meets: dedup on (pair, F-canon, R-canon) -----------------------
    if fwd:
        fnode, rnode = cparent, meet_val.clamp(min=0)
        fcan, rcan = pcan4, tcanon
    else:
        fnode, rnode = meet_val.clamp(min=0), cparent
        fcan, rcan = tcanon, pcan4
    mkey = _mix3(cpair, fcan, rcan)
    mq = torch.where(is_meet, mkey, U64MAX)
    mf1, _ = hp.lookup(mtk_g, mtv_g, mq)
    mf2, _ = hp.lookup(st.sm_tk, st.sm_tv, mq)
    cand_new = is_meet & ~mf1 & ~mf2
    mq_new = torch.where(cand_new, mkey, U64MAX)
    sm_tk, sm_tv, mtfail = hp.insert(st.sm_tk, st.sm_tv, mq_new, lane4,
                                     cand_new)
    _, wl = hp.lookup(sm_tk, sm_tv, mq_new)
    new_w = cand_new & (wl == lane4)
    ncom = st.ncom.index_add(0, cpair, new_w.long())
    fail = torch.where((ncom > max_paths) & (fail == 0)
                       & (torch.arange(P + 1, device=dev) < P), 1, fail)
    mrank = running_sum(new_w.long()) - 1
    mdest = st.m_n + mrank
    mok = new_w & (mdest < SegM)
    m_pair = _put(st.m_pair, mdest, cpair, mok)
    m_f = _put(st.m_f, mdest, fnode, mok)
    m_r = _put(st.m_r, mdest, rnode, mok)
    m_key = _put(st.m_key, mdest, mkey, mok)
    m_n = st.m_n + new_w.sum()
    hard = st.hard | torch.where(mtfail > 0, 16, 0)

    # ---- edges (non-tree + tree + duplicate-discovery) ------------------
    is_old = (own_idx >= 0) & ~is_meet

    # ---- fresh nodes: sort-free in-level dedup, append ------------------
    fresh = keep & ~is_meet & (own_idx < 0) & pd_ok & \
        (fail[cpair] == 0) & (cdep <= maxd[cpair])
    fk = torch.where(fresh, skey, U64MAX)
    s_vtk, s_vtv, vfail = hp.insert(side.s_vtk, side.s_vtv, fk, lane4,
                                    fresh)
    hard = hard | torch.where(vfail > 0, 2, 0)
    _, wl2, slot2 = hp.lookup_slot(s_vtk, s_vtv, fk)
    winner = fresh & (wl2 == lane4)
    rank = running_sum(winner.long()) - 1
    wtotal = winner.sum()
    n_tot = own_fz.n0 + side.s_n
    gdest = n_tot + rank
    sdest = side.s_n + rank
    wok = winner & (sdest < SegCap)
    s_pair = _put(side.s_pair, sdest, cpair, wok)
    s_canon = _put(side.s_canon, sdest, canon, wok)
    s_fh = _put(side.s_fh, sdest, cf, wok)
    s_rh = _put(side.s_rh, sdest, cr, wok)
    s_words = _put(side.s_words, sdest, cw, wok)
    s_depth = _put(side.s_depth, sdest, cdep, wok)
    # patch the table value from winner lane -> final global index
    hp.set_last(s_vtv, slot2, gdest, wok)
    # losers re-read the winner's global index off the patched table
    _, gidx_of = hp.lookup(s_vtk, s_vtv, fk)
    loser = fresh & ~winner

    # edge appends: non-tree (old), tree (winners), duplicate (losers)
    def append(ec, ep, en, child, mask):
        erank = running_sum(mask.long()) - 1
        edest = en + erank
        eok = mask & (edest < SegE)
        _put(ec, edest, child, eok)
        _put(ep, edest, cparent, eok)
        return ec, ep, en + mask.sum()

    ec, ep, en = side.e_child, side.e_parent, side.e_n
    ec, ep, en = append(ec, ep, en, own_idx.clamp(min=0), is_old)
    ec, ep, en = append(ec, ep, en, gdest, wok)
    ec, ep, en = append(ec, ep, en, gidx_of.long().clamp(min=0), loser)

    # new frontier = this level's winners
    fok = wok & (rank < F_cap)

    def frontier(fill, vals, shape=()):
        buf = torch.full((F_cap + 1,) + shape, fill, dtype=torch.int64,
                         device=dev)
        return _put(buf, rank, vals, fok)[:F_cap]

    side = SegSide(
        fr_gidx=frontier(0, gdest), fr_pair=frontier(P, cpair),
        fr_fh=frontier(0, cf), fr_rh=frontier(0, cr),
        fr_words=frontier(0, cw, (W,)), fr_depth=frontier(0, cdep),
        fr_count=wtotal,
        s_pair=s_pair, s_canon=s_canon, s_fh=s_fh, s_rh=s_rh,
        s_words=s_words, s_depth=s_depth, s_vtk=s_vtk, s_vtv=s_vtv,
        s_n=side.s_n + wtotal, e_child=ec, e_parent=ep, e_n=en)
    kw = dict(f=side, r=st.r) if fwd else dict(f=st.f, r=side)
    return st._replace(cost=cost, fail=fail, ncom=ncom, m_pair=m_pair,
                       m_f=m_f, m_r=m_r, m_key=m_key, sm_tk=sm_tk,
                       sm_tv=sm_tv, m_n=m_n, hard=hard, **kw)


def run_segment(st: SegState, fz_f: FrozenSide, fz_r: FrozenSide, ptab,
                mtk_g, mtv_g, maxd_f, maxd_r, *, k: int, T: int,
                F_cap: int, max_cost: int, max_paths: int) -> SegState:
    """Advance up to T BFS levels (both sides per level); stops early on
    frontier overflow or when a segment store is nearly full.  One
    device-to-host read a level: the loop condition."""
    SegCap = _cap(st.f.s_pair)
    SegE = _cap(st.f.e_child)
    SegM = _cap(st.m_pair)
    for _ in range(T):
        f, r = st.f, st.r
        # room for the NEXT level's worst case given the CURRENT
        # frontiers
        room = ((f.s_n + 4 * f.fr_count <= SegCap) &
                (r.s_n + 4 * r.fr_count <= SegCap) &
                (f.e_n + 12 * f.fr_count <= SegE) &
                (r.e_n + 12 * r.fr_count <= SegE) &
                (st.m_n + 4 * (f.fr_count + r.fr_count) <= SegM))
        go = ((st.hard == 0) & room &
              ((f.fr_count > 0) | (r.fr_count > 0)) &
              (f.fr_count <= F_cap) & (r.fr_count <= F_cap))
        if not bool(go):
            break
        st = _side_level(st, True, fz_f, fz_r, ptab, mtk_g, mtv_g,
                         maxd_f, k=k, F_cap=F_cap, max_cost=max_cost,
                         max_paths=max_paths)
        st = _side_level(st, False, fz_r, fz_f, ptab, mtk_g, mtv_g,
                         maxd_r, k=k, F_cap=F_cap, max_cost=max_cost,
                         max_paths=max_paths)
    return st


# --------------------------------------------------------------------------
# host orchestration


class PulledSide:
    """Host view of one side: full node arrays (indices ARE global ids)
    + parent edges.  Attribute-compatible with gap/konnector's
    classification/reconstruction code."""

    def __init__(self, pair, canon, depth, words, e_child, e_parent):
        self.pair = pair
        self.canon = canon
        self.depth = depth
        self.words = words
        self.e_child = e_child
        self.e_parent = e_parent


def _bucket(n: int, lo: int = 64) -> int:
    return max(lo, 1 << max(int(n) - 1, 1).bit_length())


solid_table = hp.solid_table


def device_capable(filt) -> bool:
    return all(hasattr(filt, a) for a in ("kmers", "counts", "threshold"))


def _merge_side(fz: FrozenSide, side: SegSide):
    """Append the segment's nodes and edges into the frozen store and
    insert the new visited keys.  Returns (fz, overfull), overfull a
    device bool."""
    SegCap = _cap(side.s_pair)
    SegE = _cap(side.e_child)
    dev = fz.pair.device
    i = torch.arange(SegCap, device=dev)
    mask = i < side.s_n
    dest = fz.n0 + i
    ok = mask & (dest < fz.N)
    for dst, src in ((fz.pair, side.s_pair), (fz.canon, side.s_canon),
                     (fz.words, side.s_words), (fz.depth, side.s_depth)):
        _put(dst, dest, src[:SegCap], ok)
    skey = side.s_canon[:SegCap] ^ hp.mix64(side.s_pair[:SegCap])
    vtk, vtv, vfail = hp.insert(
        fz.vtk, fz.vtv, torch.where(mask, skey, U64MAX), dest, mask)
    j = torch.arange(SegE, device=dev)
    emask = j < side.e_n
    edest = fz.ge_n + j
    eok = emask & (edest < fz.GE)
    _put(fz.ge_c, edest, side.e_child[:SegE], eok)
    _put(fz.ge_p, edest, side.e_parent[:SegE], eok)
    overfull = ((fz.n0 + side.s_n > fz.N) | (fz.ge_n + side.e_n > fz.GE) |
                (vfail > 0))
    return fz._replace(vtk=vtk, vtv=vtv, n0=fz.n0 + side.s_n,
                       ge_n=fz.ge_n + side.e_n), overfull


def _merge_meets(gm, st: SegState):
    """Append segment meets to the global meet arrays + dedup table."""
    m_pair_g, m_f_g, m_r_g, gm_n, mtk_g, mtv_g = gm
    SegM = _cap(st.m_pair)
    GM = _cap(m_pair_g)
    i = torch.arange(SegM, device=m_pair_g.device)
    mask = i < st.m_n
    dest = gm_n + i
    ok = mask & (dest < GM)
    _put(m_pair_g, dest, st.m_pair[:SegM], ok)
    _put(m_f_g, dest, st.m_f[:SegM], ok)
    _put(m_r_g, dest, st.m_r[:SegM], ok)
    mtk_g, mtv_g, mfail = hp.insert(
        mtk_g, mtv_g, torch.where(mask, st.m_key[:SegM], U64MAX),
        torch.zeros(SegM, dtype=torch.int64, device=mask.device), mask)
    overfull = (gm_n + st.m_n > GM) | (mfail > 0)
    return (m_pair_g, m_f_g, m_r_g, gm_n + st.m_n, mtk_g, mtv_g), overfull


def _grow_side(fz: FrozenSide, N2: int, S2: int, GE2: int):
    """Reallocate the frozen store; the visited table is rebuilt on the
    device from the rows merged so far.  Returns (fz, failed)."""
    N, GE = fz.N, fz.GE
    dev = fz.pair.device

    def grow(a, n_old, n_new, fill):
        pad = torch.full((n_new - n_old + 1,) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=dev)
        return torch.cat([a[:n_old], pad])

    pair = grow(fz.pair, N, N2, 0)
    canon = grow(fz.canon, N, N2, 0)
    words = grow(fz.words, N, N2, 0)
    depth = grow(fz.depth, N, N2, 0)
    ge_c = grow(fz.ge_c, GE, GE2, -1)
    ge_p = grow(fz.ge_p, GE, GE2, -1)
    vtk = torch.full((S2 + hp.B,), U64MAX, dtype=torch.int64, device=dev)
    vtv = torch.full((S2 + hp.B,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(N2, device=dev)
    live = rows < fz.n0
    skeys = torch.where(live, canon[:N2] ^ hp.mix64(pair[:N2]), U64MAX)
    vtk, vtv, vfail = hp.insert(vtk, vtv, skeys, rows, live)
    return FrozenSide(pair, canon, words, depth, vtk, vtv, fz.n0,
                      ge_c, ge_p, fz.ge_n, N2, GE2), vfail


def _fresh_seg(F_cap: int, SegCap: int, SegE: int, SegM: int, W: int,
               P: int, cost, fail, ncom, fr_f, fr_r, dev) -> SegState:
    SegTab = 4 * SegCap
    SegMT = 4 * SegM

    def full(n, fill, shape=(), dtype=torch.int64):
        return torch.full((n,) + shape, fill, dtype=dtype, device=dev)

    def mkside(fr):
        return SegSide(
            fr_gidx=fr[0], fr_pair=fr[1], fr_fh=fr[2], fr_rh=fr[3],
            fr_words=fr[4], fr_depth=fr[5], fr_count=fr[6],
            s_pair=full(SegCap + 1, 0), s_canon=full(SegCap + 1, 0),
            s_fh=full(SegCap + 1, 0), s_rh=full(SegCap + 1, 0),
            s_words=full(SegCap + 1, 0, (W,)), s_depth=full(SegCap + 1, 0),
            s_vtk=full(SegTab + hp.B, U64MAX),
            s_vtv=full(SegTab + hp.B, -1, dtype=torch.int32),
            s_n=torch.zeros((), dtype=torch.int64, device=dev),
            e_child=full(SegE + 1, -1), e_parent=full(SegE + 1, -1),
            e_n=torch.zeros((), dtype=torch.int64, device=dev))

    return SegState(
        f=mkside(fr_f), r=mkside(fr_r),
        m_pair=full(SegM + 1, -1), m_f=full(SegM + 1, -1),
        m_r=full(SegM + 1, -1), m_key=full(SegM + 1, 0),
        sm_tk=full(SegMT + hp.B, U64MAX),
        sm_tv=full(SegMT + hp.B, -1, dtype=torch.int32),
        m_n=torch.zeros((), dtype=torch.int64, device=dev),
        cost=cost, fail=fail, ncom=ncom,
        hard=torch.zeros((), dtype=torch.int64, device=dev))


def _frontier_pad(fr, F_old: int, F_new: int, P: int):
    """Re-bucket frontier buffers to a new F_cap."""
    gidx, pair, fh, rh, words, depth, count = fr
    if F_new == F_old:
        return fr

    def pad(a, fill):
        if F_new > F_old:
            padshape = (F_new - F_old,) + tuple(a.shape[1:])
            return torch.cat([a, torch.full(padshape, fill, dtype=a.dtype,
                                            device=a.device)])
        return a[:F_new]

    return (pad(gidx, 0), pad(pair, P), pad(fh, 0), pad(rh, 0),
            pad(words, 0), pad(depth, 0), count)


def _init_frozen(A, active, words, fh, rh, N, S, GE, W, P, dev):
    pair = np.full(N + 1, P, np.int64)
    pair[:A] = active
    canon = np.zeros(N + 1, np.uint64)
    canon[:A] = np.minimum(fh, rh)
    wa = np.zeros((N + 1, W), np.uint64)
    wa[:A] = words
    skey = canon[:A] ^ hp._mix_np(active.astype(np.uint64))
    vtk, vtv = hp.build_kv(skey, np.arange(A, dtype=np.int32), size=S)
    if vtk.shape[0] != S + hp.B:
        return None  # host build grew the table; caller resizes

    def t(a):
        return u64.from_numpy(a, dev)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return FrozenSide(t(pair), t(canon), t(wa),
                      torch.zeros(N + 1, dtype=torch.int64, device=dev),
                      t(vtk), torch.from_numpy(vtv).to(dev), zero + A,
                      torch.full((GE + 1,), -1, dtype=torch.int64,
                                 device=dev),
                      torch.full((GE + 1,), -1, dtype=torch.int64,
                                 device=dev), zero, N, GE)


def search(filt, P: int, active: np.ndarray, s_k: np.ndarray,
           g_k: np.ndarray, s_words: np.ndarray, g_words: np.ndarray,
           s_fh, s_rh, g_fh, g_rh, maxd_f: np.ndarray,
           maxd_r: np.ndarray, k: int, params, verbose: bool = False):
    """Run the device BFS for one chunk on the filter's device.

    Returns (F_side, R_side, cost, fail, meets, ncom) with sides as
    PulledSide (host numpy, global indices), or None when the engine
    cannot run this chunk (host fallback)."""
    A = len(active)
    W = s_words.shape[1]
    max_cost = int(min(params.max_cost, (1 << 30)))
    max_paths = int(params.max_paths)
    T = 48
    N_LIMIT = 1 << int(os.environ.get("ABYSS_TPU_KONN_LOG_LIMIT", 24))

    N = _bucket(max(4 * A, 1 << 14))
    ptab = solid_table(filt)
    dev = ptab.device

    def maxd(m):
        return torch.from_numpy(np.concatenate(
            [np.minimum(m, 1 << 30).astype(np.int64), [0]])).to(dev)

    maxd_f_d, maxd_r_d = maxd(maxd_f), maxd(maxd_r)

    fz_f = _init_frozen(A, active, s_words, s_fh, s_rh, N, 4 * N, 2 * N,
                        W, P, dev)
    fz_r = _init_frozen(A, active, g_words, g_fh, g_rh, N, 4 * N, 2 * N,
                        W, P, dev)
    if fz_f is None or fz_r is None:
        return None

    GM = 1 << 16
    SMG = 1 << 18
    gm = (torch.full((GM + 1,), -1, dtype=torch.int64, device=dev),
          torch.full((GM + 1,), -1, dtype=torch.int64, device=dev),
          torch.full((GM + 1,), -1, dtype=torch.int64, device=dev),
          torch.zeros((), dtype=torch.int64, device=dev),
          torch.full((SMG + hp.B,), U64MAX, dtype=torch.int64, device=dev),
          torch.full((SMG + hp.B,), -1, dtype=torch.int32, device=dev))

    cost = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    fail = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    ncom = torch.zeros(P + 1, dtype=torch.int64, device=dev)

    F_cap = _bucket(A)

    def init_frontier(active_, fh, rh, words, F):
        Aa = len(active_)
        gidx = np.zeros(F, np.int64)
        gidx[:Aa] = np.arange(Aa)
        pair = np.full(F, P, np.int64)
        pair[:Aa] = active_
        fh_a = np.zeros(F, np.uint64)
        fh_a[:Aa] = fh
        rh_a = np.zeros(F, np.uint64)
        rh_a[:Aa] = rh
        wa = np.zeros((F, W), np.uint64)
        wa[:Aa] = words
        return tuple(u64.from_numpy(a, dev) for a in (
            gidx, pair, fh_a, rh_a, wa, np.zeros(F, np.int64))) + (
            torch.tensor(Aa, dtype=torch.int64, device=dev),)

    fr_f = init_frontier(active, s_fh, s_rh, s_words, F_cap)
    fr_r = init_frontier(active, g_fh, g_rh, g_words, F_cap)

    def frontier_of(s: SegSide):
        return (s.fr_gidx, s.fr_pair, s.fr_fh, s.fr_rh, s.fr_words,
                s.fr_depth, s.fr_count)

    for _round in range(100000):
        SegCap = max(1 << 13, 16 * F_cap)
        SegE = 4 * SegCap
        SegM = max(1 << 12, 16 * F_cap)
        st = _fresh_seg(F_cap, SegCap, SegE, SegM, W, P, cost, fail,
                        ncom, fr_f, fr_r, dev)
        st = run_segment(st, fz_f, fz_r, ptab, gm[4], gm[5], maxd_f_d,
                         maxd_r_d, k=k, T=T, F_cap=F_cap,
                         max_cost=max_cost, max_paths=max_paths)
        cost, fail, ncom = st.cost, st.fail, st.ncom

        # merges run unconditionally (device-side overfull flags); the
        # eight control scalars cross in one copy
        fz_f, of_f = _merge_side(fz_f, st.f)
        fz_r, of_r = _merge_side(fz_r, st.r)
        gm, of_m = _merge_meets(gm, st)
        fcf, fcr, hard, off, ofr, ofm, n0f, n0r = (int(x) for x in torch.stack(
            [st.f.fr_count, st.r.fr_count, st.hard, of_f.long(),
             of_r.long(), of_m.long(), fz_f.n0, fz_r.n0]).cpu())
        if hard:
            if verbose:
                print(f"[konnector-dev] hash overflow (mask {hard}); "
                      f"host fallback", flush=True)
            return None
        if off or ofr or ofm:
            # a global store overflowed during the merge: grow and replay
            # this segment's merge on the regrown store, from the
            # pre-merge row counts
            def regrow(fz, stside, n0_new):
                N2 = _bucket(max(int(n0_new) * 2, fz.N))
                if N2 > N_LIMIT:
                    return None
                fzb = fz._replace(n0=fz.n0 - stside.s_n,
                                  ge_n=fz.ge_n - stside.e_n)
                fz2, vfail = _grow_side(fzb, N2, 4 * N2, 2 * N2)
                if int(vfail):
                    return None
                fz2, of2 = _merge_side(fz2, stside)
                if bool(of2):
                    return None
                return fz2

            if off:
                fz_f = regrow(fz_f, st.f, n0f)
                if fz_f is None:
                    return None
            if ofr:
                fz_r = regrow(fz_r, st.r, n0r)
                if fz_r is None:
                    return None
            if ofm:
                return None  # meet stores are generously sized
        if fcf == 0 and fcr == 0:
            break

        # frontier re-bucket (grow on overflow, shrink on narrow tails)
        need = _bucket(max(fcf, fcr))
        if fcf > F_cap or fcr > F_cap:
            # frontier overflowed its buffers: rebuild from the last
            # level's winners, now merged at the top of the global
            # store; fh/rh are not stored globally, so recompute them
            # from the packed words with one hash call
            def rebuild(fz, cnt, F):
                lo = fz.n0 - cnt
                ar = torch.arange(F, device=dev)
                ok = ar < cnt
                ic = (ar + lo).clamp(0, fz.N - 1)
                words = torch.where(ok[:, None], fz.words[ic], 0)
                fh, rh = nthash.hash_base(_unpack_words_dev(words, k), k)
                return (torch.where(ok, ic, 0),
                        torch.where(ok, fz.pair[ic], P),
                        torch.where(ok, fh, 0), torch.where(ok, rh, 0),
                        words, torch.where(ok, fz.depth[ic], 0),
                        torch.tensor(cnt, dtype=torch.int64, device=dev))

            fr_f = rebuild(fz_f, fcf, need)
            fr_r = rebuild(fz_r, fcr, need)
            F_cap = need
        else:
            fr_f = _frontier_pad(frontier_of(st.f), F_cap, need, P)
            fr_r = _frontier_pad(frontier_of(st.r), F_cap, need, P)
            F_cap = need
    else:
        return None

    # one bulk pull at the end
    def pull_side(fz):
        n0 = int(fz.n0)
        en = int(fz.ge_n)
        return PulledSide(
            fz.pair[:n0].cpu().numpy(), u64.to_numpy(fz.canon[:n0]),
            fz.depth[:n0].cpu().numpy().astype(np.int32),
            u64.to_numpy(fz.words[:n0]),
            fz.ge_c[:en].cpu().numpy(), fz.ge_p[:en].cpu().numpy())

    F = pull_side(fz_f)
    R = pull_side(fz_r)
    cost_h = cost[:P].cpu().numpy()
    fail_h = fail[:P].cpu().numpy().astype(np.int8)
    ncom_h = ncom[:P].cpu().numpy()
    meets = []
    mn = min(int(gm[3]), GM)
    if mn:
        mp = gm[0][:mn].cpu().numpy()
        mf = gm[1][:mn].cpu().numpy()
        mr = gm[2][:mn].cpu().numpy()
        ok = (mp >= 0) & (mp < P)
        for i, fi, ri in zip(mp[ok], mf[ok], mr[ok]):
            meets.append((int(i), int(fi), int(ri)))
    return F, R, cost_h, fail_h, meets, ncom_h
