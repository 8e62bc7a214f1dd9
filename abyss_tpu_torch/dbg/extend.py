"""Batched unitig extension over the solid-k-mer graph.

Port of abyss_tpu/dbg/extend.py.  A whole batch of paths advances in
lockstep: each step probes the 4 right extensions and 4 left
predecessors of every active path head with O(1) incremental ntHash
rolls and one membership probe, then advances the unambiguous paths.
The reference's semantics are kept as in the JAX package:

  * successor()'s doubling schedule (ExtendPath.h:346-383) decides
    forks by branch look-aheads of depth 0, 1, 2, 4, ... trim;
  * lookBehind (ExtendPath.h:404-447) stops a path with AMBI_IN at an
    ambiguous or unexpected predecessor;
  * cycles stop with CYCLE.

Branch look-aheads are rare, so the lock-step loop marks paths NEED_F /
NEED_B and a batched breadth-first search (`branch_depths`) resolves
the stuck minority between device loops.

PyTorch idiom: on a CUDA device the JAX loops are hand-written kernels
(csrc/walk.cu): `fast_extend`'s `lax.while_loop` is one launch that
walks each lane with a group of 8 threads (a step's 8 probes in flight
at once), and `branch_depths`' `lax.scan` one launch that searches from
each root with a warp (a thread per child of up to 8 frontier k-mers at
once); each has a variant for the walk table of a sorted filter, one
for a counting Bloom filter, one for a cascading Bloom filter and one
for a counting filter sharded over a device mesh (`ext.walk_filter`
picks the structure).
On the CPU they are Python loops of tensor ops (`fast_extend_plain`,
`branch_depths_plain`, the versions the kernels are held against).
Testing "any lane still ACTIVE" there is a sync, so the walk loop tests
it after 1, 2, 4, ... up to CHECK_MAX steps; a step leaves non-ACTIVE
lanes untouched, so the extra steps change nothing, and the walk still
stops at exactly `max_steps`.  `fast_extend` and the resolution pass
update the state's tensors in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import u64
from ..core import alphabet
from ..ops import hash_probe as hp
from ..ops import kernels, nthash
from ..ops.bloom import CascadingBloomFilter, CountingBloomFilter
from ..parallel.distributed import ShardedCountingFilter
from ..utils import trace

# path status codes (superset of PathExtensionResultCode, ExtendPath.h:47-57)
ACTIVE = 0
DEAD_END = 1
AMBI_IN = 2
AMBI_OUT = 3
CYCLE = 4
CHUNK_LIMIT = 5
NEED_B = 6  # >=2 raw predecessors: needs behind-branch resolution
NEED_F = 7  # >=2 raw successors: needs forward-branch resolution

STATUS_NAMES = {
    ACTIVE: "ACTIVE", DEAD_END: "DEAD_END", AMBI_IN: "AMBI_IN",
    AMBI_OUT: "AMBI_OUT", CYCLE: "CYCLE", CHUNK_LIMIT: "CHUNK_LIMIT",
    NEED_B: "NEED_B", NEED_F: "NEED_F",
}

# most steps fast_extend runs between two tests of its loop condition
CHECK_MAX = 32


def bucket_size(n: int, lo: int = 64) -> int:
    """Round up to a power of two (>= lo); the JAX package's shape
    buckets, kept so both packages pad the same batches."""
    return max(lo, 1 << max(n - 1, 1).bit_length())


def walk_filter(cbf):
    """The solidity structure to probe inside the walk loops: an exact
    open-addressing table of a sorted filter's solid keys, built on the
    filter's device (hp.solid_table; one [C, 8] gather per probe), else
    the filter itself (a counting Bloom filter probes its own
    counters)."""
    if hasattr(cbf, "kmers") and hasattr(cbf, "threshold"):
        return hp.ProbeSet(hp.solid_table(cbf))
    return cbf


def doubling_schedule(trim: int) -> list[int]:
    """successor()'s branch-depth schedule: 0, 1, 2, 4, ... trim
    (ExtendPath.h:355 `i = (i == 0) ? 1 : min(trim, 2*i)`)."""
    sched = [0]
    i = 0
    while i < trim:
        i = 1 if i == 0 else min(trim, 2 * i)
        sched.append(i)
    return sched


class ExtendState(NamedTuple):
    """Device state for a batch of paths being extended FORWARD."""

    buf: torch.Tensor         # uint8[P, BUF]; bases [0, length) valid
    length: torch.Tensor      # int64[P] current path length in bases
    f: torch.Tensor           # int64[P] forward hash of head k-mer
    r: torch.Tensor           # int64[P] reverse hash of head k-mer
    status: torch.Tensor      # int8[P]
    seed_canon: torch.Tensor  # int64[P] canonical hash of the seed
    has_prev: torch.Tensor    # bool[P] whether buf[length-k-1] is meaningful


def init_state(seed_codes: np.ndarray, buf_len: int, k: int, device,
               prev_base: np.ndarray | None = None,
               seed_canon: torch.Tensor | None = None) -> ExtendState:
    """Build extension state from [P, k] seed k-mers (+ optional previous
    base for warm restarts of chunked extensions).  With a previous
    base, the seed occupies buf[1:k+1] and the behind check is armed
    from the first step."""
    P, kk = seed_codes.shape
    if kk != k:
        raise ValueError(f"seed width {kk} != k={k}")
    warm = prev_base is not None
    off = 1 if warm else 0
    buf = np.full((P, buf_len), alphabet.BAD, np.uint8)
    if warm:
        buf[:, 0] = prev_base
    buf[:, off:off + k] = seed_codes
    f, r = nthash.hash_base(
        torch.from_numpy(np.ascontiguousarray(seed_codes, np.uint8)).to(
            device), k)
    if seed_canon is None:
        seed_canon = u64.umin(f, r)
    return ExtendState(
        buf=torch.from_numpy(buf).to(device),
        length=torch.full((P,), k + off, dtype=torch.int64, device=device),
        f=f, r=r,
        status=torch.zeros(P, dtype=torch.int8, device=device),
        seed_canon=seed_canon,
        has_prev=torch.full((P,), warm, dtype=torch.bool, device=device),
    )


def _candidate_hashes(st: ExtendState, k: int):
    """Hashes of the 4 forward and 4 backward neighbours of each head:
    (fc, rc) int64[P, 4] forward candidates, (fb, rb) predecessors."""
    P = st.length.shape[0]
    rows = torch.arange(P, device=st.buf.device)
    c_out_f = st.buf[rows, st.length - k]   # base leaving
    c_out_b = st.buf[rows, st.length - 1]   # head last base
    bases = torch.arange(4, device=st.buf.device)
    fc, rc = nthash.roll_right(st.f[:, None], st.r[:, None], k,
                               c_out_f[:, None], bases[None, :])
    fb, rb = nthash.roll_left(st.f[:, None], st.r[:, None], k,
                              c_out_b[:, None], bases[None, :])
    return fc, rc, fb, rb


def _step(cbf, st: ExtendState, k: int, rows: torch.Tensor) -> ExtendState:
    """One lock-step extension (extendPathBySingleVertex,
    ExtendPath.h:404-461): behind check first (AMBI_IN), then forward
    successor; paths with >= 2 raw branches stop NEED_B / NEED_F."""
    BUF = st.buf.shape[1]
    active = st.status == ACTIVE
    fc, rc, fb, rb = _candidate_hashes(st, k)
    both = torch.cat([u64.umin(fc, rc), u64.umin(fb, rb)], dim=1)  # [P, 8]
    solid = cbf.contains(both)
    solid_f = solid[:, :4]
    n_fwd = solid_f.sum(dim=1)
    n_back = solid[:, 4:].sum(dim=1)

    need_b = st.has_prev & (n_back >= 2)
    dead = n_fwd == 0
    need_f = n_fwd >= 2

    # first solid base (argmax over bool returns the first maximum)
    base = torch.argmax(solid_f.to(torch.uint8), dim=1)
    new_f = fc.gather(1, base[:, None])[:, 0]
    new_r = rc.gather(1, base[:, None])[:, 0]
    cycle = u64.umin(new_f, new_r) == st.seed_canon
    room = st.length < BUF

    advance = active & ~need_b & ~dead & ~need_f & ~cycle & room
    new_status = torch.where(
        active,
        torch.where(need_b, NEED_B,
                    torch.where(dead, DEAD_END,
                                torch.where(need_f, NEED_F,
                                            torch.where(cycle, CYCLE,
                                                        torch.where(
                                                            room, ACTIVE,
                                                            CHUNK_LIMIT))))),
        st.status).to(torch.int8)

    # masked write: lanes that do not advance rewrite their own byte
    # (the JAX package drops them with an out-of-range index)
    col = torch.clamp(st.length, max=BUF - 1)
    cur = st.buf[rows, col]
    st.buf[rows, col] = torch.where(advance, base.to(torch.uint8), cur)
    return st._replace(
        length=torch.where(advance, st.length + 1, st.length),
        f=torch.where(advance, new_f, st.f),
        r=torch.where(advance, new_r, st.r),
        status=new_status,
        has_prev=st.has_prev | advance,
    )


def fast_extend(cbf, st: ExtendState, k: int,
                max_steps: int) -> ExtendState:
    """Advance all unambiguous paths up to max_steps bases.

    On a CUDA device this is one launch of the walk kernel
    (csrc/walk.cu, a group of 8 threads per lane, one per candidate of a
    step, updating the state in place; the walk filter must be
    ext.walk_filter's ProbeSet, a CountingBloomFilter, a
    CascadingBloomFilter or a ShardedCountingFilter).  On the CPU it is
    the plain loop of `_step`, run until no lane is ACTIVE or max_steps
    steps have run; the condition is tested after 1, 2, 4, ... CHECK_MAX
    steps (extra steps are no-ops on non-ACTIVE lanes).  Both update
    st.buf in place.

    With tracing on it counts `walk.lanes` (lanes launched),
    `walk.lane_steps` (the lanes' advances, plus the step that stopped
    each lane that was ACTIVE when the step began) and `walk.bases`
    (bases written)."""
    counting = trace.enabled()
    if counting:
        length0, active0 = st.length.clone(), st.status == ACTIVE
    if st.buf.is_cuda:
        kernels.walk(_kernel_solid("fast_extend", cbf), st.buf, st.length,
                     st.f, st.r, st.status, st.seed_canon, st.has_prev, k,
                     max_steps)
    else:
        st = fast_extend_plain(cbf, st, k, max_steps)
    if counting:
        _count_walk(st, length0, active0)
    return st


def _count_walk(st: ExtendState, length0: torch.Tensor,
                active0: torch.Tensor) -> None:
    """The walk counters of one launch from the lanes' state before it."""
    bases = int((st.length - length0).sum())
    stopped = int((active0 & (st.status != ACTIVE)).sum())
    trace.count("walk.lanes", st.buf.shape[0])
    trace.count("walk.lane_steps", bases + stopped)
    trace.count("walk.bases", bases)


def _kernel_solid(fn: str, cbf):
    """What the walk kernels probe for walk filter `cbf`: a ProbeSet's
    table, a CountingBloomFilter, a CascadingBloomFilter or a
    ShardedCountingFilter; raises for anything else."""
    if isinstance(cbf, hp.ProbeSet):
        return cbf.tab
    if isinstance(cbf, (CountingBloomFilter, CascadingBloomFilter,
                        ShardedCountingFilter)):
        return cbf
    raise TypeError(f"{fn} on a CUDA device probes a ProbeSet "
                    "(ext.walk_filter), a CountingBloomFilter, a "
                    "CascadingBloomFilter or a ShardedCountingFilter, got "
                    f"{type(cbf).__name__}")


def fast_extend_plain(cbf, st: ExtendState, k: int,
                      max_steps: int) -> ExtendState:
    """fast_extend as a loop of tensor ops on any device: the CPU path,
    and the version the walk kernel is held against on the card."""
    rows = torch.arange(st.buf.shape[0], device=st.buf.device)
    n = 0
    burst = 1
    while n < max_steps:
        m = min(burst, max_steps - n)
        for _ in range(m):
            st = _step(cbf, st, k, rows)
        n += m
        burst = min(2 * burst, CHECK_MAX)
        if not bool((st.status == ACTIVE).any()):
            break
    return st


def branch_depths(cbf, root_codes: torch.Tensor, root_hashes, k: int,
                  max_depth: int, width: int) -> torch.Tensor:
    """Max reachable FORWARD depth from each root k-mer, capped at
    max_depth: a batched BFS with a width-capped frontier, the
    vectorized analogue of lookAhead/trueBranch's DFS
    (ExtendPath.h:96-160).  Roots whose k-mer is not itself solid still
    report depth 0.

    root_codes: uint8[N, k]; root_hashes: (f, r) int64[N].
    Returns int32[N].  On a CUDA device this is one launch of the branch
    kernel (csrc/walk.cu, a warp per root, a thread per child of up to
    8 frontier k-mers at once; the walk filter must be ext.walk_filter's
    ProbeSet, a CountingBloomFilter, a CascadingBloomFilter or a
    ShardedCountingFilter); on the
    CPU, branch_depths_plain."""
    f0, r0 = root_hashes
    if f0.is_cuda:
        return kernels.branch(_kernel_solid("branch_depths", cbf),
                              root_codes.contiguous(),
                              f0.contiguous(), r0.contiguous(), k,
                              max_depth, width)
    return branch_depths_plain(cbf, root_codes, root_hashes, k, max_depth,
                               width)


def branch_depths_plain(cbf, root_codes: torch.Tensor, root_hashes, k: int,
                        max_depth: int, width: int) -> torch.Tensor:
    """branch_depths as a loop of tensor ops on any device: the CPU
    path, and the version the branch kernel is held against on the
    card."""
    f0, r0 = root_hashes
    N = f0.shape[0]
    W = width
    dev = f0.device
    codes = root_codes[:, None, :].expand(N, W, k)
    f = f0[:, None].expand(N, W)
    r = r0[:, None].expand(N, W)
    alive = torch.zeros((N, W), dtype=torch.bool, device=dev)
    alive[:, 0] = True
    depth = torch.zeros(N, dtype=torch.int32, device=dev)
    bases = torch.arange(4, device=dev)
    appended = torch.arange(4, dtype=torch.uint8, device=dev)[
        None, None, :, None].expand(N, W, 4, 1)
    for _ in range(max_depth):
        fc, rc = nthash.roll_right(f[..., None], r[..., None], k,
                                   codes[:, :, 0, None], bases[None, None, :])
        solid = cbf.contains(u64.umin(fc, rc)) & alive[..., None]
        child_f = fc.reshape(N, W * 4)
        child_r = rc.reshape(N, W * 4)
        child_alive = solid.reshape(N, W * 4)
        child_codes = torch.cat(
            [codes[:, :, None, 1:].expand(N, W, 4, k - 1), appended],
            dim=-1).reshape(N, W * 4, k)
        # compact: take up to W live children, in stable order
        order = torch.argsort((~child_alive).to(torch.uint8), dim=1,
                              stable=True)[:, :W]
        codes = child_codes.gather(1, order[..., None].expand(N, W, k))
        f = child_f.gather(1, order)
        r = child_r.gather(1, order)
        alive = child_alive.gather(1, order)
        depth = depth + alive.any(dim=1).to(torch.int32)
    return depth


def successor_decision(depths: np.ndarray, present: np.ndarray, trim: int,
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized successor() doubling-schedule decision (host side).

    Args:
      depths: int[N, 4] branch depth per base (only meaningful where present).
      present: bool[N, 4] branch exists in the filter.
      trim: trim length.

    Returns:
      (code, base): code int[N] in {DEAD_END, ACTIVE, AMBI_OUT} where
      ACTIVE means a unique branch won; base int[N] the winning base.
    """
    N = depths.shape[0]
    d = np.where(present, depths, -1)
    code = np.full(N, AMBI_OUT, np.int8)
    base = np.zeros(N, np.int64)
    decided = np.zeros(N, bool)
    for i in doubling_schedule(trim):
        cnt = (d >= i).sum(axis=1)
        is_dead = ~decided & (cnt == 0)
        code[is_dead] = DEAD_END
        decided |= is_dead
        is_one = ~decided & (cnt == 1)
        base[is_one] = np.argmax(d[is_one] >= i, axis=1)
        code[is_one] = ACTIVE
        decided |= is_one
    return code, base


class _StuckView(NamedTuple):
    idx: np.ndarray          # indices of stuck paths in the batch
    head: np.ndarray         # uint8[M, k] head k-mer codes
    prev_base: np.ndarray    # int[M] expected predecessor base (buf[len-k-1])


def _stuck_heads(buf: torch.Tensor, k: int, length: torch.Tensor):
    """Each path's trailing k-mer and the base before it (0 where there
    is none), gathered on the device; indices clamped into the buffer
    as JAX's gathers clamp them."""
    BUF = buf.shape[1]
    start = torch.clamp(length - k, min=0)
    idx = torch.clamp(start[:, None] + torch.arange(k, device=buf.device),
                      0, BUF - 1)
    head = buf.gather(1, idx)
    prev_idx = length - k - 1
    prev_val = buf.gather(1, torch.clamp(prev_idx, 0, BUF - 1)[:, None])[:, 0]
    prev = torch.where(prev_idx >= 0, prev_val, 0)
    return head, prev


def _gather_stuck(which: int, heads_np, prev_np, status_np) -> _StuckView:
    idx = np.nonzero(status_np == which)[0]
    return _StuckView(idx, heads_np[idx], prev_np[idx].astype(np.int64))


def _branch_info(cbf, roots: np.ndarray, k: int, trim: int, width: int,
                 M: int, return_hashes: bool = False):
    """Presence + look-ahead depth for [M*4, k] branch-root k-mers,
    padded to a power-of-two batch like the JAX package."""
    N = roots.shape[0]
    NP_ = bucket_size(N)
    padded = np.zeros((NP_, k), np.uint8)
    padded[:N] = roots
    codes = torch.from_numpy(padded).to(cbf.device)
    rf, rr = nthash.hash_base(codes, k)
    present = cbf.contains(u64.umin(rf, rr))[:N].cpu().numpy().reshape(M, 4)
    depths = branch_depths(cbf, codes, (rf, rr), k, trim, width)[:N]
    depths = depths.cpu().numpy().reshape(M, 4)
    if return_hashes:
        rfm = u64.to_numpy(rf[:N]).reshape(M, 4)
        rrm = u64.to_numpy(rr[:N]).reshape(M, 4)
        return present, depths, (rfm, rrm)
    return present, depths


def _apply_resolution(st: ExtendState, status_np: np.ndarray,
                      idx: np.ndarray, base: np.ndarray, nf: np.ndarray,
                      nr: np.ndarray) -> ExtendState:
    """Apply the forward-resolution advances in place: lane idx[j]
    appends base[j] at its current length, takes hashes (nf, nr)[j],
    and the new statuses replace the old."""
    dev = st.buf.device
    if len(idx):
        i = torch.from_numpy(idx).to(dev)
        wpos = st.length[i]
        st.buf[i, wpos] = torch.from_numpy(base).to(dev)
        st.length[i] += 1
        st.f[i] = u64.from_numpy(nf, dev)
        st.r[i] = u64.from_numpy(nr, dev)
    return st._replace(status=torch.from_numpy(status_np).to(dev))


def _resolve(cbf, st: ExtendState, k: int, trim: int,
             width: int) -> ExtendState:
    """Resolve NEED_B / NEED_F paths with batched branch look-aheads.

    Behind-ambiguous paths stop AMBI_IN; forward forks either pick a
    unique true branch (the path advances one base and reactivates),
    die (DEAD_END), or stop AMBI_OUT.  Only the [P, k] head windows and
    small per-lane arrays cross to the host."""
    status = st.status.cpu().numpy().copy()
    length = st.length.cpu().numpy()
    heads_d, prev_d = _stuck_heads(st.buf, k, st.length)
    heads_np = heads_d.cpu().numpy()
    prev_np = prev_d.cpu().numpy()

    # ---- behind resolution ---------------------------------------------
    sb = _gather_stuck(NEED_B, heads_np, prev_np, status)
    if len(sb.idx):
        # predecessor candidates: base c + head[:-1]; evaluated by REVERSE
        # depth == FORWARD depth of the reverse complement k-mer.
        M = len(sb.idx)
        roots = np.zeros((M * 4, k), np.uint8)
        for c in range(4):
            pred = np.concatenate(
                [np.full((M, 1), c, np.uint8), sb.head[:, :-1]], axis=1)
            roots[c::4] = alphabet.revcomp_codes(pred)
        present, depths = _branch_info(cbf, roots, k, trim, width, M)
        code, base = successor_decision(depths, present, trim)
        ok = (code == ACTIVE) & (base == sb.prev_base)
        status[sb.idx[ok]] = NEED_F          # behind fine; forward still due
        status[sb.idx[~ok]] = AMBI_IN

    # ---- forward resolution --------------------------------------------
    sf = _gather_stuck(NEED_F, heads_np, prev_np, status)
    adv = np.zeros(0, np.int64)
    adv_base = np.zeros(0, np.uint8)
    adv_f = adv_r = np.zeros(0, np.uint64)
    if len(sf.idx):
        M = len(sf.idx)
        roots = np.zeros((M * 4, k), np.uint8)
        for c in range(4):
            roots[c::4] = np.concatenate(
                [sf.head[:, 1:], np.full((M, 1), c, np.uint8)], axis=1)
        present, depths, (rfm, rrm) = _branch_info(
            cbf, roots, k, trim, width, M, return_hashes=True)
        code, base = successor_decision(depths, present, trim)
        seed_canon = u64.to_numpy(st.seed_canon)[sf.idx]
        BUF = st.buf.shape[1]
        rows = np.arange(M)
        nf, nr = rfm[rows, base], rrm[rows, base]
        won = code == ACTIVE
        cyc = won & (np.minimum(nf, nr) == seed_canon)
        full = won & ~cyc & (length[sf.idx] >= BUF)
        go = won & ~cyc & ~full
        status[sf.idx[~won]] = code[~won]
        status[sf.idx[cyc]] = CYCLE
        status[sf.idx[full]] = CHUNK_LIMIT
        status[sf.idx[go]] = ACTIVE
        adv, adv_base = sf.idx[go], base[go].astype(np.uint8)
        adv_f, adv_r = nf[go], nr[go]
    return _apply_resolution(st, status, adv, adv_base, adv_f, adv_r)


def _first_revisit(canon: np.ndarray) -> int:
    """Window index of the first k-mer whose canonical hash was already
    seen at an earlier window; -1 if all distinct (the visited-set cycle
    stop, ExtendPath.h:648-658, independent of the chunk size)."""
    L = len(canon)
    if L < 2:
        return -1
    order = np.argsort(canon, kind="stable")
    s = canon[order]
    dup = s[1:] == s[:-1]
    if not dup.any():
        return -1
    return int(order[1:][dup].min())


def _inert_pad(st: ExtendState, n_real: int) -> ExtendState:
    """Mark pad rows [n_real:] DEAD_END so they never move."""
    if st.status.shape[0] > n_real:
        st.status[n_real:] = DEAD_END
    return st


def extend_forward(cbf, seed_codes: np.ndarray, k: int, trim: int,
                   width: int = 16, chunk: int = 512,
                   max_len: int = 1 << 22, prev_base=None,
                   chunk_max: int = 1 << 15,
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extend [P, k] seeds FORWARD to their unitig ends, on cbf's device.

    The per-call step budget doubles at every warm restart (chunk ->
    chunk_max), and warm restarts compact to the lanes still going.

    Returns (bufs uint8[P, L*], lengths int64[P], status int8[P]) where
    status is one of DEAD_END / AMBI_IN / AMBI_OUT / CYCLE / CHUNK_LIMIT.
    """
    dev = cbf.device
    P0 = seed_codes.shape[0]
    P = bucket_size(P0, lo=8)
    seeds_p = np.zeros((P, k), np.uint8)
    seeds_p[:P0] = seed_codes
    prev_p = None
    if prev_base is not None:
        prev_p = np.zeros(P, np.uint8)
        prev_p[:P0] = prev_base
    warm0 = prev_base is not None
    st = _inert_pad(init_state(seeds_p, k + (1 if warm0 else 0) + chunk, k,
                               dev, prev_base=prev_p), P0)
    out_bufs = None
    cur_chunk = chunk
    # lane_map[j] = output row of state row j; pad rows map to -1
    lane_map = np.full(P, -1, np.int64)
    lane_map[:P0] = np.arange(P0)
    while True:
        st = fast_extend(cbf, st, k, cur_chunk)
        status = st.status.cpu().numpy()
        if ((status == NEED_B) | (status == NEED_F)).any():
            with trace.span("walk.resolve", device=True):
                st = _resolve(cbf, st, k, trim, width)
                status = st.status.cpu().numpy()
        if (status == ACTIVE).any():
            continue
        # all terminal for this chunk: stitch into the running contigs,
        # cut cycles across chunks and restart the lanes still going
        with trace.span("walk.stitch", device=True):
            buf = st.buf.cpu().numpy()
            length = st.length.cpu().numpy()
            if out_bufs is None:
                out_bufs, out_len, out_status = (
                    buf[:P0].copy(), length[:P0].copy(), status[:P0].copy())
            else:
                # continuation chunks start with [prev_base + seed]
                skip = k + 1
                grow = buf.shape[1] - skip
                new = np.full((P0, out_bufs.shape[1] + grow), alphabet.BAD,
                              np.uint8)
                new[:, :out_bufs.shape[1]] = out_bufs
                for j in range(buf.shape[0]):
                    i = lane_map[j]
                    if i < 0 or out_status[i] != CHUNK_LIMIT:
                        continue
                    n_ext = length[j] - skip  # bases beyond warm seed
                    if n_ext > 0:
                        new[i, out_len[i]:out_len[i] + n_ext] = \
                            buf[j, skip:length[j]]
                        out_len[i] += n_ext
                    out_status[i] = status[j]
                out_bufs = new
            # exact cross-chunk cycle detection on paths still going: one
            # joined hash call, truncating each at its first revisited
            # vertex
            going = np.nonzero(out_status == CHUNK_LIMIT)[0]
            if len(going):
                sep = np.full(1, alphabet.BAD, np.uint8)
                joined = np.concatenate(
                    [x for i in going
                     for x in (out_bufs[i, :out_len[i]], sep)])
                _, _, canon, _ = nthash.kmer_hashes_padded(joined, k, dev)
                canon = u64.to_numpy(canon)
                pos = 0
                for i in going:
                    L = int(out_len[i])
                    r = _first_revisit(canon[pos:pos + L - k + 1])
                    if r >= 0:
                        out_status[i] = CYCLE
                        out_len[i] = r + k - 1
                    pos += L + 1
            if not (out_status == CHUNK_LIMIT).any() or \
                    out_bufs.shape[1] >= max_len:
                break
            # warm restart for the surviving lanes only, doubled budget
            cur_chunk = min(cur_chunk * 2, chunk_max)
            cont = np.nonzero(out_status == CHUNK_LIMIT)[0]
            Pc = bucket_size(len(cont), lo=8)
            lane_map = np.full(Pc, -1, np.int64)
            lane_map[:len(cont)] = cont
            seeds = np.zeros((Pc, k), np.uint8)
            prevb = np.zeros(Pc, np.uint8)
            for j, i in enumerate(cont):
                L = out_len[i]
                seeds[j] = out_bufs[i, L - k:L]
                prevb[j] = out_bufs[i, L - k - 1] if L > k else 0
            st = _inert_pad(init_state(seeds, k + 1 + cur_chunk, k, dev,
                                       prev_base=prevb), len(cont))
    return out_bufs, out_len, out_status


def lookahead_ok(cbf, root_codes, k: int, depth: int,
                 width: int = 8) -> np.ndarray:
    """True where a path of `depth` steps extends FORWARD from the root
    (lookAhead, ExtendPath.h:146-161)."""
    root_codes = np.asarray(root_codes, np.uint8)
    N = root_codes.shape[0]
    NP_ = bucket_size(N)
    padded = np.zeros((NP_, k), np.uint8)
    padded[:N] = root_codes
    codes = torch.from_numpy(padded).to(cbf.device)
    rf, rr = nthash.hash_base(codes, k)
    d = branch_depths(cbf, codes, (rf, rr), k, depth, width)
    return d[:N].cpu().numpy() >= depth
