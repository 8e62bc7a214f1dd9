"""Mesh-sharded sorted k-mer table: the distributed exact engine.

Port of abyss_tpu/parallel/sharded_table.py.  The reference's MPI
engine owns each k-mer on rank `Kmer::getCode() % numProc` and routes
every vertex operation to its owner with buffered async messages
(Parallel/NetworkSequenceCollection.cpp:1456-1507; phases :457-664).
Here, as in the JAX package, one program runs over the mesh's table
axis ("data", or ("host", "data") host-major, parallel/mesh.py):

  * ownership  owner(key) = mix64(key) >> (64 - log2 D), a bit mix so
               shards stay balanced for 2-bit-packed keys;
  * routing    bucket by owner + `all_to_all` with a fixed capacity per
               destination; an overflow is detected and retried with a
               larger capacity (the reference's growable sends,
               Parallel/MessageBuffer.h:20-80);
  * phases     every phase runs with the table resident in per-device
               shards: count -> kc -> adjacency -> erode -> trim ->
               low-coverage loop -> bubbles -> emission.  Remote reads
               are dedup-routed gathers (RoutedGather), per-chain stats
               reduce to each chain head's owner (RoutedReduce), and
               emission scatters (position, base) pairs into a
               position-sharded buffer, so the host receives per-chain
               metadata and contig bases only (parallelAbyss.cpp:29-68);
  * reductions `psum` over the table axis.

Packed mode (k <= 32) keys shards on one 64-bit word; wide mode keys on
canonical ntHash fingerprints with routed hr/text side arrays.  Keys and
hashes are int64 words with the JAX package's uint64 bits (u64.py):
every sort, search, compare and right shift on them is unsigned.

Each per-shard program is a loop over the mesh's devices, its tensors
on the shard's device, so each launch inside it happens once per
shard.  On a CUDA mesh the ntHash kernel runs in the wide load
(`_hash_windows` at k > 32) and in the wide side-array fill; the rest
is PyTorch tensor code, as the JAX package's is jnp.  JAX's clamped
out-of-range gathers are clamped before the gather; its dropped
out-of-bounds scatters write a sink slot or are masked; where its
`.at[].set` meets duplicate indices the port writes with
hash_probe.set_last (the highest update wins, as XLA's CPU scatter).

One departure that changes no value: emission routes only the records
that carry a base, and sizes its buckets by them, where the JAX
package routes the whole [k, 2S] grid of candidates (almost all of
them empty) with buckets sized by the grid.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import u64
from ..dbg.hash_dbg import COVERAGE_MAX, pack_kmers
from ..ops import nthash
from ..ops.hash_probe import set_last
from ..ops.scan import running_max, running_min
from ..utils import trace
from .mesh import Mesh, all_to_all

SENTINEL = u64.ALL_ONES
_BIG = 1 << 62


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer: uniform owner bits from packed keys."""
    x = (x ^ u64.srl(x, 30)) * u64.s64(0xBF58476D1CE4E5B9)
    x = (x ^ u64.srl(x, 27)) * u64.s64(0x94D049BB133111EB)
    return x ^ u64.srl(x, 31)


def _owner(keys: torch.Tensor, log2_d: int) -> torch.Tensor:
    if log2_d == 0:
        return torch.zeros(keys.shape, dtype=torch.int64,
                           device=keys.device)
    return u64.srl(_mix64(keys), 64 - log2_d)


def table_axes(mesh: Mesh):
    """Mesh axes the table shards over: ("host", "data") on a host
    mesh (the owner id's top bits select the host), else "data"."""
    return ("host", "data") if "host" in mesh.axis_names else "data"


def mesh_size(mesh: Mesh) -> int:
    n = mesh.shape["data"]
    if "host" in mesh.axis_names:
        n *= mesh.shape["host"]
    return n


def _each(mesh: Mesh, fn, *args):
    """fn(i, *(a[i] for a in args)) on every device i of the mesh: a
    per-shard program.  A tuple result comes back as a tuple of lists."""
    outs = [fn(i, *(a[i] for a in args)) for i in range(mesh.size)]
    if outs and isinstance(outs[0], tuple):
        return tuple(list(x) for x in zip(*outs))
    return outs


def _total(mesh: Mesh, xs: list) -> int:
    """psum of per-device scalars, read on the host."""
    dev = mesh.flat[0]
    return int(sum(x.to(dev) for x in xs).item()) if xs else 0


def _bucketize(dest, valid, payloads: tuple, capacity: int, n_dev: int,
               fill: tuple):
    """Scatter items into [n_dev, capacity] per-destination buckets.
    Returns (bufs, overflow_count, order, row, col, ok); the latter
    four let the caller un-route replies.  Masked and overflowing items
    go to a sink row that is cut off."""
    n = dest.shape[0]
    dev = dest.device
    d = torch.where(valid, dest, n_dev)  # invalid sorts last
    order = torch.argsort(d, stable=True)
    sd = d[order]
    first = torch.searchsorted(
        sd.contiguous(), torch.arange(n_dev + 1, dtype=sd.dtype, device=dev))
    idx_in = torch.arange(n, device=dev) - first[sd.clamp(max=n_dev)]
    real = sd < n_dev
    ok = real & (idx_in < capacity)
    overflow = (real & (idx_in >= capacity)).sum()
    row = torch.where(ok, sd, n_dev)
    col = torch.where(ok, idx_in, capacity)
    bufs = []
    for pay, fl in zip(payloads, fill):
        buf = torch.full((n_dev + 1, capacity + 1), fl, dtype=pay.dtype,
                         device=dev)
        buf[row, col] = pay[order]
        bufs.append(buf[:n_dev, :capacity])
    return bufs, overflow, order, row, col, ok


def _unbucketize(reply, order, row, col, ok, n, fill):
    """Inverse of _bucketize for the reply direction: reply[row, col]
    back to the items' original positions."""
    n_dev, cap = reply.shape
    fill = torch.tensor(fill, dtype=reply.dtype, device=reply.device)
    vals = torch.where(ok, reply[row.clamp(max=n_dev - 1),
                                 col.clamp(max=cap - 1)], fill)
    out = fill.expand(n).clone()
    out[order] = vals
    return out


@dataclass
class ShardedKmerTable:
    """keys/counts/alive sharded [D][S] over the table axis (a list of
    per-device tensors); row r on device d has global id d * S + r.

    Wide mode (k > 32): keys are canonical ntHash fingerprints and two
    side arrays ride along: `hr` (the non-canonical hash) and `text`
    (the stored-orientation bases, 32 to a 64-bit word, base 0 in the
    top bits)."""
    mesh: Mesh
    k: int
    keys: list        # int64[S] per device, sorted unsigned, SENTINEL pad
    counts: list      # int32[S]
    alive: list       # bool[S]
    nbr: list | None = None          # int64[S, 8] global ids, -1
    nbr_strand: list | None = None   # int8[S, 8]
    hr: list | None = None           # int64[S] (wide mode)
    text: list | None = None         # int64[S, W] (wide mode)
    fwd_counts: list | None = None   # int32[S] per-strand multiplicity

    @property
    def wide(self) -> bool:
        return self.text is not None

    @property
    def n_dev(self) -> int:
        return mesh_size(self.mesh)

    @property
    def shard_size(self) -> int:
        return self.keys[0].shape[0]

    def host_table(self):
        """Merge the shards to a host KmerTable (keys re-sorted
        globally), its device programs on the mesh's first device."""
        from ..dbg.hash_dbg import KmerTable

        def cat(xs, fn=lambda t: t.cpu().numpy()):
            return np.concatenate([fn(x) for x in xs])

        keys = cat(self.keys, u64.to_numpy)
        counts = cat(self.counts)
        alive = cat(self.alive)
        real = keys != np.uint64(0xFFFFFFFFFFFFFFFF)
        keys, counts, alive = keys[real], counts[real], alive[real]
        order = np.argsort(keys)
        hr = text = fwd = None
        if self.wide:
            # device words (32 bases a word, base 0 in the top bits) ->
            # the host layout uint8[N, ceil(k/4)] (4 bases a byte)
            hr = cat(self.hr, u64.to_numpy)[real][order]
            tw = cat(self.text, u64.to_numpy)[real][order]
            text = tw.astype(">u8").view(np.uint8).reshape(len(tw), -1)
            text = np.ascontiguousarray(text[:, : (self.k + 3) // 4])
        if self.fwd_counts is not None:
            fwd = cat(self.fwd_counts)[real][order]
        return KmerTable(self.k, keys[order], counts[order], alive[order],
                         hr=hr, text=text, fwd_counts=fwd,
                         device=str(self.mesh.flat[0]))


def _hash_windows(codes: torch.Tensor, k: int):
    """(canon, hr, is_fwd, valid) per window: packed words for k <= 32,
    ntHash fingerprints and the non-canonical hash for wide k.  is_fwd
    marks windows whose forward form is the canonical form."""
    if k <= 32:
        fwd, rc, canon, valid = pack_kmers(codes, k)
        return canon, _umax(fwd, rc), fwd == canon, valid
    fh, rh, canon, valid = nthash.kmer_hashes(codes, k)
    return canon, _umax(fh, rh), fh == canon, valid


def _umax(a, b):
    return torch.where(u64.ult(a, b), b, a)


def _sort_rle_strand(canon: torch.Tensor, bit: torch.Tensor):
    """Sorted distinct keys with (total, forward-strand) counts at each
    run start (SENTINEL and 0 elsewhere).  A run's totals do not depend
    on the order of its members, so one unsigned key sort does."""
    n = canon.shape[0]
    dev = canon.device
    ks, order = u64.usort(canon)
    bs = bit.to(torch.int32)[order]
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    kstart = torch.cat([one, ks[1:] != ks[:-1]])
    klast = torch.cat([ks[:-1] != ks[1:], one])
    end_pos = running_min(torch.where(klast, pos, n), reverse=True)
    total = torch.where(kstart, end_pos - pos + 1, 0)
    cs = torch.cumsum(bs, dim=0, dtype=torch.int32)
    fwd = torch.where(kstart, cs[end_pos.clamp(0, n - 1).long()] - cs + bs,
                      0)
    keys = torch.where(kstart, ks, SENTINEL)
    return keys, total, fwd


def _run_starts(x: torch.Tensor) -> torch.Tensor:
    """bool mask of the first element of each run of equal values of a
    1-D tensor (empty for an empty one)."""
    start = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    start[1:] = x[1:] != x[:-1]
    return start


def _run_totals(ks: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per element of a sorted key array: the sum of vals over its run."""
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=ks.device),
                       ks[1:] != ks[:-1]])
    rid = torch.cumsum(start, dim=0) - 1
    tot = torch.zeros(ks.shape[0], dtype=vals.dtype, device=ks.device)
    tot.index_add_(0, rid, vals)
    return tot[rid]


def build_sharded_table(mesh: Mesh, batches, k: int,
                        chunk_cap_slack: float = 2.0) -> ShardedKmerTable:
    """Distributed load phase: each device reduces its slice of every
    batch, routes (key, count) pairs to their owners, owners merge; the
    table never leaves the mesh (NAS_LOADING,
    NetworkSequenceCollection.cpp:1423-1434).  A batch whose buckets
    overflow is routed again with doubled slack.  Wide k routes
    canonical ntHash fingerprints, then fills the hr/text side arrays
    with a second routed pass (_fill_wide_sharded)."""
    ax = table_axes(mesh)
    n_dev = mesh_size(mesh)
    log2_d = int(n_dev - 1).bit_length()
    if (1 << log2_d) != n_dev:
        raise ValueError("device count must be a power of two")

    def route(codes, cap):
        canon, _, is_fwd, valid = _hash_windows(codes, k)
        flat = torch.where(valid, canon, SENTINEL).reshape(-1)
        keys, counts, fwds = _sort_rle_strand(
            flat, (is_fwd & valid).reshape(-1))
        good = (counts > 0) & (keys != SENTINEL)
        (kb, cb, fb), ov, *_ = _bucketize(
            _owner(keys, log2_d), good,
            (keys, counts.to(torch.int32), fwds.to(torch.int32)),
            cap, n_dev, (SENTINEL, 0, 0))
        return kb, cb, fb, ov

    chunks = [[] for _ in range(n_dev)]
    saved_batches = []
    for codes in batches:
        codes = np.asarray(codes, np.uint8)
        B, L = codes.shape
        pad = (-B) % n_dev
        if pad:
            codes = np.concatenate([codes, np.full((pad, L), 4, np.uint8)])
        per = codes.shape[0] // n_dev
        n_items = per * max(L - k + 1, 1)
        host = torch.from_numpy(codes)
        sharded = [host[i * per:(i + 1) * per].to(dev)
                   for i, dev in enumerate(mesh.flat)]
        slack = chunk_cap_slack
        while True:
            cap = max(64, int(slack * n_items / n_dev))
            kb, cb, fb, ov = _each(mesh, lambda i, c: route(c, cap),
                                   sharded)
            if not _total(mesh, ov):
                break
            slack *= 2
            if slack > max(64.0, 4.0 * n_dev):
                raise RuntimeError(
                    f"routing bucket overflow at slack {slack / 2}")
        received = [all_to_all(mesh, b, ax) for b in (kb, cb, fb)]
        for i in range(n_dev):
            chunks[i].append(tuple(r[i].reshape(-1) for r in received))
        if k > 32:
            saved_batches.append(sharded)

    def finalize(i, parts):
        keys = torch.cat([p[0] for p in parts])
        ks, order = u64.usort(keys)
        cs = torch.cat([p[1] for p in parts])[order].to(torch.int64)
        fs = torch.cat([p[2] for p in parts])[order].to(torch.int64)
        totals = _run_totals(ks, cs)
        ftotals = _run_totals(ks, fs)
        start = torch.cat([torch.ones(1, dtype=torch.bool, device=ks.device),
                           ks[1:] != ks[:-1]])
        keep = start & (ks != SENTINEL)
        outk = torch.where(keep, ks, SENTINEL)
        outc = torch.where(keep, totals.clamp(max=COVERAGE_MAX), 0)
        outf = torch.where(keep, ftotals.clamp(max=COVERAGE_MAX), 0)
        # dup and sentinel slots to the end, key order kept
        outk, o2 = u64.usort(outk)
        return (outk, outc[o2].to(torch.int32), outf[o2].to(torch.int32),
                keep.sum())

    if not chunks[0]:
        raise ValueError("build_sharded_table: no read batches")
    keys, counts, fwd_counts, n_real = _each(mesh, finalize, chunks)
    S = max(max(int(n.item()) for n in n_real), 1)
    keys = [x[:S] for x in keys]
    counts = [x[:S] for x in counts]
    fwd_counts = [x[:S] for x in fwd_counts]
    alive = [x != SENTINEL for x in keys]
    t = ShardedKmerTable(mesh, k, keys, counts, alive,
                         fwd_counts=fwd_counts)
    if k > 32:
        _fill_wide_sharded(t, saved_batches)
    return t


def _n_words(k: int) -> int:
    return (k + 31) // 32


def _pack_window_words(codes: torch.Tensor, k: int, flip: torch.Tensor):
    """2-bit-pack every k-window of [B, L] codes into stored-orientation
    words [W][B, Wn] (base j in word j // 32, top bits first); flip
    [B, Wn] takes the reverse complement (windows whose reverse hash is
    the canonical form)."""
    L = codes.shape[-1]
    Wn = L - k + 1
    safe = codes.clamp(max=3).long()
    comp = 3 - safe
    words = []
    for w in range(_n_words(k)):
        lo = 32 * w
        hi = min(32 * w + 32, k)
        fw = torch.zeros(codes.shape[:-1] + (Wn,), dtype=torch.int64,
                         device=codes.device)
        rw = torch.zeros_like(fw)
        for j in range(lo, hi):
            fw = (fw << 2) | safe[..., j:j + Wn]
            jj = k - 1 - j   # base j of the rc = comp(base k-1-j)
            rw = (rw << 2) | comp[..., jj:jj + Wn]
        pad = 32 - (hi - lo)
        if pad:
            fw = fw << (2 * pad)
            rw = rw << (2 * pad)
        words.append(torch.where(flip, rw, fw))
    return words


def _fill_wide_sharded(t: ShardedKmerTable, sharded_batches,
                       verify: bool = True) -> None:
    """Fill the wide-mode side arrays (hr and packed text words) with a
    second routed pass over the read batches.  The owner-side write is
    first-wins across batches, and with verify=True every routed
    occurrence's text words are compared with the stored row: a
    fingerprint collision (two texts sharing a canonical 64-bit ntHash)
    excises the merged row on its owner shard, so no wrong bases are
    spliced.  ABYSS_TPU_COLLISION=raise makes it fatal."""
    mesh, k = t.mesh, t.k
    S = t.shard_size
    n_dev = t.n_dev
    log2_d = int(n_dev - 1).bit_length()
    W = _n_words(k)

    def zeros(dtype, *shape):
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for dev in mesh.flat]

    filled = zeros(torch.bool, S)
    hr = zeros(torch.int64, S)
    text = [[torch.zeros(S, dtype=torch.int64, device=dev)
             for _ in range(W)] for dev in mesh.flat]
    coll_mask = zeros(torch.bool, S)
    fills = tuple([SENTINEL, 0] + [0] * W)

    def stage_a(i, codes):
        fh, rh, canon, valid = nthash.kmer_hashes(codes, k)
        words = _pack_window_words(codes, k, u64.ult(rh, fh))
        dest = _owner(canon.reshape(-1), log2_d)
        return (torch.where(valid.reshape(-1), dest, -1), canon.reshape(-1),
                _umax(fh, rh).reshape(-1), *[w.reshape(-1) for w in words])

    def stage_b(i, canon_r, hr_r, words_r):
        keys = t.keys[i]
        idx = u64.usearchsorted(keys, canon_r).clamp(max=S - 1)
        hit = (keys[idx] == canon_r) & (canon_r != SENTINEL)
        # first-wins across batches: filled rows keep their text, so
        # every occurrence verifies against the same winner
        write = hit & ~filled[i][idx]
        set_last(hr[i], idx, hr_r, write)
        for w in range(W):
            set_last(text[i][w], idx, words_r[w], write)
        set_last(filled[i], idx, torch.ones_like(write), write)
        unfilled = (~filled[i] & (keys != SENTINEL)).sum()
        same = hit
        for w in range(W):
            same = same & (text[i][w][idx] == words_r[w])
        bad = hit & ~same
        coll_mask[i][idx[bad]] = True
        return unfilled, bad.sum()

    collisions = 0
    for sharded in sharded_batches:
        dest, canon, hrv, *words = _each(mesh, stage_a, sharded)
        routed = _route_records(mesh, dest, [canon, hrv] + words,
                                [d >= 0 for d in dest], canon[0].shape[0],
                                fills)
        unfilled, coll = _each(
            mesh, lambda i, c, h, *ws: stage_b(i, c, h, ws), *routed)
        if verify:
            collisions += _total(mesh, coll)
        elif _total(mesh, unfilled) == 0:
            break
    if collisions:
        if os.environ.get("ABYSS_TPU_COLLISION") == "raise":
            raise RuntimeError(
                f"wide-mode fingerprint collision detected on the "
                f"mesh: {collisions} occurrence(s) disagree with the "
                f"stored k-mer text at k={t.k}; two distinct k-mers "
                f"share a 64-bit canonical ntHash "
                f"(ABYSS_TPU_COLLISION=raise).")
        n_rows = _total(mesh, [c.sum() for c in coll_mask])
        t.alive = [a & ~c for a, c in zip(t.alive, coll_mask)]
        print(f"[sharded-table] wide-mode fingerprint collision: "
              f"excised {n_rows} merged row(s) on their owner shards "
              f"({collisions} mismatching occurrence(s) at k={t.k})",
              file=sys.stderr, flush=True)
    t.hr = hr
    t.text = [torch.stack(ws, dim=1) for ws in text]


def _rc_packed(x: torch.Tensor, k: int) -> torch.Tensor:
    from ..dbg.chain_ops import _rc_packed as rc
    return rc(x, k)


def build_adjacency_sharded(t: ShardedKmerTable,
                            slack: float = 2.5) -> None:
    """Distributed adjacency: every device computes its rows' 8
    neighbour candidates, routes each to its owner for a membership
    lookup, and stores the replies as global row ids
    (AdjacencyAlgorithm.h:9-46 over NAS_GEN_ADJ routing).  The reply
    also carries whether the neighbour's stored form equals the
    walk-orientation form (`strand`)."""
    mesh, k = t.mesh, t.k
    ax = table_axes(mesh)
    n_dev = t.n_dev
    log2_d = int(n_dev - 1).bit_length()
    S = t.shard_size
    mask = (1 << (2 * k)) - 1 if 2 * k < 64 else SENTINEL
    shift_top = 2 * (min(k, 32) - 1)
    wide = t.wide

    def candidates(i, keys, hrl, textl):
        if wide:
            # candidate fingerprints from O(1) ntHash rolls of the
            # stored (fwd = canonical, rev = hr) state
            firstb = u64.srl(textl[:, 0], 62) & 3
            j = k - 1
            lastb = u64.srl(textl[:, j // 32], 62 - 2 * (j % 32)) & 3
            ys_l, same_l = [], []
            for c in range(4):
                f2, r2 = nthash.roll_right(keys, hrl, k, firstb,
                                           torch.full_like(firstb, c))
                y = u64.umin(f2, r2)
                ys_l.append(y)
                same_l.append(f2 == y)
            for c in range(4):
                f2, r2 = nthash.roll_left(keys, hrl, k, lastb,
                                          torch.full_like(lastb, c))
                y = u64.umin(f2, r2)
                ys_l.append(y)
                same_l.append(f2 == y)
            ycan = torch.stack(ys_l, 1).reshape(-1)
            same = torch.stack(same_l, 1).reshape(-1)
        else:
            cands = [((keys << 2) | c) & mask for c in range(4)]
            cands += [u64.srl(keys, 2) | u64.s64(c << shift_top)
                      for c in range(4)]
            ys = torch.stack(cands, 1).reshape(-1)
            ycan = u64.umin(ys, _rc_packed(ys, k))
            same = ys == ycan
        valid = torch.repeat_interleave(keys != SENTINEL, 8)
        return ycan, same, valid

    hr_in = t.hr if t.hr is not None else t.keys
    text_in = t.text if t.text is not None else \
        [torch.zeros((S, 1), dtype=torch.int64, device=d) for d in mesh.flat]
    ycan, same, valid = _each(mesh, candidates, t.keys, hr_in, text_in)
    while True:
        cap = max(64, int(slack * S * 8 / n_dev))
        routed = _each(mesh, lambda i, y, v: _bucketize(
            _owner(y, log2_d), v, (y,), cap, n_dev, (SENTINEL,)),
            ycan, valid)
        if not _total(mesh, routed[1]):
            break
        slack *= 2
        if slack > max(64.0, 4.0 * n_dev):
            raise RuntimeError("adjacency routing overflow")
    qr = all_to_all(mesh, [b[0] for b in routed[0]], ax)

    def lookup(i, q):
        keys = t.keys[i]
        flatq = q.reshape(-1)
        idx = u64.usearchsorted(keys, flatq).clamp(max=S - 1)
        hit = (keys[idx] == flatq) & (flatq != SENTINEL)
        return torch.where(hit, i * S + idx, -1).reshape(n_dev, cap)

    back = all_to_all(mesh, _each(mesh, lookup, qr), ax)

    def answer(i, rep, sm):
        _, _, order, row, col, ok = (x[i] for x in routed)
        nbr = _unbucketize(rep, order, row, col, ok, S * 8, -1).reshape(S, 8)
        # strand of the target in the walk orientation of each probe:
        # right probes walk in stored orientation, left probes on the rc
        same8 = sm.reshape(S, 8)
        walk_same = torch.cat([same8[:, :4], ~same8[:, 4:]], dim=1)
        return nbr, torch.where(walk_same, 0, 1).to(torch.int8)

    t.nbr, t.nbr_strand = _each(mesh, answer, back, same)


class RoutedGather:
    """values[D][S] gathered at global ids gid[D][Q] (-1: no query,
    answer 0): the SeqDataRequest/Response analogue
    (NetworkSequenceCollection.cpp:1321-1343), with local dedup — each
    device sorts its queries and routes only the distinct ids, then
    fans replies back out — so even queries that converge onto a few
    ids (pointer doubling onto chain heads) stay within hash-uniform
    bucket capacity.  Starts at O(slack * Q / D) per destination and
    quadruples the slack only when a call overflows, remembering the
    slack that worked.

    Unlike the JAX package's, it first drops the -1 queries (whose
    answer is 0 either way) and sizes its buckets by the Q that remain,
    so callers pass -1 for every query whose answer they do not read."""

    MAX_SLACK = 256.0

    def __init__(self, mesh: Mesh, S: int, dtype, slack: float = 2.5):
        self.mesh, self.S, self.dtype = mesh, S, dtype
        self.slack = slack

    def _route(self, gid, cap):
        S, n_dev = self.S, mesh_size(self.mesh)
        Q = gid.shape[0]
        dev = gid.device
        g = torch.where(gid >= 0, gid, _BIG)
        order = torch.argsort(g, stable=True)
        gs = g[order]
        firstq = _run_starts(gs) & (gs < _BIG)
        uniq = torch.where(firstq, gs, _BIG)
        dest = torch.where(firstq, uniq // S, n_dev)
        local = torch.where(firstq, uniq % S, 0)
        (lb,), ov, order2, row, col, ok = _bucketize(
            dest, firstq, (local,), cap, n_dev, (0,))
        return lb, ov, (order, gs, firstq, order2, row, col, ok)

    def __call__(self, values: list, gid: list) -> list:
        mesh = self.mesh
        ax = table_axes(mesh)
        n_dev = mesh_size(mesh)
        S = self.S
        full = [g.shape[0] for g in gid]
        where = [torch.nonzero(g >= 0).reshape(-1) for g in gid]
        gid = [g[w] for g, w in zip(gid, where)]
        Q = max(g.shape[0] for g in gid)
        if Q == 0:
            return [torch.zeros(n, dtype=self.dtype, device=d)
                    for n, d in zip(full, mesh.flat)]
        slack = self.slack
        while True:
            cap = max(64, min(Q, int(slack * Q / n_dev)))
            lb, ov, state = _each(mesh, lambda i, g: self._route(g, cap),
                                  gid)
            if _total(mesh, ov) == 0:
                break
            if slack >= self.MAX_SLACK:
                raise RuntimeError(f"routed gather overflow at slack {slack}")
            slack = min(slack * 4, self.MAX_SLACK)
            self.slack = slack
        lr = all_to_all(mesh, lb, ax)
        vals = _each(mesh, lambda i, v, q: v[q.reshape(-1).clamp(0, S - 1)]
                     .reshape(n_dev, cap), values, lr)
        back = all_to_all(mesh, vals, ax)

        def fan_out(i, rep, st):
            order, gs, firstq, order2, row, col, ok = st
            n = order.shape[0]
            fill = torch.zeros((), dtype=rep.dtype, device=rep.device)
            ansu = _unbucketize(rep, order2, row, col, ok, n, 0)
            pos = torch.arange(n, device=rep.device)
            head = running_max(torch.where(firstq, pos, -1)).clamp(min=0)
            ans_sorted = torch.where(gs < _BIG, ansu[head], fill)
            ans = torch.zeros(full[i], dtype=rep.dtype, device=rep.device)
            ans[where[i][order]] = ans_sorted
            return ans

        return _each(mesh, fan_out, back, state)


def coverage_histogram_sharded(t: ShardedKmerTable):
    """Distributed k-mer coverage histogram: per-shard bincount, summed
    on the host (NetworkSequenceCollection.cpp:485-496)."""
    from ..core.histogram import Histogram
    total = None
    for keys, counts, alive in zip(t.keys, t.counts, t.alive):
        sel = alive & (keys != SENTINEL)
        h = torch.bincount(torch.where(sel, counts, 0).long(),
                           minlength=COVERAGE_MAX + 1).cpu().numpy()
        total = h if total is None else total + h
    hist = Histogram()
    for v in np.nonzero(total)[0]:
        if v > 0:
            hist.insert(int(v), int(total[v]))
    return hist


def erode_sharded(t: ShardedKmerTable, e: int, e_strand: int = 0) -> int:
    """Distributed erode (NAS_ERODE): blunt and weak k-mers die; the
    neighbour-aliveness reads are routed gathers; the per-round count is
    a psum.  e_strand is the per-strand E threshold."""
    mesh = t.mesh
    S = t.shard_size
    gather = RoutedGather(mesh, S, torch.bool)
    use_strand = e_strand > 0 and t.fwd_counts is not None
    fwd_in = t.fwd_counts if t.fwd_counts is not None else t.counts

    def weak_of(counts, fwd):
        weak = counts < e
        if use_strand:
            rev = counts - fwd
            weak = weak | (fwd < e_strand) | (rev < e_strand)
        return weak

    # only an alive weak row can die: the others' neighbours go unasked
    weak = [weak_of(c, f) for c, f in zip(t.counts, fwd_in)]

    def round_(i, alive, nbr, wk, nbr_alive):
        ok = (nbr >= 0) & nbr_alive.reshape(S, 8)
        rd = ok[:, :4].sum(1)
        ld = ok[:, 4:].sum(1)
        blunt = ((rd == 0) | (ld == 0)) & alive
        kill = blunt & wk
        return alive & ~kill, kill.sum()

    total = 0
    while True:
        nbr_alive = gather(t.alive, [
            torch.where((a & w)[:, None], x, -1).reshape(-1)
            for a, w, x in zip(t.alive, weak, t.nbr)])
        alive, n = _each(mesh, round_, t.alive, t.nbr, weak, nbr_alive)
        n = _total(mesh, n)
        t.alive = alive
        if n == 0:
            return total
        total += n


def apply_kc_sharded(t: ShardedKmerTable, kc: int) -> None:
    t.alive = [a & (c >= kc) for a, c in zip(t.alive, t.counts)]


def trim_sharded(t: ShardedKmerTable, max_tip: int) -> int:
    """Distributed trim: oriented-successor links and distributed
    pointer doubling (each hop a routed gather), then the
    chain-decomposition tip rules of the single-device engine
    (TrimAlgorithm.h:15-99; abyss_tpu.dbg.hash_dbg._trim_round),
    straight to the fixpoint."""
    total = 0
    while True:
        n = _trim_round_sharded(t, max_tip)
        total += n
        if n == 0:
            return total


def _oids(i: int, S: int, device) -> torch.Tensor:
    """Oriented global ids 2 * (i * S + r) + strand of device i's slots."""
    return 2 * i * S + torch.arange(2 * S, dtype=torch.int64, device=device)


def _oriented_next_sharded(t: ShardedKmerTable):
    """nxt[2S] per device of global oriented ids (gid * 2 + strand) or
    -1, the oriented out-degrees and the palindrome flags; remote
    degree reads are routed gathers."""
    mesh, k = t.mesh, t.k
    S = t.shard_size
    # a dead row has no link and is no link's target: its neighbours and
    # its out-degree go unasked (and unread)
    nbr_alive = RoutedGather(mesh, S, torch.bool)(t.alive, [
        torch.where(a[:, None], x, -1).reshape(-1)
        for a, x in zip(t.alive, t.nbr)])
    wide = t.wide

    def degrees(i, keys, hr, nbr, nbr_alive):
        ok = (nbr >= 0) & nbr_alive.reshape(S, 8)
        rd = ok[:, :4].sum(1, dtype=torch.int32)
        ld = ok[:, 4:].sum(1, dtype=torch.int32)
        outdeg = torch.stack([rd, ld], 1).reshape(-1)  # [2S] ov order
        palin = keys == (hr if wide else _rc_packed(keys, k))
        return outdeg, palin, ok

    hr_in = t.hr if t.hr is not None else t.keys
    outdeg, palin, ok = _each(mesh, degrees, t.keys, hr_in, t.nbr,
                              nbr_alive)
    # target in-degree in walk orientation = out-degree of the target's
    # opposite oriented vertex 2 * gid + (strand ^ 1); asked for the
    # alive links of alive rows, the only ones `links` reads
    t_oid = [torch.where(o, 2 * nbr + (st.long() ^ 1), -1).reshape(-1)
             for nbr, st, o in zip(t.nbr, t.nbr_strand, ok)]
    t_indeg = RoutedGather(mesh, 2 * S, torch.int32)(outdeg, t_oid)
    t_pal = RoutedGather(mesh, S, torch.bool)(
        palin, [torch.where(o, nbr, -1).reshape(-1)
                for nbr, o in zip(t.nbr, ok)])

    def links(i, nbr, strand, okm, outd, tin8, tpal8, alive, pal):
        strand = strand.long()
        outd = outd.reshape(S, 2)
        tin8 = tin8.reshape(S, 8)
        tpal8 = tpal8.reshape(S, 8)
        rows = torch.arange(S, device=nbr.device)
        nxt = torch.full((S, 2), -1, dtype=torch.int64, device=nbr.device)
        for s in (0, 1):
            cols = slice(0, 4) if s == 0 else slice(4, 8)
            sub_nbr = torch.where(okm[:, cols], nbr[:, cols], -1)
            best = sub_nbr.argmax(dim=1)
            tgt = sub_nbr[rows, best]
            tstrand = strand[:, cols][rows, best]
            tin = tin8[:, cols][rows, best]
            tp = tpal8[:, cols][rows, best]
            good = (outd[:, s] == 1) & (tgt >= 0) & (tin == 1) & ~tp
            nxt[:, s] = torch.where(good, 2 * tgt + tstrand, -1)
        # sources must be alive and non-palindromic
        keep = alive & ~pal
        return torch.where(keep[:, None], nxt, -1).reshape(-1)

    nxt = _each(mesh, links, t.nbr, t.nbr_strand, ok, outdeg, t_indeg,
                t_pal, t.alive, palin)
    return nxt, outdeg, palin


class RoutedReduce:
    """Reduce-by-key to key owners, overflow-adaptive like RoutedGather:
    each device reduces its runs of equal keys locally, routes one
    record per distinct key to the key's owner, and owners
    scatter-reduce into a [Q]-slot array.  op is "max" or "add" (int64
    values; 0 means absent, so callers bias values).  Keys are global
    slot ids (owner = key // Q), -1 for none; like RoutedGather it
    drops those first and sizes its buckets by the records left."""

    MAX_SLACK = 256.0

    def __init__(self, mesh: Mesh, Q: int, op: str, slack: float = 2.5):
        self.mesh, self.Q, self.op, self.slack = mesh, Q, op, slack

    def _records(self, key, val, cap):
        Q, n_dev = self.Q, mesh_size(self.mesh)
        dev = key.device
        ks, order = torch.sort(key)
        vs = val[order]
        rid = torch.cumsum(_run_starts(ks), dim=0) - 1
        red = torch.zeros(ks.shape[0], dtype=torch.int64, device=dev)
        if self.op == "max":
            red.scatter_reduce_(0, rid, vs, "amax", include_self=False)
        else:
            red.index_add_(0, rid, vs)
        red = red[rid]
        last = _run_starts(ks.flip(0)).flip(0)
        recs_k = torch.where(last, ks, _BIG)
        recs_v = torch.where(last, red, 0)
        dest = torch.where(last, recs_k // Q, n_dev)
        (kb, vb), ovf, *_ = _bucketize(dest, last, (recs_k % Q, recs_v),
                                       cap, n_dev, (0, 0))
        return kb, vb, ovf

    def _apply(self, kr, vr):
        Q = self.Q
        flatk = kr.reshape(-1)
        flatv = vr.reshape(-1)
        out = torch.zeros(Q + 1, dtype=torch.int64, device=kr.device)
        slot = torch.where(flatv != 0, flatk, Q)
        if self.op == "max":
            out.scatter_reduce_(0, slot, flatv, "amax")
        else:
            out.index_add_(0, slot, flatv)
        return out[:Q]

    def __call__(self, keys: list, values: list) -> list:
        mesh = self.mesh
        ax = table_axes(mesh)
        n_dev = mesh_size(mesh)
        # only the records with a key take part (the JAX package sorts
        # the -1 keys to the end and routes none of them either)
        keep = [torch.nonzero(k >= 0).reshape(-1) for k in keys]
        keys = [k[w] for k, w in zip(keys, keep)]
        values = [v[w] for v, w in zip(values, keep)]
        n_in = max(k.shape[0] for k in keys)
        if n_in == 0:
            return [torch.zeros(self.Q, dtype=torch.int64, device=d)
                    for d in mesh.flat]
        slack = self.slack
        while True:
            cap = max(64, min(n_in, int(slack * n_in / n_dev)))
            kb, vb, ovf = _each(mesh, lambda i, k, v: self._records(k, v, cap),
                                keys, values)
            if _total(mesh, ovf) == 0:
                break
            if slack >= self.MAX_SLACK:
                raise RuntimeError(f"routed reduce overflow at slack {slack}")
            slack = min(slack * 4, self.MAX_SLACK)
            self.slack = slack
        kr = all_to_all(mesh, kb, ax)
        vr = all_to_all(mesh, vb, ax)
        return _each(mesh, lambda i, a, b: self._apply(a, b), kr, vr)


def _route_records(mesh: Mesh, dest_of: list, payloads: list, valid: list,
                   n_in: int, fills: tuple, slack: float = 2.5) -> list:
    """One-shot record routing with adaptive slack: bucketize and one
    all_to_all per payload; returns the routed [n_dev * cap] arrays of
    each payload per device (fill-padded)."""
    ax = table_axes(mesh)
    n_dev = mesh_size(mesh)
    while True:
        cap = max(64, min(n_in, int(slack * n_in / n_dev)))
        bufs, ovf, *_ = _each(
            mesh, lambda i, d, v, *ps: _bucketize(d, v, tuple(ps), cap, n_dev,
                                                  fills),
            dest_of, valid, *payloads)
        if _total(mesh, ovf) == 0:
            break
        if slack >= 256:
            raise RuntimeError("record routing overflow")
        slack = min(slack * 4, 256)
    return [[x.reshape(-1) for x in all_to_all(mesh, [b[p] for b in bufs],
                                               ax)]
            for p in range(len(payloads))]


def _rank_chains(t: ShardedKmerTable):
    """Distributed list ranking: (P, dist, outdeg, nxt) per device — P[p]
    the global oriented id of p's chain head, dist its position.  Local
    slot p on device d is oriented gid 2 * d * S + p."""
    mesh = t.mesh
    ax = table_axes(mesh)
    S = t.shard_size
    n_dev = t.n_dev
    nxt, outdeg, _ = _oriented_next_sharded(t)

    # the doubling queries converge onto chain heads; the gather's local
    # dedup keeps them to one query per (source, head) pair.  Chains hold
    # alive rows only: a dead slot heads itself at distance 0 throughout,
    # so only the alive slots ask
    gather_oid = RoutedGather(mesh, 2 * S, torch.int64)
    active = _alive_slots(t)

    def asked(xs):
        return [torch.where(a, x, -1) for a, x in zip(active, xs)]

    def kept(gathered, xs):
        return [torch.where(a, g, x) for a, g, x in
                zip(active, gathered, xs)]

    # prev pointers: route (target, source) pairs to the targets' owners
    pslack = 2.5
    while True:
        cap = max(64, int(pslack * 2 * S / n_dev))

        def prev_route(i, nx):
            src = _oids(i, S, nx.device)
            valid = nx >= 0
            dest = torch.where(valid, nx // (2 * S), 0)
            (tb, sb), ov, *_ = _bucketize(dest, valid, (nx, src), cap,
                                          n_dev, (-1, -1))
            return tb, sb, ov

        tb, sb, ov = _each(mesh, prev_route, nxt)
        if not _total(mesh, ov):
            break
        pslack *= 2
        if pslack > max(64.0, 4.0 * n_dev):
            raise RuntimeError("trim routing overflow")
    tr = all_to_all(mesh, tb, ax)
    sr = all_to_all(mesh, sb, ax)

    def prev_of(i, trl, srl):
        trl, srl = trl.reshape(-1), srl.reshape(-1)
        prev = torch.full((2 * S,), -1, dtype=torch.int64, device=trl.device)
        return set_last(prev, trl % (2 * S), srl, trl >= 0)

    prev = _each(mesh, prev_of, tr, sr)
    gather_u64 = RoutedGather(mesh, 2 * S, torch.int64)

    def pd_init(i, prevl):
        self_oid = _oids(i, S, prevl.device)
        return (torch.where(prevl >= 0, prevl, self_oid),
                (prevl >= 0).to(torch.int64))

    def pd_loop(prev_links, with_min):
        Pcur, dist = _each(mesh, pd_init, prev_links)
        Mk = Ms = None
        if with_min:
            slot = [torch.arange(2 * S, device=d) for d in mesh.flat]
            Mk = [keys[s >> 1] for keys, s in zip(t.keys, slot)]
            Ms = [s & 1 for s in slot]
        moved = -1
        for _ in range(64):
            q = asked(Pcur)
            gP = kept(gather_oid(Pcur, q), Pcur)
            gd = gather_oid(dist, q)
            if with_min:
                gMk = kept(gather_u64(Mk, q), Mk)
                gMs = kept(gather_oid(Ms, q), Ms)
                # lexicographic (kmer, strand) minimum: id-space
                # independent, so the cycle break lands on the vertex
                # the single-device engine picks
                take = [u64.ult(a, m) | ((a == m) & (b < s))
                        for a, m, b, s in zip(gMk, Mk, gMs, Ms)]
                Mk = [torch.where(tk, a, m) for tk, a, m in zip(take, gMk, Mk)]
                Ms = [torch.where(tk, b, s) for tk, b, s in zip(take, gMs, Ms)]
            moved = _total(mesh, [(a != b).sum() for a, b in zip(gP, Pcur)])
            dist = [d + g for d, g in zip(dist, gd)]
            Pcur = gP
            if moved == 0:
                break
        return Pcur, dist, (Mk, Ms), moved

    Pcur, dist, _, moved = pd_loop(prev, False)
    if moved:
        # cycles (circular unitigs): find each cycle's minimum
        # (kmer, strand) member with a min-reduction riding a second
        # ranking pass, cut the edge into it and rank again
        # (chain_ops._full_rank's cycle breaking)
        _, _, (Mk, Ms), _ = pd_loop(prev, True)
        conv = RoutedGather(mesh, 2 * S, torch.bool)(
            [p < 0 for p in prev], asked(Pcur))

        def cut(i, prevl, convl, Mkl, Msl, keys):
            slot = torch.arange(2 * S, device=keys.device)
            mine = (keys[slot >> 1] == Mkl) & ((slot & 1) == Msl)
            return torch.where(~convl & mine, -1, prevl)

        prev = _each(mesh, cut, prev, conv, Mk, Ms, t.keys)
        Pcur, dist, _, _ = pd_loop(prev, False)
    return Pcur, dist, outdeg, nxt


_OV_BITS = 40  # oriented gids fit 40 bits (<= 2^39 rows in all)


def _unpack_end(ep: torch.Tensor):
    """(has, length, end_ov) of packed chain ends ((dist << 40 | end ov)
    + 1, 0 for none)."""
    has = ep > 0
    length = ((ep - 1) >> _OV_BITS) + 1
    end_ov = (ep - 1) & ((1 << _OV_BITS) - 1)
    return has, length, end_ov


def _chain_ends(t: ShardedKmerTable, Pm, dist):
    """Per local head slot h: (max dist << 40 | end ov) + 1, or 0 when h
    heads no alive chain: a reduce-by-head over the valid oriented
    vertices."""
    mesh = t.mesh
    S = t.shard_size

    def keyed(i, Pl, dl, alive, keys):
        ok = torch.repeat_interleave(alive & (keys != SENTINEL), 2)
        key = torch.where(ok, Pl, -1)
        # the (dist, ov) pack budgets 63 - 40 bits for the position:
        # clamp beyond it (such chains are past every length bound)
        dl = dl.clamp(0, 1 << 22)
        val = (dl << _OV_BITS) | _oids(i, S, Pl.device)
        return key, val + 1

    key, val = _each(mesh, keyed, Pm, dist, t.alive, t.keys)
    return RoutedReduce(mesh, 2 * S, "max")(key, val)


def _alive_slots(t: ShardedKmerTable) -> list:
    """bool [2S] per device: the oriented slots of alive rows."""
    return [torch.repeat_interleave(a & (k != SENTINEL), 2)
            for a, k in zip(t.alive, t.keys)]


def _head_gather(t: ShardedKmerTable, values, Pm, dtype) -> list:
    """values at each alive slot's chain head (Pm), 0 at dead slots."""
    return RoutedGather(t.mesh, 2 * t.shard_size, dtype)(
        values, [torch.where(a, p, -1) for a, p in zip(_alive_slots(t), Pm)])


def _kill_members(t: ShardedKmerTable, Pm, kill_head) -> list:
    """t.alive with the rows of every chain whose head is flagged in
    kill_head (a routed gather of the verdicts, keyed by head) killed;
    also returns the rows killed per device."""
    S = t.shard_size
    kill_ov = _head_gather(t, kill_head, Pm, torch.bool)
    out, removed = [], []
    for kill, alive in zip(kill_ov, t.alive):
        kill = kill.reshape(S, 2)
        kill_row = (kill[:, 0] | kill[:, 1]) & alive
        out.append(alive & ~kill_row)
        removed.append(kill_row.sum())
    return out, removed


def _trim_round_sharded(t: ShardedKmerTable, max_tip: int) -> int:
    """One distributed trim round with the kill decision at the head's
    owner: chain length and end from a reduce-by-head, the end's
    out-degree from a routed gather, and the verdict broadcast back to
    members by a head-keyed routed gather (the rules of
    abyss_tpu.dbg.hash_dbg._trim_round)."""
    mesh = t.mesh
    S = t.shard_size
    Pm, dist, outdeg, _ = _rank_chains(t)
    endpack = _chain_ends(t, Pm, dist)
    end_ov = []
    for ep in endpack:
        has, _, eo = _unpack_end(ep)
        end_ov.append(torch.where(has, eo, -1))
    end_outdeg = RoutedGather(mesh, 2 * S, torch.int32)(outdeg, end_ov)

    def decide(i, ep, outd, eo):
        has, length, _ = _unpack_end(ep)
        # in-degree of head ov h = out-degree of h ^ 1
        slot = torch.arange(2 * S, device=ep.device)
        indeg = outd[slot ^ 1]
        return has & (indeg == 0) & (length <= max_tip) & (eo <= 1)

    kill_head = _each(mesh, decide, endpack, outdeg, end_outdeg)
    alive, removed = _kill_members(t, Pm, kill_head)
    removed = _total(mesh, removed)
    if removed:
        t.alive = alive
    return removed


# distributed finish: low-coverage removal, bubbles, emission.  Chain
# stats live at each chain head's owner (RoutedReduce), verdicts go back
# by head-keyed gathers, and emission scatters (position, base) pairs
# into a position-sharded buffer (NetworkSequenceCollection.cpp:457-664,
# parallelAbyss.cpp:29-68).


def _chain_covsums(t: ShardedKmerTable, Pm):
    """Per local head slot: the sum of its chain's k-mer counts."""
    mesh = t.mesh
    S = t.shard_size

    def keyed(i, Pl, alive, keys, counts):
        ok = torch.repeat_interleave(alive & (keys != SENTINEL), 2)
        return (torch.where(ok, Pl, -1),
                torch.repeat_interleave(counts.to(torch.int64), 2))

    key, val = _each(mesh, keyed, Pm, t.alive, t.keys, t.counts)
    return RoutedReduce(mesh, 2 * S, "add")(key, val)


def _kept_rule(hk, hs, ek, es):
    """hash_dbg._kept_rule on int64 words: keep chain (head, end) iff
    (head kmer, head strand, end kmer, end strand) <= the rc chain's
    (end kmer, end strand ^ 1, head kmer, head strand ^ 1), kmers
    compared unsigned."""
    rk, rs = ek, es ^ 1
    qk, qs = hk, hs ^ 1
    return u64.ult(hk, rk) | ((hk == rk) & (
        (hs < rs) | ((hs == rs) & (
            u64.ult(ek, qk) | ((ek == qk) & (es <= qs))))))


def _kept_len_end(t: ShardedKmerTable, endpack):
    """Per local head slot: (has, kept, length, end_ov), kept the
    rc-duplicate rule of hash_dbg._kept_rule, id-space independent, so
    the sharded engine picks the chain orientations (and emission
    order) of the single-device one.  The end k-mer comes from one
    routed gather."""
    mesh = t.mesh
    S = t.shard_size
    has, length, end_ov = [], [], []
    for ep in endpack:
        h, ln, eo = _unpack_end(ep)
        has.append(h)
        length.append(torch.where(h, ln, 0))
        end_ov.append(torch.where(h, eo, -1))
    ek = RoutedGather(mesh, S, torch.int64)(
        t.keys, [torch.where(eo >= 0, eo >> 1, -1) for eo in end_ov])

    def keptf(i, h, eo, ekl, keys):
        slot = torch.arange(2 * S, device=keys.device)
        es = torch.where(eo >= 0, eo & 1, 0)
        return h & _kept_rule(keys[slot >> 1], slot & 1, ekl, es)

    kept = _each(mesh, keptf, has, end_ov, ek, t.keys)
    return has, kept, length, end_ov


def remove_low_coverage_sharded(t: ShardedKmerTable, c: float) -> int:
    """Distributed low-coverage contig removal: a chain whose mean
    coverage is below c dies (AssembleAlgorithm.h:14-39), by the exact
    rational test covsum * 2^20 < round(c * 2^20) * length.  Returns the
    number of (deduplicated) contigs removed."""
    mesh = t.mesh
    c20 = int(round(c * (1 << 20)))
    Pm, dist, _, _ = _rank_chains(t)
    endpack = _chain_ends(t, Pm, dist)
    covsum = _chain_covsums(t, Pm)
    has, kept, length, _ = _kept_len_end(t, endpack)
    kill_head = [h & ((cov << 20) < c20 * ln)
                 for h, cov, ln in zip(has, covsum, length)]
    ncontigs = _total(mesh, [(kh & kp).sum()
                             for kh, kp in zip(kill_head, kept)])
    if ncontigs == 0:
        return 0
    t.alive, _ = _kill_members(t, Pm, kill_head)
    return ncontigs


def _entry_info(t: ShardedKmerTable, Pm, endpack, end_ov):
    """Per local head slot: (entry_cnt, entry_row) — the alive junction
    rows just behind the chain head in walk orientation, same-chain
    candidates excluded by each candidate row's chain id (the min of
    its two oriented heads)."""
    mesh = t.mesh
    S = t.shard_size

    def cand_rows(i, nbr, ep):
        slot = torch.arange(2 * S, device=nbr.device)
        r = slot >> 1
        s = slot & 1
        # entry side: left cols (4..7) on strand 0, right (0..3) on 1
        cand = torch.stack(
            [torch.where(s == 0, nbr[r, 4 + c], nbr[r, c])
             for c in range(4)], dim=1)
        return torch.where((ep > 0)[:, None], cand, -1).reshape(-1)

    cand = _each(mesh, cand_rows, t.nbr, endpack)
    cand_alive = RoutedGather(mesh, S, torch.bool)(t.alive, cand)
    g_p = RoutedGather(mesh, 2 * S, torch.int64)
    p0 = g_p(Pm, [torch.where(c >= 0, 2 * c, -1) for c in cand])
    p1 = g_p(Pm, [torch.where(c >= 0, 2 * c + 1, -1) for c in cand])

    def combine(i, cl, al, a0, a1, eo):
        cl = cl.reshape(2 * S, 4)
        al = al.reshape(2 * S, 4)
        rc = torch.minimum(a0, a1).reshape(2 * S, 4)
        chainid = torch.minimum(_oids(i, S, cl.device), eo ^ 1)
        ok = (cl >= 0) & al & (rc != chainid[:, None])
        return (ok.sum(dim=1, dtype=torch.int32),
                torch.where(ok, cl, -1).amax(dim=1))

    return _each(mesh, combine, cand, cand_alive, p0, p1, end_ov)


def _lex_order(keys: list) -> torch.Tensor:
    """Permutation sorting by the int64 key tensors, most significant
    first (lax.sort with num_keys = len(keys), stable)."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        o = torch.argsort(k, stable=True)
        order = o if order is None else order[o]
    return order


def pop_bubbles_sharded(t: ShardedKmerTable, max_len: int,
                        max_branches: int = 3) -> list[str]:
    """Distributed bubble popping (BubbleAlgorithm.h:46-137): candidate
    chains are grouped by their (entry, exit) junction pair at the
    pair-hash owner; the winner is the branch of highest mean coverage
    (exact rational compare), ties broken by (head k-mer, strand), and
    the losers' rows die.  Returns the popped branch sequences."""
    mesh = t.mesh
    S = t.shard_size
    n_dev = t.n_dev
    Pm, dist, _, _ = _rank_chains(t)
    endpack = _chain_ends(t, Pm, dist)
    covsum = _chain_covsums(t, Pm)
    has, kept, length, end_ov = _kept_len_end(t, endpack)
    ecnt, erow = _entry_info(t, Pm, endpack, end_ov)
    # exit info of chain (h, e) = entry info of its rc chain (head e^1)
    pq = [torch.where(h, eo ^ 1, -1) for h, eo in zip(has, end_ov)]
    xcnt = RoutedGather(mesh, 2 * S, torch.int32)(ecnt, pq)
    xrow = RoutedGather(mesh, 2 * S, torch.int64)(erow, pq)
    log2_d = int(n_dev - 1).bit_length()

    def records(i, keptl, ln, ec, er, xc, xr, keys):
        cand = keptl & (ln <= max_len) & (ec == 1) & (xc == 1)
        a = torch.minimum(er, xr)
        b = torch.maximum(er, xr)
        slot = torch.arange(2 * S, device=keys.device)
        keyhash = _mix64((a * u64.s64(0x9E3779B97F4A7C15)) ^ b)
        dest = u64.srl(keyhash, 64 - log2_d) if log2_d else \
            torch.zeros(2 * S, dtype=torch.int64, device=keys.device)
        return (dest, cand, a, b, _oids(i, S, keys.device),
                keys[slot >> 1])

    dest, cand, a, b, hgid, hkmer = _each(
        mesh, records, kept, length, ecnt, erow, xcnt, xrow, t.keys)
    ra, rb, rcov, rln, rh, rk = _route_records(
        mesh, dest, [a, b, covsum, length, hgid, hkmer], cand, 2 * S,
        (-1, -1, 0, 0, -1, SENTINEL))
    Q = ra[0].shape[-1]
    W = max_branches + 1

    def winners(i, av, bv, cv, lv, hv, kv):
        dev = av.device
        valid = av >= 0
        ak = torch.where(valid, av, _BIG)
        # records by (a, b, head kmer, head strand): groups contiguous,
        # branch order the id-space-independent tie rule
        order = _lex_order([ak, bv, u64.flip(kv), hv & 1])
        avs, bvs = ak[order], bv[order]
        kvs, svs = kv[order], (hv & 1)[order]
        cvs, lvs, hvs = cv[order], lv[order], hv[order]
        valids = avs < _BIG
        zero = torch.zeros(1, dtype=torch.bool, device=dev)
        one = torch.ones(1, dtype=torch.bool, device=dev)
        same_prev = valids & torch.cat(
            [zero, (avs[1:] == avs[:-1]) & (bvs[1:] == bvs[:-1])])
        first = valids & ~same_prev
        pos = torch.arange(Q, device=dev)
        start_pos = running_max(torch.where(first, pos, -1))
        last = valids & torch.cat(
            [(avs[:-1] != avs[1:]) | (bvs[:-1] != bvs[1:]), one])
        end_pos = running_min(torch.where(last, pos, Q), reverse=True)
        gsize = end_pos - start_pos + 1
        group_ok = valids & (gsize >= 2) & (gsize <= max_branches)
        beaten = torch.zeros(Q, dtype=torch.bool, device=dev)
        for off in range(1, W):
            # group sizes are capped at max_branches, so a rotation
            # window of that width covers every pair of a group
            for sh in (off, -off):
                cj, lj, kj, sj, pj = (torch.roll(x, -sh) for x in
                                      (cvs, lvs, kvs, svs, pos))
                in_seg = (pj >= start_pos) & (pj <= end_pos) & (pj != pos)
                # does record j beat record i? higher exact mean, then
                # smaller (kmer, strand)
                mj, mi = cj * lvs, cvs * lj
                beats = (mj > mi) | ((mj == mi) & (
                    u64.ult(kj, kvs) | ((kj == kvs) & (sj < svs))))
                beaten = beaten | (in_seg & beats)
        kill = group_ok & beaten
        valid_k = kill & (hvs >= 0)
        return torch.where(valid_k, hvs // (2 * S), 0), valid_k, hvs

    kdst, kvalid, kill_h = _each(mesh, winners, ra, rb, rcov, rln, rh, rk)
    (routed_h,) = _route_records(mesh, kdst, [kill_h], kvalid, Q, (-1,))

    def to_flags(i, rhv):
        slot = torch.where(rhv >= 0, rhv % (2 * S), 2 * S)
        flags = torch.zeros(2 * S + 1, dtype=torch.bool, device=rhv.device)
        flags[slot] = True
        return flags[:2 * S]

    kill_head = _each(mesh, to_flags, routed_h)
    if _total(mesh, [k.sum() for k in kill_head]) == 0:
        return []
    # emit the popped branches before the kills (ranking is current)
    popped = [s for s, _ in _emit_sharded(
        t, Pm, dist, endpack, covsum, kill_head, canonical=False)]
    t.alive, _ = _kill_members(t, Pm, kill_head)
    return popped


_ASCII = np.frombuffer(b"ACGT", np.uint8)
_RC_TABLE = bytes.maketrans(b"ACGT", b"TGCA")


def _emit_sharded(t: ShardedKmerTable, Pm, dist, endpack, covsum,
                  sel_head, canonical: bool = True):
    """Distributed contig emission: every member k-mer routes its one
    walk-orientation base (and each head its k - 1 prefix bases) to a
    position-sharded output buffer, so the host receives the contig
    bases and per-chain metadata only (parallelAbyss.cpp:29-68).
    Returns [(sequence, covsum)] ordered by (head k-mer, strand), the
    order of the single-device engine's sorted table."""
    mesh, k = t.mesh, t.k
    S = t.shard_size
    n_dev = t.n_dev

    def meta(i, ep, sel):
        has, length, _ = _unpack_end(ep)
        has = sel & has
        outlen = torch.where(has, length + (k - 1), 0)
        csum = torch.cumsum(outlen, dim=0)
        return csum - outlen, csum[-1]

    loc_off, totals = _each(mesh, meta, endpack, sel_head)
    totals_np = np.array([int(x.item()) for x in totals], np.int64)
    T = int(totals_np.sum())
    if T == 0:
        return []
    bases_np = np.concatenate([[0], np.cumsum(totals_np)[:-1]])
    off = [lo + int(b) for lo, b in zip(loc_off, bases_np)]
    selm = _head_gather(t, sel_head, Pm, torch.bool)
    offm = _head_gather(t, off, Pm, torch.int64)
    chunk = -(-T // n_dev)
    wide = t.wide
    text_in = t.text if wide else [None] * mesh.size

    def entries(i, sel_m, off_m, dl, alive, keys, textl, ep, sel, offl):
        dev = keys.device
        slot = torch.arange(2 * S, device=dev)
        r = slot >> 1
        s = slot & 1

        def base_at(j, rows):
            """Base j (stored orientation) of each of `rows`."""
            if wide:
                return u64.srl(textl[rows, j // 32],
                               62 - 2 * (j % 32)) & 3
            return u64.srl(keys[rows], 2 * (k - 1 - j)) & 3

        ok = torch.repeat_interleave(alive & (keys != SENTINEL), 2) & sel_m
        m = torch.nonzero(ok).reshape(-1)
        tgts = [off_m[m] + (k - 1) + dl[m]]
        vals = [torch.where(s[m] == 0, base_at(k - 1, r[m]),
                            3 - base_at(0, r[m]))]
        # head prefixes: the k - 1 leading walk-orientation bases,
        # written by the selected chain heads themselves
        h = torch.nonzero(sel & (ep > 0) & (offl >= 0)).reshape(-1)
        for j in range(k - 1):
            tgts.append(offl[h] + j)
            vals.append(torch.where(s[h] == 0, base_at(j, r[h]),
                                    3 - base_at(k - 1 - j, r[h])))
        tgt = torch.cat(tgts)
        return tgt, torch.cat(vals).to(torch.int32), tgt // chunk

    tgt, val, dest = _each(mesh, entries, selm, offm, dist, t.alive, t.keys,
                           text_in, endpack, sel_head, off)
    n_in = max(max(x.shape[0] for x in tgt), 1)
    pad = [torch.full((n_in - x.shape[0],), -1, dtype=x.dtype,
                      device=x.device) for x in tgt]
    tgt = [torch.cat([x, p]) for x, p in zip(tgt, pad)]
    val = [torch.cat([x, p.to(x.dtype) * 0]) for x, p in zip(val, pad)]
    dest = [torch.cat([x, p * 0]) for x, p in zip(dest, pad)]
    rt, rv = _route_records(mesh, dest, [tgt, val], [x >= 0 for x in tgt],
                            n_in, (-1, 0))

    def scatter_out(i, rtl, rvl):
        loc = torch.where(rtl >= 0, rtl - i * chunk, chunk)
        loc = torch.where((loc >= 0) & (loc < chunk), loc, chunk)
        buf = torch.zeros(chunk + 1, dtype=torch.uint8, device=rtl.device)
        buf[loc] = rvl.to(torch.uint8)
        return buf[:chunk]

    buf = _each(mesh, scatter_out, rt, rv)
    flat = torch.cat([b.cpu() for b in buf]).numpy()[:T]

    hk_l, hs_l, off_l, len_l, cov_l = [], [], [], [], []
    for ep, sel, offl, cov, keys in zip(endpack, sel_head, off, covsum,
                                        t.keys):
        has, length, _ = _unpack_end(ep)
        rows = torch.nonzero(sel & has).reshape(-1)
        hk_l.append(u64.to_numpy(keys[rows >> 1]))
        hs_l.append((rows & 1).cpu().numpy().astype(np.int8))
        off_l.append(offl[rows].cpu().numpy())
        len_l.append((length[rows] + (k - 1)).cpu().numpy())
        cov_l.append(cov[rows].cpu().numpy())
    hk_a, hs_a, off_a, len_a, cov_a = (np.concatenate(x) for x in
                                       (hk_l, hs_l, off_l, len_l, cov_l))
    if not len(hk_a):
        return []
    order = np.lexsort((hs_a, hk_a))
    ascii_buf = _ASCII[np.minimum(flat, 3)].tobytes()
    out = []
    for i in order:
        o, ln = int(off_a[i]), int(len_a[i])
        s = ascii_buf[o:o + ln]
        if canonical:
            rc = s.translate(_RC_TABLE)[::-1]
            if rc < s:
                s = rc
        out.append((s.decode(), int(cov_a[i])))
    return out


def assemble_final_sharded(t: ShardedKmerTable) -> list[tuple[str, int]]:
    """Distributed unitig extraction (AssembleAlgorithm.h:45-142 over
    the mesh): rank chains, emit each kept chain's bases into the
    position-sharded buffer, canonicalize and dedupe on the host.
    Output order and content match the single-device engine."""
    Pm, dist, _, _ = _rank_chains(t)
    endpack = _chain_ends(t, Pm, dist)
    covsum = _chain_covsums(t, Pm)
    _, kept, _, _ = _kept_len_end(t, endpack)
    seen = set()
    out = []
    for s, cov in _emit_sharded(t, Pm, dist, endpack, covsum, kept,
                                canonical=True):
        if s in seen:
            continue
        seen.add(s)
        out.append((s, cov))
    return out


def assemble_sharded(mesh: Mesh, batches, k: int, kc: int = 2,
                     erode_cov: int | None = 2,
                     erode_strand: int | None = 0,
                     tip_len: int | None = None,
                     auto_params: bool = False,
                     min_mean_cov: float | None = None,
                     bubble_len: int | None = None,
                     bubbles_out: list | None = None):
    """Full distributed stage 1, every phase on the mesh: count -> kc
    -> adjacency -> erode -> trim -> low-coverage loop -> bubbles ->
    assemble (NetworkSequenceCollection.cpp:457-664).  The table never
    leaves the mesh.  Returns (contigs, table); the contigs are the
    single-device engine's set.  Each phase is a span: `mesh.count`
    (with the coverage model), `mesh.kc_filter`, `mesh.adjacency`,
    `mesh.erode`, `mesh.trim`, `mesh.lowcov`, `mesh.bubbles` and
    `mesh.emit`."""
    with trace.span("mesh.count", device=True):
        t = build_sharded_table(mesh, batches, k)
        if auto_params and (erode_cov is None or erode_strand is None
                            or min_mean_cov is None):
            from ..dbg.hash_dbg import auto_coverage_params
            e_a, E_a, c_a = auto_coverage_params(
                coverage_histogram_sharded(t))
            if erode_cov is None:
                erode_cov = e_a
            if erode_strand is None:
                erode_strand = E_a
            if min_mean_cov is None:
                min_mean_cov = c_a
    if erode_cov is None:
        erode_cov = 2
    if erode_strand is None:
        erode_strand = 0
    with trace.span("mesh.kc_filter", device=True):
        apply_kc_sharded(t, kc)
    with trace.span("mesh.adjacency", device=True):
        build_adjacency_sharded(t)
    with trace.span("mesh.erode", device=True):
        erode_sharded(t, erode_cov, erode_strand)
    tip = tip_len if tip_len is not None else k
    with trace.span("mesh.trim", device=True):
        trim_sharded(t, tip)
    if min_mean_cov:
        with trace.span("mesh.lowcov", device=True):
            while remove_low_coverage_sharded(t, min_mean_cov):
                erode_sharded(t, erode_cov, erode_strand)
                trim_sharded(t, tip)
    # -b0 disables popping (Assembly/Options.cc:62,177); None = default
    blen = bubble_len if bubble_len is not None else 2 * k + 1
    with trace.span("mesh.bubbles", device=True):
        popped = pop_bubbles_sharded(t, blen) if blen > 0 else []
    if bubbles_out is not None:
        bubbles_out.extend(popped)
    with trace.span("mesh.emit", device=True):
        out = assemble_final_sharded(t)
    return out, t
