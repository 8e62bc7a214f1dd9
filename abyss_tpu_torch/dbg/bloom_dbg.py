"""Bloom-filter de Bruijn graph unitig assembly (the `abyss-bloom-dbg` model).

Port of abyss_tpu/dbg/bloom_dbg.py.  Two streaming passes, as in the
reference driver (BloomDBG/bloom-dbg.h:902-1077):

  pass 1  stream reads -> count canonical k-mer hashes (the CUDA ntHash
          kernel on the GPU) into the solid-k-mer structure: the exact
          sorted table (`filter_mode="sorted"`, the default: sort +
          run-length encoding) or the reference's counting Bloom filter
          (`filter_mode="bloom"`: conservative inserts, whose write side
          is the CUDA scatter-max kernel on the GPU);
  pass 2  stream reads -> classify (short / non-ACGT / blunt / not-solid
          / already-assembled), seed eligible reads with their first
          unassembled k-mer, extend seeds left+right in lockstep to
          unitig boundaries (dbg/extend.py), trim branch k-mers, dedupe,
          emit.

Output is byte-identical to the JAX package's on the same reads and
parameters: batches are processed in input order, and within a batch
contigs are deduped by canonical sequence and emitted in (batch, row)
order.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np
import torch

from .. import resolve_device, u64
from ..core import alphabet
from ..io import fastx
from ..io import read_batches as io_read_batches
from ..ops import bloom as bloom_ops
from ..ops import nthash
from ..utils import trace
from . import extend as ext
from .params import AssemblyParams


@dataclass
class AssemblyCounters:
    """Reference: BloomDBG/AssemblyCounters.h."""
    read_count: int = 0
    solid_reads: int = 0
    visited_reads: int = 0
    blunt_reads: int = 0
    contig_id: int = 0
    bases_assembled: int = 0
    kmers_loaded: int = 0


@dataclass
class Contig:
    id: int
    seq: str
    coverage: int
    read_id: str

    @property
    def header(self) -> str:
        # printContig format: "<id> <length> <coverage> read:<readID>"
        # (bloom-dbg.h:456-487)
        return f"{self.id} {len(self.seq)} {self.coverage} read:{self.read_id}"


def load_filter(batches: Iterable[fastx.ReadBatch], params: AssemblyParams,
                counters: AssemblyCounters | None = None, device="cuda"):
    """Pass 1: build the solid-k-mer structure on `device` (cf.
    loadBloomFilter, BloomDBG/BloomIO.h:97).

    params.filter_mode picks it: "sorted" (default) counts exactly with
    device sorts (a SortedKmerFilter); "bloom" keeps the reference's
    counting Bloom filter, sized from params.bloom_bytes (8/9 of the
    budget)."""
    dev = resolve_device(device)
    if params.filter_mode == "sorted":
        from ..ops.sorted_filter import SortedKmerCounter
        ctr = SortedKmerCounter(params.k, params.min_cov)
        add, finish = ctr.add, lambda: ctr.finalize(dev)
    elif params.filter_mode == "bloom":
        counting_size, _ = bloom_ops.recommended_sizes(params.bloom_bytes)
        cbf = bloom_ops.CountingBloomFilter.create(
            counting_size, params.k, params.num_hashes, params.min_cov,
            device=dev)
        add, finish = cbf.insert, lambda: cbf
    else:
        raise ValueError(f"filter_mode must be 'sorted' or 'bloom', got "
                         f"{params.filter_mode!r}")
    # the k-mer tally stays on the device; one scalar sync at the end
    kmer_tally = None
    for batch in batches:
        canon, valid = nthash.canonical_hashes(
            torch.from_numpy(batch.codes).to(dev), params.k)
        add(canon, valid)
        if counters is not None:
            counters.read_count += batch.num_reads
            v = valid.sum()
            kmer_tally = v if kmer_tally is None else kmer_tally + v
    if counters is not None and kmer_tally is not None:
        counters.kmers_loaded += int(kmer_tally)
    return finish()


def _classify_batch(cbf, visited, codes, lengths, k, fp_look_ahead,
                    lookahead_width, wf=None):
    """Per-read eligibility + first unassembled k-mer index.

    Implements the processRead guards (bloom-dbg.h:804-846): length >= k,
    all-ACGT, not blunt-ended, all k-mers solid, not all k-mers visited.
    The per-window work stays on the device; per-read results come back
    as numpy arrays."""
    dev = cbf.device
    canon, valid = nthash.canonical_hashes(torch.from_numpy(codes).to(dev), k)
    W = codes.shape[1] - k + 1
    lengths_t = torch.from_numpy(lengths.astype(np.int64)).to(dev)
    in_read = torch.arange(W, device=dev)[None, :] < \
        (lengths_t[:, None] - k + 1)
    valid_t = valid & in_read

    long_enough = lengths >= k
    # reference skips reads with ANY non-ACGT char (bloom-dbg.h:812)
    n_windows = torch.clamp(lengths_t - k + 1, min=0)
    all_acgt_t = (valid_t.sum(dim=1) == n_windows) & (lengths_t >= k)
    solid = cbf.contains_bulk(canon)
    all_solid = (((solid | ~valid_t).all(dim=1)) & all_acgt_t).cpu().numpy()
    fresh = ~visited.contains(canon) & valid_t
    first_unvisited = torch.where(
        fresh.any(dim=1), torch.argmax(fresh.to(torch.uint8), dim=1),
        -1).cpu().numpy()
    all_visited = first_unvisited < 0

    # blunt-end check (hasBluntEnd, bloom-dbg.h:496-532): the read's first
    # k-mer must extend backwards and its last k-mer forwards, each within
    # fpLookAhead steps.  REVERSE lookahead from kmer == FORWARD from rc.
    first_rc = alphabet.revcomp_codes(codes[:, :k]).astype(np.uint8)
    first_rc[~long_enough] = 0
    start = np.maximum(lengths - k, 0)
    last = np.take_along_axis(
        codes, start[:, None] + np.arange(k)[None, :], axis=1)
    last = np.where(long_enough[:, None], last, 0).astype(np.uint8)
    walk = wf if wf is not None else cbf
    ok_left = ext.lookahead_ok(walk, first_rc, k, fp_look_ahead,
                               width=lookahead_width)
    ok_right = ext.lookahead_ok(walk, last, k, fp_look_ahead,
                                width=lookahead_width)
    blunt = ~(ok_left & ok_right)

    eligible = all_solid & ~all_visited & ~blunt
    return dict(eligible=eligible, all_solid=all_solid, blunt=blunt,
                all_visited=all_visited, first_unvisited=first_unvisited,
                canon=canon, valid=valid_t)


def _extend_both(cbf, seeds: np.ndarray, params: AssemblyParams):
    """Extend [M, k] seeds both directions (REVERSE then FORWARD, like
    processRead bloom-dbg.h:860-862).

    Returns (seqs list[np.ndarray], left_status, right_status)."""
    k, trim = params.k, params.trim_len
    width, chunk = params.lookahead_width, params.chunk
    cmax = params.chunk_max
    # left extension: FORWARD walk on the reverse complement
    rc_seeds = alphabet.revcomp_codes(seeds)
    lbuf, llen, lstat = ext.extend_forward(
        cbf, rc_seeds, k, trim, width, chunk, params.max_contig_len,
        chunk_max=cmax)
    M = seeds.shape[0]
    # batched length-aware reverse complement of every left walk
    Lmax = lbuf.shape[1]
    comp = alphabet.complement_codes(lbuf)
    ridx = llen[:, None] - 1 - np.arange(Lmax)[None, :]
    lp_all = np.where(ridx >= 0, np.take_along_axis(
        comp, np.maximum(ridx, 0), axis=1), np.uint8(4))
    rows = np.arange(M)
    has_left = llen > k
    prev_base = np.where(
        has_left, lp_all[rows, np.maximum(llen - k - 1, 0)],
        0).astype(np.uint8)
    # right extension: warm start with the base preceding the seed where
    # the left walk extended (lookBehind with expected predecessor)
    warm = has_left.any()
    rbuf, rlen, rstat = ext.extend_forward(
        cbf, seeds, k, trim, width, chunk, params.max_contig_len,
        prev_base=prev_base if warm else None, chunk_max=cmax)
    off = 1 if warm else 0
    seqs = [np.concatenate([lp_all[i, :llen[i]], rbuf[i, off + k:rlen[i]]])
            for i in range(M)]
    return seqs, lstat, rstat


def _is_tip(length_kmers, lstat, rstat, trim):
    """isTip (bloom-dbg.h:759-776)."""
    short = length_kmers <= trim
    l_dead = lstat == ext.DEAD_END
    r_dead = rstat == ext.DEAD_END
    l_deadish = l_dead | (lstat == ext.AMBI_IN)
    r_deadish = r_dead | (rstat == ext.AMBI_IN)
    return short & ((l_dead & r_deadish) | (r_dead & l_deadish))


def _ambiguous_ends(cbf, roots: np.ndarray, expected: np.ndarray, params):
    """Batched ambiguous(u, expected, dir) over N contig ends
    (ExtendPath.h:379-397): true where the successor search is AMBI_OUT
    or resolves to a different vertex than the path neighbour.

    roots: uint8[N, k] end k-mers already oriented in the walk
    direction; expected: int[N] expected next base."""
    k, trim, width = params.k, params.trim_len, params.lookahead_width
    N = len(roots)
    if N == 0:
        return np.zeros(0, bool)
    P = 1 << max(N - 1, 1).bit_length()   # the JAX package's pow2 buckets
    if P != N:
        roots = np.concatenate([roots, np.zeros((P - N, k), np.uint8)])
    cand = np.zeros((P, 4, k), np.uint8)
    cand[:, :, :k - 1] = roots[:, None, 1:]
    cand[:, :, k - 1] = np.arange(4, dtype=np.uint8)[None, :]
    flat = torch.from_numpy(cand.reshape(P * 4, k)).to(cbf.device)
    rf, rr = nthash.hash_base(flat, k)
    present = cbf.contains(u64.umin(rf, rr)).cpu().numpy().reshape(P, 4)[:N]
    depths = ext.branch_depths(cbf, flat, (rf, rr), k, trim, width)
    depths = depths.cpu().numpy().reshape(P, 4)[:N]
    code, base = ext.successor_decision(depths, present, trim)
    return (code == ext.AMBI_OUT) | \
        ((code == ext.ACTIVE) & (base != expected))


def _trim_branch_kmers_batch(cbf, seqs: list, params) -> list:
    """trimBranchKmers (bloom-dbg.h:738-770) over a whole batch of
    contigs: drop a branch k-mer from a contig end if the edge into it
    is ambiguous, so adjacent unitigs overlap by exactly k-1 bases."""
    k = params.k
    idxs = [i for i, s in enumerate(seqs) if len(s) >= k + 1]
    out = list(seqs)
    if not idxs:
        return out
    roots = np.zeros((2 * len(idxs), k), np.uint8)
    expected = np.zeros(2 * len(idxs), np.int64)
    for j, i in enumerate(idxs):
        s = seqs[i]
        # forward-ambiguity of the first k-mer: expected next = s[k];
        # reverse-ambiguity of the last k-mer on the rc strand:
        # expected = comp(s[-k-1])
        roots[2 * j] = s[:k]
        expected[2 * j] = int(s[k])
        roots[2 * j + 1] = alphabet.revcomp_codes(s[-k:][None])[0]
        expected[2 * j + 1] = 3 - int(s[-k - 1])
    amb = _ambiguous_ends(cbf, roots, expected, params)
    for j, i in enumerate(idxs):
        s = seqs[i]
        lo = 1 if amb[2 * j] else 0
        hi = len(s) - (1 if amb[2 * j + 1] else 0)
        if hi - lo < k:
            out[i] = s[lo:lo + k] if len(s) >= k else s
        else:
            out[i] = s[lo:hi]
    return out


def _canonical_seq(seq: np.ndarray) -> bytes:
    rc = alphabet.revcomp_codes(seq)
    a, b = seq.tobytes(), rc.tobytes()
    return a if a <= b else b


class Assembler:
    """Streaming Bloom-DBG assembler with visited-filter dedupe."""

    def __init__(self, cbf, params: AssemblyParams,
                 counters: AssemblyCounters | None = None):
        self.cbf = cbf
        self.device = cbf.device
        # walks probe an exact hash table of the solid keys; bulk
        # classify queries stay on the filter's sort-join paths
        with trace.span("bloom.walk_table", device=True):
            self.wf = ext.walk_filter(cbf)
        self.params = params
        _, visited_size = bloom_ops.recommended_sizes(params.bloom_bytes)
        # the reference's visited filter is bits (1/9 of budget); one
        # byte per bit here, the same count of bits as the reference
        self.visited = bloom_ops.BitBloomFilter.create(
            max(visited_size * 8, 1024), params.k, params.num_hashes,
            device=self.device)
        self.contig_end_kmers: set[bytes] = set()
        self.counters = counters or AssemblyCounters()
        # per-read trace stream (the -T/--read-log role,
        # bloom-dbg.h:186-254,300-334): one row per read with outcome
        self.trace_out = None

    def _mark_assembled(self, seqs: list[np.ndarray]):
        if not seqs:
            return
        # one padded hash call over the separator-joined contigs (code 4
        # separators invalidate the joint windows)
        joined = np.concatenate(
            [x for s in seqs for x in (s, np.full(1, 4, np.uint8))])
        _, _, canon, valid = nthash.kmer_hashes_padded(
            joined, self.params.k, self.device)
        self.visited.insert(canon, valid)

    def _joined_hashes(self, seqs: list[np.ndarray]):
        """Hash many sequences in ONE padded call (separator joining).

        Returns (canon, valid, bounds) where bounds[i] = (lo, hi) is
        sequence i's window range in the joined arrays."""
        k = self.params.k
        parts, bounds, pos = [], [], 0
        sep = np.full(1, 4, np.uint8)
        for s in seqs:
            parts.extend((s, sep))
            bounds.append((pos, pos + max(len(s) - k + 1, 0)))
            pos += len(s) + 1
        joined = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        _, _, canon, valid = nthash.kmer_hashes_padded(joined, k,
                                                       self.device)
        return canon, valid, bounds

    def process_batch(self, batch: fastx.ReadBatch) -> list[Contig]:
        """Assemble one read batch; returns newly emitted contigs.  Each
        round is three spans: `bloom.classify`, `bloom.extend` (the
        walks) and `bloom.emit` (tips, trims, dedupe, the records and
        the visited marks)."""
        p = self.params
        k = p.k
        out: list[Contig] = []
        lengths = batch.lengths.copy()
        lengths[batch.num_reads:] = 0

        # adaptive seed cap: seed a few lanes first, let the visited
        # filter absorb their unitigs, and grow the cap while seeding
        # stays productive
        seed_cap = max(int(p.seeds_per_round), 1)
        for round_no in range(4096):
            with trace.span("bloom.classify", device=True):
                cls = _classify_batch(
                    self.cbf, self.visited, batch.codes, lengths, k,
                    p.fp_look_ahead, p.lookahead_width, wf=self.wf)
            if round_no == 0:
                self.counters.read_count += batch.num_reads
                self.counters.solid_reads += int(cls["all_solid"].sum())
                self.counters.blunt_reads += int(
                    (cls["blunt"] & cls["all_solid"]).sum())
                self.counters.visited_reads += int(
                    (cls["all_visited"] & cls["all_solid"]).sum())
                if self.trace_out is not None:
                    for i in range(batch.num_reads):
                        if not cls["all_solid"][i]:
                            outcome = "NOT_SOLID"
                        elif cls["blunt"][i]:
                            outcome = "BLUNT_END"
                        elif cls["all_visited"][i]:
                            outcome = "ALL_KMERS_VISITED"
                        else:
                            outcome = "EXTENDED"
                        self.trace_out.write(
                            f"{batch.ids[i]}\t{outcome}\n")
            rows_all = np.nonzero(cls["eligible"])[0]
            if not len(rows_all):
                break
            rows = rows_all[:seed_cap]
            trace.count("bloom.seeds", len(rows))
            starts = cls["first_unvisited"][rows]
            seeds = batch.codes[rows[:, None],
                                starts[:, None] + np.arange(k)[None, :]]
            with trace.span("bloom.extend", device=True):
                seqs, lstat, rstat = _extend_both(self.wf, seeds, p)
            with trace.span("bloom.emit", device=True):
                before = self.counters.contig_id
                emitted = self._emit(batch, rows, seqs, lstat, rstat, out)
                trace.count("bloom.contigs",
                            self.counters.contig_id - before)
            # cap growth: widen while seeding is productive (short walks,
            # or most seeds yielded distinct contigs)
            max_walk = max((len(s) for s in seqs), default=0)
            if max_walk < 4 * k + 2048 or \
                    len(emitted) * 2 >= len(rows):
                seed_cap = min(seed_cap * 4, 1 << 22)
            # fixpoint guard: every eligible read was seeded and nothing
            # was emitted or newly marked — re-classifying would repeat
            # the identical round (tips/redundant walks) forever
            if not emitted and len(rows) == len(rows_all):
                break
        return out

    def _emit(self, batch, rows, seqs, lstat, rstat,
              out: list[Contig]) -> list[np.ndarray]:
        """One round's contigs: drop tips, trim branch k-mers, dedupe
        (in the round and against the visited filter), append the new
        contigs to `out` and mark their k-mers visited; returns their
        sequences."""
        p = self.params
        k = p.k
        tips = _is_tip(
            np.asarray([len(s) - k + 1 for s in seqs]), lstat, rstat,
            p.trim_len)

        keep = [j for j in range(len(rows)) if not tips[j]]
        trimmed = _trim_branch_kmers_batch(
            self.wf, [seqs[j] for j in keep], p)
        trimmed_of = dict(zip(keep, trimmed))

        # candidate contigs of this round: one joined hash call for
        # the visited-redundancy windows (outputContig's dedupe,
        # bloom-dbg.h:566-599) and the coverage sums
        cands = [(j, i, trimmed_of[j]) for j, i in enumerate(rows)
                 if not tips[j] and len(trimmed_of.get(j, ())) >= k]
        if cands:
            canon, valid, bounds = self._joined_hashes(
                [seq for _, _, seq in cands])
            hits = self.visited.contains(canon, valid).cpu().numpy()
            covs = self.cbf.count(canon, valid).cpu().numpy()
            valid = valid.cpu().numpy()

        emitted: list[np.ndarray] = []
        seen_in_batch: set[bytes] = set()
        for idx, (j, i, seq) in enumerate(cands):
            key = _canonical_seq(seq)
            if key in seen_in_batch:
                continue
            seen_in_batch.add(key)
            lo, hi = bounds[idx]
            # redundancy check (outputContig, bloom-dbg.h:566-599)
            if len(seq) < k + p.fp_look_ahead - 1:
                k1 = _canonical_seq(seq[:k])
                k2 = _canonical_seq(seq[-k:])
                if k1 in self.contig_end_kmers and \
                        k2 in self.contig_end_kmers:
                    continue
                self.contig_end_kmers.add(k1)
                self.contig_end_kmers.add(k2)
            elif hits[lo:hi][valid[lo:hi]].all():
                continue
            emitted.append(seq)
            out.append(Contig(self.counters.contig_id,
                              alphabet.decode(seq),
                              int(covs[lo:hi].sum()),
                              batch.ids[i]))
            self.counters.contig_id += 1
            self.counters.bases_assembled += len(seq)
        self._mark_assembled(emitted)
        return emitted


def assemble(paths: Sequence[str] | str, params: AssemblyParams,
             out=sys.stdout, prebuilt_filter=None, device="cuda",
             ) -> AssemblyCounters:
    """Full two-pass assembly: reads in, unitig FASTA out.

    Runs on `device` (default "cuda"; raises without a card unless
    device="cpu").  With params.checkpoint_dir set, progress is
    checkpointed every checkpoint_every reads and resumed on restart
    (BloomDBG/Checkpoint.h semantics) — also from a checkpoint the JAX
    package wrote.  prebuilt_filter skips pass 1.  The passes are the
    spans `bloom.pass1` and `bloom.pass2`; each batch's FASTA records
    are written inside an `io.fasta_write` span."""
    from . import checkpoint as ckpt

    dev = resolve_device(device)
    counters = AssemblyCounters()
    resume_reads = 0
    asm = None
    use_ckpt = params.checkpoint_dir and params.checkpoint_every > 0
    if use_ckpt and ckpt.exists(params.checkpoint_dir):
        cbf, visited, resume_reads, cstate = ckpt.load(
            params.checkpoint_dir, device=dev)
        asm = Assembler(cbf, params, counters)
        asm.visited = visited
        for key, val in cstate.items():
            if hasattr(counters, key):
                setattr(counters, key, val)
        if params.verbose:
            print(f"[bloom-dbg] resuming from checkpoint at "
                  f"{resume_reads} reads", file=sys.stderr)
    trace_f = None
    if getattr(params, "read_log", None):
        trace_f = open(params.read_log, "w")
        trace_f.write("read_id\toutcome\n")
    if asm is None and prebuilt_filter is not None:
        asm = Assembler(prebuilt_filter, params, counters)
    if asm is None:
        with trace.span("bloom.pass1", device=True) as pass1:
            cbf = load_filter(
                io_read_batches(paths, params.batch_size,
                                params.max_read_len, q=params.q),
                params, counters, device=dev)
        if params.verbose:
            print(f"[bloom-dbg] pass 1: {counters.kmers_loaded} k-mers from "
                  f"{counters.read_count} reads in {pass1.seconds:.1f}s",
                  file=sys.stderr)
        counters.read_count = 0
        asm = Assembler(cbf, params, counters)
    asm.trace_out = trace_f
    reads_seen = 0
    last_ckpt = resume_reads
    try:
        with trace.span("bloom.pass2", device=True) as pass2:
            for batch in io_read_batches(paths, params.batch_size,
                                         params.max_read_len, q=params.q):
                reads_seen += batch.num_reads
                if reads_seen <= resume_reads:
                    continue  # already processed before the checkpoint
                contigs = asm.process_batch(batch)
                with trace.span("io.fasta_write"):
                    for contig in contigs:
                        fastx.write_fasta(out, [(contig.header, contig.seq)])
                if params.verbose >= 2:
                    # progress cadence (bloom-dbg.h:998-1007)
                    print(f"[bloom-dbg] pass 2: {reads_seen} reads, "
                          f"{counters.contig_id} contigs, "
                          f"{counters.bases_assembled} bases "
                          f"({pass2.seconds:.1f}s)", file=sys.stderr,
                          flush=True)
                if use_ckpt and \
                        reads_seen - last_ckpt >= params.checkpoint_every:
                    if hasattr(out, "flush"):
                        out.flush()
                    ckpt.save(params.checkpoint_dir, asm.cbf, asm.visited,
                              reads_seen, dataclasses_dict(counters))
                    last_ckpt = reads_seen
    finally:
        if trace_f is not None:
            trace_f.close()
    if use_ckpt:
        ckpt.remove(params.checkpoint_dir)
    if params.verbose:
        print(f"[bloom-dbg] pass 2: {counters.contig_id} contigs, "
              f"{counters.bases_assembled} bases in {pass2.seconds:.1f}s",
              file=sys.stderr)
    return counters


def dataclasses_dict(c: AssemblyCounters) -> dict:
    return dataclasses.asdict(c)
