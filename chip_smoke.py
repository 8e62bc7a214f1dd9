#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (abyss_tpu_torch) on one GPU.

    python3 chip_smoke.py          # one card, no arguments

Phases, each printing one JSON line:

  header  the card's name and power limit (nvidia-smi);
  build   build the CUDA kernels from the sources in this checkout, one
          nvcc process per source, all at once;
  kernel  the ntHash kernel against its plain PyTorch version on the
          card, bit for bit, with timings, on the main path's batch shape
          ([4096, 512] codes);
  parity  the port's bloom-dbg on the GPU and on the CPU writes the same
          FASTA bytes on a small genome with repeats and errors;
  main    the port's main path at real size: `bloom_dbg.assemble` on a
          4.6 Mbp genome with 12 exact 700 bp repeats, 613,333 pairs of
          150 bp reads (40x, substitution error 0.005), k=31, the CLI
          defaults; the kernels' launch counts are reset just before and
          read just after, pass 2's time is split by function, and the
          contigs are checked against the genome.  Then the walk and
          look-ahead kernels against their plain versions, bit for bit,
          with timings, in the walk table that run built: the walk on
          4096 lanes seeded from the first k-mers of its first batch of
          reads, with its 1024-step budget; the look-ahead on the 4 branch
          roots of each walked lane's head.

Then one `kernels` JSON line (each kernel's launches on the main path,
error against its plain version, times and bound), and as the last line
{"ok": true, "device": {...}}.  Any failed check exits non-zero before
the last line.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero at once.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
INT_OPS_PER_S = 67e12           # H100 SXM non-tensor 32-bit rate
NTHASH_OPS_PER_WINDOW = 40      # one roll: 2 split-rotations, 6 xor, ...
# one walk step: 8 rolls, 8 splitmix64 finalizers, 64 slot compares
WALK_OPS_PER_STEP = 400
WALK_BYTES_PER_STEP = 8 * 64 + 2  # 8 probed 64-byte windows, 2 buf bases
BRANCH_OPS_PER_PROBE = 50         # a roll, a splitmix64, 8 slot compares
# stage 1 alone breaks unitigs at every recurrent read error: the JAX
# package's bloom-dbg covers 0.834 (200 kbp) and 0.860 (1 Mbp) of the
# genome with contigs >= 500 bp on this sampler's reads (PERF.md), the
# same FASTA as this port's
MIN_COVER_500 = 0.8
# contigs >= 500 bp that are not exact genome substrings, each ending in
# a k-mer that carries a read error; the 4.6 Mbp run writes one
MAX_NOT_SUBSTRING_500 = 1


class SmokeError(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def median_ms(fn, reps: int, flush=None) -> float:
    """Median device time of fn() over reps runs, CUDA events around each
    run; `flush` (if given) runs before each, outside the timed span."""
    import torch
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_header() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return dict(phase="header", nvidia_smi=line,
                torch=torch.__version__, cuda=torch.version.cuda,
                device=torch.cuda.get_device_name(0))


def phase_build() -> dict:
    from abyss_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.build_all()
    notes = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in kernels.build_logs.items()}
    return dict(phase="build", kernels=sorted(kernels.build_seconds),
                seconds=time.perf_counter() - t0,
                per_kernel_s=kernels.build_seconds, ptxas=notes)


def _smoke_codes(B: int, L: int, seed: int):
    """uint8 [B, L] reads from a seed: random bases, ~0.5% N codes,
    rows padded (code 4) after a random length, a few empty rows."""
    import numpy as np
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.005] = 4
    lengths = rng.integers(20, L + 1, size=B)
    lengths[rng.random(B) < 0.01] = 0
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
    return codes


def _max_abs_err(a, b) -> int:
    """Largest |a - b| over two int64 tensors read as uint64 words
    (exact, in Python ints); 0 when bit-identical."""
    diff = (a != b).nonzero()
    if not len(diff):
        return 0
    from abyss_tpu_torch import u64
    av = u64.to_numpy(a[tuple(diff.T)]).tolist()
    bv = u64.to_numpy(b[tuple(diff.T)]).tolist()
    return max(abs(x - y) for x, y in zip(av, bv))


def phase_kernel(B: int = 4096, L: int = 512) -> tuple[dict, dict]:
    """The ntHash kernel against kmer_hashes_plain on the card, at the
    main path's batch shape, for k = 31 and k = 25."""
    import torch
    from abyss_tpu_torch.ops import kernels, nthash
    dev = torch.device("cuda")
    codes = torch.from_numpy(_smoke_codes(B, L, seed=2024)).to(dev)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    res = {}
    for k in (31, 25):
        W = L - k + 1
        canon, valid, _, _ = kernels.nthash(codes, k)
        c2, v2, fwd, rev = kernels.nthash(codes, k, strands=True)
        pf, pr, pc, pv = nthash.kmer_hashes_plain(codes, k)
        torch.cuda.synchronize()
        check(torch.equal(valid, pv), f"k={k}: valid differs from plain")
        check(torch.equal(v2, pv), f"k={k}: valid (strands) differs")
        err = max(_max_abs_err(canon[pv], pc[pv]),
                  _max_abs_err(c2[pv], pc[pv]),
                  _max_abs_err(fwd[pv], pf[pv]),
                  _max_abs_err(rev[pv], pr[pv]))
        check(err == 0, f"k={k}: canon/fwd/rev differ from plain where "
                        f"valid (max abs err {err})")
        all_equal = bool(torch.equal(canon, pc) and torch.equal(fwd, pf)
                         and torch.equal(rev, pr))
        ms = median_ms(lambda: kernels.nthash(codes, k), 30,
                       flush=lambda: flush_buf.fill_(1))
        plain_ms = median_ms(lambda: nthash.kmer_hashes_plain(codes, k), 10,
                             flush=lambda: flush_buf.fill_(1))
        nbytes = B * L + B * W * (8 + 1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = B * W * NTHASH_OPS_PER_WINDOW / INT_OPS_PER_S * 1e3
        res[k] = dict(k=k, shape=[B, L], max_abs_err=err,
                      equal_at_invalid_too=all_equal, ms=ms,
                      plain_ms=plain_ms, bytes=nbytes,
                      bound_ms=max(bytes_ms, ops_ms),
                      bound_by="bytes" if bytes_ms >= ops_ms else
                      "operations",
                      gbytes_per_s=nbytes / (ms * 1e-3) / 1e9)
    del flush_buf
    # the main path's shape is k = 31
    return dict(phase="kernel", kernel="nthash", results=list(res.values())
                ), res[31]


def phase_walk(wf, paths, params, P: int = 4096) -> tuple:
    """The walk kernel against fast_extend_plain on the card, in the main
    path's walk table `wf`: P lanes seeded with the first k-mer of each
    read of its first batch, with the main path's k, buffer and step
    budget (k + chunk bases, chunk steps)."""
    import numpy as np
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.io import read_batches
    from abyss_tpu_torch.ops import kernels
    dev = wf.tab.device
    k, steps = params.k, params.chunk
    first = next(iter(read_batches(paths, P, params.max_read_len)))
    st0 = ext.init_state(np.ascontiguousarray(first.codes[:, :k]), k + steps,
                         k, dev)
    fields = ("buf", "length", "f", "r", "status", "has_prev")

    def fresh():
        return st0._replace(**{n: getattr(st0, n).clone() for n in fields})

    kern = fresh()
    kernels.walk(wf.tab, kern.buf, kern.length, kern.f, kern.r, kern.status,
                 kern.seed_canon, kern.has_prev, k, steps)
    plain = ext.fast_extend_plain(wf, fresh(), k, steps)
    torch.cuda.synchronize()
    err = max(_max_abs_err(kern.f, plain.f), _max_abs_err(kern.r, plain.r),
              int((kern.length - plain.length).abs().max()),
              int((kern.status.long() - plain.status.long()).abs().max()),
              int((kern.buf.long() - plain.buf.long()).abs().max()),
              int((kern.has_prev != plain.has_prev).sum()))
    check(err == 0, f"walk kernel differs from fast_extend_plain "
                    f"(max abs err {err})")
    status = plain.status.cpu().numpy()
    check(len(set(status.tolist())) >= 3, "walk check: too few lane outcomes")
    # steps the lanes took: their advances, plus the step that stopped them
    adv = (plain.length - st0.length).cpu().numpy()
    lane_steps = int((adv + (status != ext.ACTIVE)).sum())
    nbytes = (lane_steps * WALK_BYTES_PER_STEP + int(adv.sum())
              + 2 * P * (8 * 3 + 2) + P * 8)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = lane_steps * WALK_OPS_PER_STEP / INT_OPS_PER_S * 1e3
    work = fresh()
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def reset():
        for n in fields:
            getattr(work, n).copy_(getattr(st0, n))
        flush_buf.fill_(1)

    ms = median_ms(lambda: kernels.walk(
        wf.tab, work.buf, work.length, work.f, work.r, work.status,
        work.seed_canon, work.has_prev, k, steps), 10, flush=reset)
    plain_ms = median_ms(lambda: ext.fast_extend_plain(wf, work, k, steps),
                         3, flush=reset)
    row = dict(phase="kernel", kernel="walk", lanes=P, buf=k + steps, k=k,
               max_steps=steps,
               table_slots=int(wf.tab.shape[0]), lane_steps=lane_steps,
               outcomes={ext.STATUS_NAMES[int(c)]: int((status == c).sum())
                         for c in np.unique(status)},
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return row, (wf, plain, k)


def phase_branch(wf, walked, k: int, width: int = 16) -> dict:
    """The branch kernel against branch_depths_plain on the card: the 4
    forward branch roots of each walked lane's head k-mer (as _resolve
    builds them for a fork), searched to depth trim = k with the main
    path's frontier width."""
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.ops import kernels, nthash
    heads, _ = ext._stuck_heads(walked.buf, k, walked.length)
    P = heads.shape[0]
    roots = torch.cat([heads[:, None, 1:].expand(P, 4, k - 1),
                       torch.arange(4, dtype=torch.uint8, device=heads.device)
                       [None, :, None].expand(P, 4, 1)], dim=2)
    roots = roots.reshape(4 * P, k).contiguous()
    f0, r0 = nthash.hash_base(roots, k)
    probes = torch.zeros(4 * P, dtype=torch.int64, device=roots.device)
    depth = kernels.branch(wf.tab, roots, f0, r0, k, k, width, probes)
    plain = ext.branch_depths_plain(wf, roots, (f0, r0), k, k, width)
    torch.cuda.synchronize()
    err = int((depth.long() - plain.long()).abs().max())
    check(err == 0, f"branch kernel differs from branch_depths_plain "
                    f"(max abs err {err})")
    check(len(set(plain.tolist())) >= 3, "branch check: too few depths")
    n_probes = int(probes.sum())
    N = 4 * P
    nbytes = n_probes * 64 + N * (k + 8 + 8 + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_probes * BRANCH_OPS_PER_PROBE / INT_OPS_PER_S * 1e3
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                            device=roots.device)
    ms = median_ms(lambda: kernels.branch(wf.tab, roots, f0, r0, k, k,
                                          width), 10,
                   flush=lambda: flush_buf.fill_(1))
    plain_ms = median_ms(lambda: ext.branch_depths_plain(
        wf, roots, (f0, r0), k, k, width), 3,
        flush=lambda: flush_buf.fill_(1))
    row = dict(phase="kernel", kernel="branch", roots=N, k=k, max_depth=k,
               width=width, probes=n_probes,
               depth_hist={int(d): int(n) for d, n in zip(
                   *torch.unique(plain, return_counts=True))},
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return row


class Spans:
    """Host seconds of a few functions of pass 2, each net of the wrapped
    functions it calls (a stack of open spans), with a device sync at
    the end of each span so device work lands in the span that queued
    it.  Every wrapped function ends in a device-to-host copy anyway, so
    the syncs add little."""

    def __init__(self):
        self.seconds: dict = {}
        self.calls: dict = {}
        self._open: list = []
        self._undo: list = []

    def wrap(self, mod, name: str) -> None:
        import torch
        fn = getattr(mod, name)

        def span(*a, **kw):
            t0 = time.perf_counter()
            self._open.append(0.0)
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                inner = self._open.pop()
                self.seconds[name] = self.seconds.get(name, 0.0) + dt - inner
                self.calls[name] = self.calls.get(name, 0) + 1
                if self._open:
                    self._open[-1] += dt

        setattr(mod, name, span)
        self._undo.append((mod, name, fn))

    def restore(self) -> None:
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo.clear()


def _write_fastq(path: str, ids: list, reads, qual: bytes) -> None:
    import numpy as np
    from abyss_tpu_torch.core import alphabet
    ascii_ = alphabet.CODE_TO_ASCII[np.minimum(reads, 4)]
    with open(path, "wb") as f:
        for rid, row in zip(ids, ascii_):
            f.write(b"@" + rid + b"\n" + row.tobytes() + b"\n+\n" + qual
                    + b"\n")


def simulate_reads(genome_codes, n_pairs: int, read_len: int,
                   fragment_mean: float, fragment_sd: float,
                   error_rate: float, seed: int, path1: str, path2: str):
    """Vectorised wgsim-style paired-end sampler with the parameters of
    sim.simulate_paired_reads (FR pairs, substitution errors), writing
    two FASTQ files.  Its random stream differs from that function's."""
    import numpy as np
    from abyss_tpu_torch.core import alphabet
    rng = np.random.default_rng(seed)
    G = len(genome_codes)
    frag = np.clip(rng.normal(fragment_mean, fragment_sd, n_pairs),
                   read_len + 2, G).astype(np.int64)
    start = (rng.random(n_pairs) * (G - frag + 1)).astype(np.int64)
    pos = np.arange(read_len)[None, :]
    r1 = genome_codes[start[:, None] + pos]
    r2 = alphabet.revcomp_codes(
        genome_codes[(start + frag - read_len)[:, None] + pos])
    for r in (r1, r2):
        errs = rng.random(r.shape) < error_rate
        r[errs] = (r[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    qual = b"I" * read_len
    _write_fastq(path1, [f"sim_{i}/1".encode() for i in range(n_pairs)],
                 r1, qual)
    _write_fastq(path2, [f"sim_{i}/2".encode() for i in range(n_pairs)],
                 r2, qual)


def _assemble(paths, params, device, timings=None) -> str:
    from abyss_tpu_torch.dbg import bloom_dbg
    out = io.StringIO()
    bloom_dbg.assemble(paths, params, out=out, device=device,
                       timings=timings)
    return out.getvalue()


def phase_parity(tmp: str) -> dict:
    """GPU and CPU runs of the port write the same FASTA bytes."""
    from abyss_tpu_torch import sim
    from abyss_tpu_torch.dbg.params import AssemblyParams
    genome = sim.genome_with_repeats(20000, seed=5, n_repeats=4,
                                     repeat_len=500)
    reads = sim.simulate_paired_reads(genome, coverage=30, read_len=100,
                                      error_rate=0.01, seed=6)
    paths = [os.path.join(tmp, "p1.fq"), os.path.join(tmp, "p2.fq")]
    reads.write_fastq(*paths)
    params = AssemblyParams(k=25, bloom_bytes=1 << 22, batch_size=1024,
                            max_read_len=128)
    t0 = time.perf_counter()
    gpu = _assemble(paths, params, "cuda")
    t1 = time.perf_counter()
    cpu = _assemble(paths, params, "cpu")
    t2 = time.perf_counter()
    check(gpu == cpu, "GPU and CPU FASTA differ on the parity genome")
    check(gpu.count(">") > 0, "parity genome assembled no contig")
    return dict(phase="parity", genome_bp=len(genome),
                pairs=len(reads.reads1), contigs=gpu.count(">"),
                fasta_bytes=len(gpu), identical=True,
                gpu_s=t1 - t0, cpu_s=t2 - t1)


def _n50(lengths) -> int:
    tot = sum(lengths)
    acc = 0
    for n in sorted(lengths, reverse=True):
        acc += n
        if 2 * acc >= tot:
            return n
    return 0


def phase_main(tmp: str) -> tuple:
    """The main path at full size; returns its row and (walk filter,
    read paths, params) for the walk and look-ahead kernel checks."""
    import torch
    from abyss_tpu_torch import sim
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.dbg.params import AssemblyParams
    from abyss_tpu_torch.io import fastx
    from abyss_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    genome_bp = 4_600_000
    genome = sim.genome_with_repeats(genome_bp, seed=7, n_repeats=12,
                                     repeat_len=700)
    codes = alphabet.encode(genome)
    read_len, coverage = 150, 40.0
    n_pairs = int(genome_bp * coverage / (2 * read_len))
    paths = [os.path.join(tmp, "r1.fq"), os.path.join(tmp, "r2.fq")]
    simulate_reads(codes, n_pairs, read_len, 500, 50, 0.005, 11, *paths)
    sim_s = time.perf_counter() - t0
    log(f"main: {genome_bp} bp genome, {n_pairs} pairs simulated in "
        f"{sim_s:.1f}s")
    # the CLI defaults: batch 4096, max read length 512
    params = AssemblyParams(k=31)
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    from abyss_tpu_torch.dbg import bloom_dbg
    from abyss_tpu_torch.dbg import extend as ext
    spans = Spans()
    for mod, name in ((bloom_dbg, "_classify_batch"),
                      (bloom_dbg, "_trim_branch_kmers_batch"),
                      (ext, "extend_forward"), (ext, "fast_extend"),
                      (ext, "_resolve"), (ext, "branch_depths")):
        spans.wrap(mod, name)
    # keep the walk table the run builds, for the kernel checks after it
    walk_filters = []
    walk_filter = ext.walk_filter

    def keep_walk_filter(cbf):
        walk_filters.append(walk_filter(cbf))
        return walk_filters[-1]

    ext.walk_filter = keep_walk_filter
    kernels.reset_launches()
    try:
        fasta = _assemble(paths, params, "cuda", timings)
    finally:
        launches = dict(kernels.launches)
        spans.restore()
        ext.walk_filter = walk_filter
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    seqs = [r.seq for r in fastx.read_fastx(io.StringIO(fasta))]
    check(len(seqs) > 0, "main path assembled no contig")
    rc = alphabet.revcomp(genome)
    long_ = [s for s in seqs if len(s) >= 500]
    strict = sum(1 for s in long_ if s not in genome and s not in rc)
    # stage 1 may end a contig in a k-mer that holds a read error (the
    # JAX package writes the same contigs): hold the rest to the genome
    k = params.k
    wrong = sum(1 for s in long_
                if s[k:-k] not in genome and s[k:-k] not in rc)
    cover = sum(len(s) for s in long_) / genome_bp
    lengths = [len(s) for s in seqs]
    kmers = int(n_pairs * 2 * (read_len - params.k + 1))
    row = dict(phase="main", genome_bp=genome_bp, pairs=n_pairs, k=params.k,
               batch_size=params.batch_size,
               max_read_len=params.max_read_len, simulate_s=sim_s,
               pass1_s=timings["pass1_s"],
               pass1_kmers_per_s=kmers / timings["pass1_s"],
               pass2_s=timings["pass2_s"],
               pass2_split_s=spans.seconds, pass2_calls=spans.calls,
               contigs=len(seqs), total_bases=sum(lengths),
               n50=_n50(lengths), max_contig=max(lengths),
               contigs_500=len(long_), cover_500=cover,
               not_substring_500=strict, wrong_500_inside_ends=wrong,
               fasta_sha256=hashlib.sha256(fasta.encode()).hexdigest(),
               peak_mem_bytes=peak, launches=launches)
    emit(row)
    check(wrong == 0, f"{wrong} contigs >= 500 bp are not genome "
                      f"substrings even without their end k-mers")
    check(strict <= MAX_NOT_SUBSTRING_500,
          f"{strict} contigs >= 500 bp are not genome substrings, more "
          f"than {MAX_NOT_SUBSTRING_500}")
    check(cover >= MIN_COVER_500, f"contigs >= 500 bp cover {cover:.4f} of "
                                  f"the genome, below {MIN_COVER_500}")
    check(len(walk_filters) == 1, "the main path built no single walk table")
    return row, (walk_filters[0], paths, params)


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "abyss_tpu_torch")):
        log("abyss_tpu_torch/ not found beside this script: run it from a "
            "checkout of the repository")
        return 2
    try:
        import torch
    except ImportError:
        log("torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke run needs one GPU")
        return 2
    sys.path.insert(0, REPO)

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO)
    try:
        emit(phase_header())
        emit(phase_build())
        row, kern = phase_kernel()
        emit(row)
        emit(phase_parity(tmp))
        main_row, (wf, paths, params) = phase_main(tmp)
        walk, walked = phase_walk(wf, paths, params)
        emit(walk)
        branch = phase_branch(*walked)
        emit(branch)
        del wf, walked
    except SmokeError as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # no single PyTorch call computes ntHash, the walk or the look-ahead:
    # library_ms is null for each.  walk and branch replace jnp loops of
    # abyss_tpu/dbg/extend.py, not Pallas kernels
    emit({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=main_row["launches"][name],
        max_abs_err=rec["max_abs_err"], ms=rec["ms"],
        plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], library_ms=None)
        for name, source, replaces, rec in (
            ("nthash", "abyss_tpu_torch/csrc/nthash.cu",
             "abyss_tpu/ops/pallas_kernels.py:191", kern),
            ("walk", "abyss_tpu_torch/csrc/walk.cu",
             "abyss_tpu/dbg/extend.py:164", walk),
            ("branch", "abyss_tpu_torch/csrc/walk.cu",
             "abyss_tpu/dbg/extend.py:243", branch))]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
