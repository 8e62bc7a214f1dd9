#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (abyss_tpu_torch) on one GPU.

    python3 chip_smoke.py          # one card, no arguments

Phases, each printing one JSON line:

  header  the card's name and power limit (nvidia-smi);
  build   build the CUDA kernels from the sources in this checkout, one
          nvcc process per source, all at once;
  kernel  the ntHash kernel against its plain PyTorch version on the
          card, bit for bit, with timings, on a synthetic batch of the
          main path's batch shape ([4096, 512] codes);
  parity  the port's bloom-dbg on the GPU and on the CPU writes the same
          FASTA bytes on a small genome with repeats and errors;
  main    the port's main path at real size: `bloom_dbg.assemble` on a
          4.6 Mbp genome with 12 exact 700 bp repeats, 613,333 pairs of
          150 bp reads (40x, substitution error 0.005), k=31, the CLI
          defaults; the kernels' launch counts are reset just before and
          read just after, pass 2's time is split by function, and the
          contigs are checked against the genome; every ntHash launch
          is recorded by shape.  Then the ntHash kernel at every shape
          the run launched (the histogram, each shape timed by a CUDA
          graph of launches and checked against the plain version, and
          pass-1 batch 150 of the run).  Then the walk and
          look-ahead kernels against their plain versions, bit for bit,
          with timings, in the walk table that run built: the walk on
          4096 lanes seeded from the first k-mers of its first batch of
          reads, with its 1024-step budget; the look-ahead on the 4 branch
          roots of each walked lane's head.
  bloom   the same reads and checks through the counting Bloom filter
          (filter_mode="bloom") at the reference's E. coli budget of
          2 GiB (2^30 counters); the launch counts are reset and read
          around it as around main.  Then:
  scatter the scatter-max kernel against its plain version, bit for bit,
          with timings, replaying one real pass-1 batch of that run on
          the counters as they stood before it;
          the walk and look-ahead kernels' Bloom variants against their
          plain versions in that run's counting filter, seeded as above;
  tool    `bloom build -t counting -k 31 -b 1G` (the abyss-bloom CLI)
          on the same reads, with its launch counts, and its counters
          byte-identical to the bloom phase's pass-1 filter.

Then one `kernels` JSON line (each kernel's launches on the path that
runs it, error against its plain version, times and bound; for ntHash
also its times at three shapes and launches x (ms - bound_ms) summed
over every shape of the main run), and as the last line
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
# H100 SXM 32-bit integer rate: 132 SMs x 64 INT32 lanes (4 partitions of
# 16, NVIDIA H100 Tensor Core GPU Architecture white paper) x the 1.98 GHz
# boost clock that its 67 TFLOP/s float32 (132 x 128 lanes x 2) implies
INT_OPS_PER_S = 132 * 64 * 67e12 / (132 * 128 * 2)
NTHASH_OPS_PER_WINDOW = 40      # one roll: 2 split-rotations, 6 xor, ...
# one walk step: 8 rolls, 8 splitmix64 finalizers, 64 slot compares
WALK_OPS_PER_STEP = 400
WALK_BYTES_PER_STEP = 8 * 64 + 2  # 8 probed 64-byte windows, 2 buf bases
BRANCH_OPS_PER_PROBE = 50         # a roll, a splitmix64, 8 slot compares
# In a counting Bloom filter a solidity test reads 1 to H counters at
# hashed places: at least one 32-byte sector each
WALK_BLOOM_BYTES_PER_STEP = 8 * 32 + 2
BRANCH_BLOOM_BYTES_PER_PROBE = 32
SECTOR_BYTES = 32                 # a random byte update reads + writes one
# the reference README's E. coli run, "k=96 B=2G" (SURVEY.md:537): 8/9 of
# it gives 2^30 one-byte counters
BLOOM_BYTES = 2 << 30
BLOOM_TOOL_SIZE = "1G"            # bloom build -b: the same 2^30 counters
CAPTURE_BATCH = 150               # the pass-1 batch the replays take
GRAPH_BYTES = 512 << 20           # outputs a timing graph may hold
# the codes of each ntHash launch shape of the main run (.gitignore
# lists the directory)
SHAPES_FILE = os.path.join(REPO, ".chip_smoke_shapes", "nthash_codes.pt")
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


def graph_ms(fn, reps: int) -> float:
    """Device ms of one fn() call: CUDA events around a replay of a CUDA
    graph of `reps` calls, over reps (median of 5 replays).  The replay
    holds no host work, so a launch of a few microseconds is timed
    without its wrapper's host time.  Every call's outputs are kept alive
    through the capture, so each call writes memory of its own, not a
    block the graph's pool handed back (and L2 still held); the inputs
    stay in L2 from one call to the next."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for _ in range(reps):
            outs.append(fn())
    graph.replay()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph, outs
    times.sort()
    return times[len(times) // 2]


def _windows_with_bases(codes, k: int) -> int:
    """Windows of codes [B, L] that hold at least one base (code < 4):
    the ones the ntHash kernel does arithmetic for."""
    import torch
    real = (codes < 4).to(torch.int32)
    P = torch.nn.functional.pad(real.cumsum(dim=1, dtype=torch.int32), (1, 0))
    W = codes.shape[1] - k + 1
    return int(((P[:, k:] - P[:, :W]) > 0).sum())


def nthash_bound(codes, k: int, strands: bool) -> dict:
    """Bytes (codes read once; canon, valid and, with strands, fwd and
    rev written once) and operations (NTHASH_OPS_PER_WINDOW for each
    window that holds a base) of one launch, and the bound they give."""
    B, L = codes.shape
    W = L - k + 1
    nbytes = B * L + B * W * (8 + 1 + (16 if strands else 0))
    windows = _windows_with_bases(codes, k)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = windows * NTHASH_OPS_PER_WINDOW / INT_OPS_PER_S * 1e3
    return dict(bytes=nbytes, windows_with_bases=windows,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def nthash_check(codes, k: int) -> tuple[int, bool]:
    """The ntHash kernel against kmer_hashes_plain on codes, with and
    without the strand outputs: (max abs err where valid, whether every
    output also equals the plain one at invalid windows).  Fails unless
    valid is equal and the error is 0."""
    import torch
    from abyss_tpu_torch.ops import kernels, nthash
    canon, valid, _, _ = kernels.nthash(codes, k)
    c2, v2, fwd, rev = kernels.nthash(codes, k, strands=True)
    pf, pr, pc, pv = nthash.kmer_hashes_plain(codes, k)
    torch.cuda.synchronize()
    shape = list(codes.shape)
    check(torch.equal(valid, pv), f"{shape} k={k}: valid differs from plain")
    check(torch.equal(v2, pv), f"{shape} k={k}: valid (strands) differs")
    err = max(_max_abs_err(canon[pv], pc[pv]), _max_abs_err(c2[pv], pc[pv]),
              _max_abs_err(fwd[pv], pf[pv]), _max_abs_err(rev[pv], pr[pv]))
    check(err == 0, f"{shape} k={k}: canon/fwd/rev differ from plain where "
                    f"valid (max abs err {err})")
    all_equal = bool(torch.equal(canon, pc) and torch.equal(c2, pc)
                     and torch.equal(fwd, pf) and torch.equal(rev, pr))
    return err, all_equal


def _graph_reps(codes, k: int, strands: bool) -> int:
    """Launches a timing graph holds: GRAPH_BYTES of outputs, 10-200."""
    B, L = codes.shape
    out = B * (L - k + 1) * (9 + (16 if strands else 0))
    return max(10, min(200, GRAPH_BYTES // max(out, 1)))


def phase_kernel(B: int = 4096, L: int = 512) -> tuple[dict, dict]:
    """The ntHash kernel against kmer_hashes_plain on the card, on a
    synthetic [4096, 512] batch of reads of random lengths, for k = 31
    and k = 25: `ms` by graph_ms, `flush_ms` by CUDA events around each
    launch after a 128 MiB write that flushes L2 (the kernel's earlier
    timing; it also counts any wait for the wrapper's host work)."""
    import torch
    from abyss_tpu_torch.ops import kernels, nthash
    dev = torch.device("cuda")
    codes = torch.from_numpy(_smoke_codes(B, L, seed=2024)).to(dev)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    res = {}
    for k in (31, 25):
        err, all_equal = nthash_check(codes, k)
        flush_ms = median_ms(lambda: kernels.nthash(codes, k), 30,
                             flush=lambda: flush_buf.fill_(1))
        plain_ms = median_ms(lambda: nthash.kmer_hashes_plain(codes, k), 10,
                             flush=lambda: flush_buf.fill_(1))
        ms = graph_ms(lambda: kernels.nthash(codes, k),
                      _graph_reps(codes, k, False))
        res[k] = dict(name="synthetic", k=k, shape=[B, L], strands=False,
                      max_abs_err=err, equal_at_invalid_too=all_equal, ms=ms,
                      flush_ms=flush_ms, plain_ms=plain_ms,
                      **nthash_bound(codes, k, False))
        res[k]["gbytes_per_s"] = res[k]["bytes"] / (ms * 1e-3) / 1e9
    del flush_buf
    # the main path's shape is k = 31
    return dict(phase="kernel", kernel="nthash", results=list(res.values())
                ), res[31]


class NthashShapes:
    """Records every ntHash launch of a run by (pass, B, L, k, strands),
    and keeps the codes of the first launch of each key and of pass-1
    batch CAPTURE_BATCH, for timing at the shapes the run launched.
    Pass 1 is the time inside bloom_dbg.load_filter."""

    def __init__(self):
        self.hist: dict = {}
        self.codes: dict = {}
        self.pass1_batch = None
        self._pass1 = False
        self._calls1 = 0

    def __enter__(self):
        from abyss_tpu_torch.dbg import bloom_dbg
        from abyss_tpu_torch.ops import kernels
        self._nthash, self._load = kernels.nthash, bloom_dbg.load_filter

        def nthash(codes, k, strands=False):
            key = ("pass1" if self._pass1 else "pass2", *codes.shape, k,
                   bool(strands))
            self.hist[key] = self.hist.get(key, 0) + 1
            if key not in self.codes:
                self.codes[key] = codes.clone()
            if self._pass1:
                if self._calls1 == CAPTURE_BATCH:
                    self.pass1_batch = codes.clone()
                self._calls1 += 1
            return self._nthash(codes, k, strands)

        def load_filter(*a, **kw):
            self._pass1 = True
            try:
                return self._load(*a, **kw)
            finally:
                self._pass1 = False

        kernels.nthash, bloom_dbg.load_filter = nthash, load_filter
        return self

    def __exit__(self, *exc):
        from abyss_tpu_torch.dbg import bloom_dbg
        from abyss_tpu_torch.ops import kernels
        kernels.nthash, bloom_dbg.load_filter = self._nthash, self._load


def phase_nthash_shapes(rec: NthashShapes, synthetic: dict) -> tuple:
    """The ntHash kernel at every shape the main run launched, each on
    the codes of its first launch: bit for bit against its plain version,
    graph_ms, bound, and launches x (ms - bound) summed over the run.
    Returns the row and the kernels line's three shapes: the synthetic
    batch, pass-1 batch CAPTURE_BATCH and the most frequent pass-2
    shape."""
    from abyss_tpu_torch.ops import kernels, nthash
    check(rec.pass1_batch is not None, f"pass 1 launched ntHash fewer than "
                                      f"{CAPTURE_BATCH + 1} times")
    rows = []
    for key, n in sorted(rec.hist.items(), key=lambda kv: -kv[1]):
        pass_, B, L, k, strands = key
        codes = rec.codes[key]
        err, all_equal = nthash_check(codes, k)
        rows.append(dict(
            name=key[0], shape=[B, L], k=k, strands=strands, launches=n,
            max_abs_err=err, equal_at_invalid_too=all_equal,
            ms=graph_ms(lambda: kernels.nthash(codes, k, strands),
                        _graph_reps(codes, k, strands)),
            plain_ms=median_ms(lambda: nthash.kmer_hashes_plain(codes, k), 3),
            **nthash_bound(codes, k, strands)))
    gap = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows)
    codes, k = rec.pass1_batch, synthetic["k"]
    err, all_equal = nthash_check(codes, k)
    batch = dict(name=f"pass1 batch {CAPTURE_BATCH}", shape=list(codes.shape),
                 k=k, strands=False, max_abs_err=err,
                 equal_at_invalid_too=all_equal,
                 ms=graph_ms(lambda: kernels.nthash(codes, k),
                             _graph_reps(codes, k, False)),
                 plain_ms=median_ms(lambda: nthash.kmer_hashes_plain(codes, k),
                                    5),
                 launches=sum(r["launches"] for r in rows
                              if r["name"] == "pass1"),
                 **nthash_bound(codes, k, False))
    top = next(r for r in rows if r["name"] == "pass2")
    same = [r["launches"] for r in rows
            if r["shape"] == synthetic["shape"] and r["k"] == k]
    synth = dict(synthetic, launches=sum(same))
    keep = ("name", "shape", "k", "strands", "launches", "max_abs_err",
            "equal_at_invalid_too", "ms", "flush_ms", "plain_ms", "bound_ms",
            "bound_by")
    shapes = [{n: r[n] for n in keep if n in r} for r in (synth, batch, top)]
    row = dict(phase="kernel", kernel="nthash_shapes",
               launches=sum(r["launches"] for r in rows),
               gap_ms=gap, histogram=rows, pass1_batch=batch)
    # the same codes, for scripts/nthash_shapes_ab.py to time other
    # checkouts' kernels on
    import torch
    os.makedirs(os.path.dirname(SHAPES_FILE), exist_ok=True)
    torch.save(dict(
        shapes=[dict(key=key, launches=n, codes=rec.codes[key].cpu())
                for key, n in rec.hist.items()],
        pass1_batch=rec.pass1_batch.cpu()), SHAPES_FILE)
    return row, shapes, gap


def _solid(wf) -> tuple:
    """(what the walk kernels probe, kernel-name suffix) for a path's
    walk filter: a ProbeSet's table, or a counting Bloom filter."""
    return (wf.tab, "") if hasattr(wf, "tab") else (wf, "_bloom")


def phase_walk(wf, paths, params, P: int = 4096) -> tuple:
    """The walk kernel against fast_extend_plain on the card, in a path's
    walk filter `wf` (the sorted path's walk table, or the Bloom path's
    counting filter): P lanes seeded with the first k-mer of each read
    of its first batch, with the path's k, buffer and step budget
    (k + chunk bases, chunk steps)."""
    import numpy as np
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.io import read_batches
    from abyss_tpu_torch.ops import kernels
    dev = wf.device
    solid, variant = _solid(wf)
    k, steps = params.k, params.chunk
    first = next(iter(read_batches(paths, P, params.max_read_len)))
    st0 = ext.init_state(np.ascontiguousarray(first.codes[:, :k]), k + steps,
                         k, dev)
    fields = ("buf", "length", "f", "r", "status", "has_prev")

    def fresh():
        return st0._replace(**{n: getattr(st0, n).clone() for n in fields})

    kern = fresh()
    kernels.walk(solid, kern.buf, kern.length, kern.f, kern.r, kern.status,
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
    per_step = WALK_BLOOM_BYTES_PER_STEP if variant else WALK_BYTES_PER_STEP
    nbytes = (lane_steps * per_step + int(adv.sum())
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
        solid, work.buf, work.length, work.f, work.r, work.status,
        work.seed_canon, work.has_prev, k, steps), 10, flush=reset)
    plain_ms = median_ms(lambda: ext.fast_extend_plain(wf, work, k, steps),
                         3, flush=reset)
    # the longest lane's steps: a chain of dependent probe rounds
    chain = int((adv + (status != ext.ACTIVE)).max())
    row = dict(phase="kernel", kernel="walk" + variant, lanes=P,
               buf=k + steps, k=k, max_steps=steps,
               filter_bytes=int(solid.numel() * solid.element_size()
                                if variant == "" else
                                solid.counters.numel()),
               lane_steps=lane_steps, chain_steps=chain,
               us_per_chain_step=ms * 1e3 / chain,
               grid_blocks=kernels.walk_blocks(P, k),
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
    path's frontier width, in the walk filter the lanes walked."""
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.ops import kernels, nthash
    solid, variant = _solid(wf)
    heads, _ = ext._stuck_heads(walked.buf, k, walked.length)
    P = heads.shape[0]
    roots = torch.cat([heads[:, None, 1:].expand(P, 4, k - 1),
                       torch.arange(4, dtype=torch.uint8, device=heads.device)
                       [None, :, None].expand(P, 4, 1)], dim=2)
    roots = roots.reshape(4 * P, k).contiguous()
    f0, r0 = nthash.hash_base(roots, k)
    probes = torch.zeros(4 * P, dtype=torch.int64, device=roots.device)
    depth = kernels.branch(solid, roots, f0, r0, k, k, width, probes)
    plain = ext.branch_depths_plain(wf, roots, (f0, r0), k, k, width)
    torch.cuda.synchronize()
    err = int((depth.long() - plain.long()).abs().max())
    check(err == 0, f"branch kernel differs from branch_depths_plain "
                    f"(max abs err {err})")
    check(len(set(plain.tolist())) >= 3, "branch check: too few depths")
    n_probes = int(probes.sum())
    N = 4 * P
    nbytes = n_probes * (BRANCH_BLOOM_BYTES_PER_PROBE if variant else 64) \
        + N * (k + 8 + 8 + 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_probes * BRANCH_OPS_PER_PROBE / INT_OPS_PER_S * 1e3
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                            device=roots.device)
    ms = median_ms(lambda: kernels.branch(solid, roots, f0, r0, k, k,
                                          width), 10,
                   flush=lambda: flush_buf.fill_(1))
    plain_ms = median_ms(lambda: ext.branch_depths_plain(
        wf, roots, (f0, r0), k, k, width), 3,
        flush=lambda: flush_buf.fill_(1))
    chain = int(plain.max())   # the deepest root's depth
    row = dict(phase="kernel", kernel="branch" + variant, roots=N, k=k,
               max_depth=k,
               width=width, probes=n_probes, chain_steps=chain,
               us_per_chain_step=ms * 1e3 / max(chain, 1),
               grid_blocks=kernels.branch_blocks(N),
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


def _drive(paths, params, expected: tuple) -> dict:
    """One run of the port's assembler (`bloom_dbg.assemble` on the card)
    with every kernel launch count set to 0 just before and read just
    after, pass 2's time split by function, and the walk filter the run
    built kept.  Fails if a kernel of `expected` was not launched."""
    import torch
    from abyss_tpu_torch.dbg import bloom_dbg
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.ops import kernels
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    spans = Spans()
    for mod, name in ((bloom_dbg, "_classify_batch"),
                      (bloom_dbg, "_trim_branch_kmers_batch"),
                      (ext, "extend_forward"), (ext, "fast_extend"),
                      (ext, "_resolve"), (ext, "branch_depths")):
        spans.wrap(mod, name)
    # keep the walk filter the run builds, for the kernel checks after it
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
    for name in expected:
        check(launches[name] > 0, f"kernel {name} was not launched on the "
                                  f"{params.filter_mode} path")
    check(len(walk_filters) == 1, "the path built no single walk filter")
    return dict(fasta=fasta, timings=timings, spans=spans,
                launches=launches, walk_filter=walk_filters[0],
                peak=torch.cuda.max_memory_allocated())


def _hold_to_genome(run: dict, genome: str, phase: str, params,
                    n_pairs: int, read_len: int) -> dict:
    """The run's row: times, contig statistics against the genome, the
    FASTA's sha256 and the launches; fails on a contig check."""
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.io import fastx
    fasta, timings = run["fasta"], run["timings"]
    seqs = [r.seq for r in fastx.read_fastx(io.StringIO(fasta))]
    check(len(seqs) > 0, f"{phase}: assembled no contig")
    genome_bp = len(genome)
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
    row = dict(phase=phase, genome_bp=genome_bp, pairs=n_pairs,
               read_len=read_len, k=params.k,
               filter_mode=params.filter_mode,
               bloom_bytes=params.bloom_bytes,
               batch_size=params.batch_size,
               max_read_len=params.max_read_len,
               pass1_s=timings["pass1_s"],
               pass1_kmers_per_s=kmers / timings["pass1_s"],
               pass2_s=timings["pass2_s"],
               pass2_split_s=run["spans"].seconds,
               pass2_calls=run["spans"].calls,
               contigs=len(seqs), total_bases=sum(lengths),
               n50=_n50(lengths), max_contig=max(lengths),
               contigs_500=len(long_), cover_500=cover,
               not_substring_500=strict, wrong_500_inside_ends=wrong,
               fasta_sha256=hashlib.sha256(fasta.encode()).hexdigest(),
               peak_mem_bytes=run["peak"], launches=run["launches"])
    return row


def _check_contigs(row: dict) -> None:
    phase = row["phase"]
    wrong, strict = row["wrong_500_inside_ends"], row["not_substring_500"]
    check(wrong == 0, f"{phase}: {wrong} contigs >= 500 bp are not genome "
                      f"substrings even without their end k-mers")
    check(strict <= MAX_NOT_SUBSTRING_500,
          f"{phase}: {strict} contigs >= 500 bp are not genome substrings, "
          f"more than {MAX_NOT_SUBSTRING_500}")
    check(row["cover_500"] >= MIN_COVER_500,
          f"{phase}: contigs >= 500 bp cover {row['cover_500']:.4f} of the "
          f"genome, below {MIN_COVER_500}")


def phase_main(tmp: str) -> tuple:
    """The main path at full size; returns its row, (walk filter, read
    paths, params) for the walk and look-ahead kernel checks, the
    genome, and its ntHash launches (NthashShapes)."""
    from abyss_tpu_torch import sim
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.dbg.params import AssemblyParams
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
    with NthashShapes() as shapes:
        run = _drive(paths, params, ("nthash", "walk", "branch"))
    row = _hold_to_genome(run, genome, "main", params, n_pairs, read_len)
    row["simulate_s"] = sim_s
    emit(row)
    _check_contigs(row)
    return row, (run["walk_filter"], paths, params), genome, shapes


def phase_bloom(paths, genome: str, main_row: dict) -> tuple:
    """The Bloom path at full size: the main phase's reads through
    filter_mode="bloom" at BLOOM_BYTES.  Returns its row, the run's
    counting filter (pass 2 reads it and changes nothing), its params,
    and one real pass-1 batch's scatter-max: the counters just before
    it, its update stream and the counters just after."""
    import torch
    from abyss_tpu_torch.dbg.params import AssemblyParams
    from abyss_tpu_torch.ops import bloom as bloom_ops
    params = AssemblyParams(k=31, filter_mode="bloom",
                            bloom_bytes=BLOOM_BYTES)
    capture: dict = {}
    scatter = bloom_ops.scatter_max_u8

    def recording(counters, idx, val):
        # pass 1 calls this once per batch, in batch order
        n = capture.setdefault("calls", 0)
        if n == CAPTURE_BATCH:
            capture.update(before=counters.clone(), idx=idx.clone(),
                           val=val.clone())
        out = scatter(counters, idx, val)
        if n == CAPTURE_BATCH:
            capture["after"] = counters.clone()
        capture["calls"] = n + 1
        return out

    bloom_ops.scatter_max_u8 = recording
    try:
        run = _drive(paths, params, ("nthash", "scatter_max", "walk_bloom",
                                     "branch_bloom"))
    finally:
        bloom_ops.scatter_max_u8 = scatter
    check("after" in capture, f"pass 1 ran fewer than {CAPTURE_BATCH + 1} "
                              "batches")
    cbf = run["walk_filter"]
    check(isinstance(cbf, bloom_ops.CountingBloomFilter),
          "the Bloom path's walk filter is not its counting filter")
    row = _hold_to_genome(run, genome, "bloom", params, main_row["pairs"],
                          main_row["read_len"])
    body = cbf.counters[:-1]
    row.update(counters=cbf.size, num_hashes=cbf.num_hashes,
               threshold=cbf.threshold,
               occupancy=int((body > 0).sum()) / cbf.size,
               solid_occupancy=int((body >= cbf.threshold).sum()) / cbf.size,
               pass1_inserts=capture["calls"],
               # the replay's copies, held from batch CAPTURE_BATCH on,
               # count in peak_mem_bytes
               capture_bytes=sum(capture[n].numel() * capture[n].element_size()
                                 for n in ("before", "after", "idx", "val")))
    row["fpr_estimate"] = row["occupancy"] ** cbf.num_hashes
    emit(row)
    _check_contigs(row)
    del run
    torch.cuda.empty_cache()
    return row, cbf, params, capture


def phase_scatter(capture: dict) -> dict:
    """The scatter-max kernel against scatter_max_u8_plain on the card,
    bit for bit, on one real pass-1 batch of the Bloom path: its update
    stream replayed on the counters as they stood before it (the result
    must also be the counters the run left after it)."""
    import torch
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.ops import scatter_max as sm
    before, idx, val = capture["before"], capture["idx"], capture["val"]
    S = sm.pow2_size(before.shape[0])
    kern = before.clone()
    kernels.scatter_max(kern, idx, val)
    plain = before.clone()
    sm.scatter_max_u8_plain(plain, idx, val)
    torch.cuda.synchronize()
    diff = (kern != plain).nonzero()
    err = int((kern[diff].int() - plain[diff].int()).abs().max()) \
        if len(diff) else 0
    check(err == 0, f"scatter_max kernel differs from scatter_max_u8_plain "
                    f"(max abs err {err})")
    check(torch.equal(kern, capture["after"]),
          "scatter_max replay differs from the counters the run left")
    Q = idx.numel()
    real = int((idx < S).sum())
    written = int((kern != before).sum())
    del kern, plain, diff
    # each update streams its index and value; each one that is not
    # dropped reads and writes one 32-byte sector of the counters
    nbytes = Q * (idx.element_size() + 1) + real * 2 * SECTOR_BYTES
    work = before.clone()

    def reset():   # a fresh copy of the counters; 1 GiB also flushes L2
        work.copy_(before)

    ms = median_ms(lambda: kernels.scatter_max(work, idx, val), 10,
                   flush=reset)
    plain_ms = median_ms(lambda: sm.scatter_max_u8_plain(work, idx, val), 5,
                         flush=reset)
    # one PyTorch call on the same inputs: the dropped updates all hit the
    # sink slot, which the counting filter clears after each insert
    library_ms = median_ms(
        lambda: work.scatter_reduce_(0, idx, val, "amax"), 5, flush=reset)
    del work
    return dict(phase="kernel", kernel="scatter_max", counters=S,
                updates=Q, real_updates=real, counters_raised=written,
                batch=CAPTURE_BATCH, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def phase_bloom_tool(tmp: str, paths, cbf) -> dict:
    """`bloom build -t counting -k 31 -b 1G` through the abyss-bloom CLI's
    entry point on the main reads, launch counts reset just before and
    read just after; its counters must be byte-identical to the Bloom
    path's pass-1 filter (same batches into the same 2^30 counters)."""
    import contextlib
    import numpy as np
    from abyss_tpu_torch.cli import bloom_tool
    from abyss_tpu_torch.ops import kernels
    out = os.path.join(tmp, "counting.npz")
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        bloom_tool.main(["build", "-t", "counting", "-k", "31", "-b",
                         BLOOM_TOOL_SIZE, out, *paths])
    finally:
        launches = dict(kernels.launches)
    build_s = time.perf_counter() - t0
    for name in ("nthash", "scatter_max"):
        check(launches[name] > 0, f"kernel {name} was not launched by "
                                  "bloom build")
    info = io.StringIO()
    with contextlib.redirect_stdout(info):
        bloom_tool.main(["info", out])
    with np.load(out) as z:
        data = z["data"]
    identical = bool(np.array_equal(data, cbf.counters.cpu().numpy()))
    check(identical, "bloom build's counters differ from bloom-dbg's pass-1 "
                     "filter")
    return dict(phase="tool", command=f"bloom build -t counting -k 31 -b "
                f"{BLOOM_TOOL_SIZE}", build_s=build_s,
                npz_bytes=os.path.getsize(out), counters=int(data.size) - 1,
                identical_to_bloom_pass1=identical,
                info=info.getvalue().splitlines(), launches=launches)


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
        main_row, (wf, paths, params), genome, launched = phase_main(tmp)
        row, nthash_shapes, nthash_gap = phase_nthash_shapes(launched, kern)
        emit(row)
        del launched
        walk, walked = phase_walk(wf, paths, params)
        emit(walk)
        branch = phase_branch(*walked)
        emit(branch)
        del wf, walked
        torch.cuda.empty_cache()
        bloom_row, cbf, bparams, capture = phase_bloom(paths, genome,
                                                       main_row)
        scatter = phase_scatter(capture)
        emit(scatter)
        del capture
        walk_bloom, walked = phase_walk(cbf, paths, bparams)
        emit(walk_bloom)
        branch_bloom = phase_branch(*walked)
        emit(branch_bloom)
        del walked
        emit(phase_bloom_tool(tmp, paths, cbf))
        del cbf
    except SmokeError as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # launches: each kernel's count on the path that runs it (main for the
    # sorted filter's kernels, bloom for the counting filter's).  No single
    # PyTorch call computes ntHash, the walks or the look-aheads
    # (library_ms null); walk and branch replace jnp loops of
    # abyss_tpu/dbg/extend.py, not Pallas kernels
    fast_extend = "abyss_tpu/dbg/extend.py:164"
    branch_depths = "abyss_tpu/dbg/extend.py:243"
    walk_cu = "abyss_tpu_torch/csrc/walk.cu"
    # ntHash also lists its flush timing (its earlier `ms`), its times at
    # three shapes (phase_nthash_shapes) and launches x (ms - bound_ms)
    # over every shape of the main run
    kern.update(shapes=nthash_shapes, gap_ms_main_run=nthash_gap)
    emit({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=path["launches"][name],
        max_abs_err=rec["max_abs_err"], ms=rec["ms"],
        plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], library_ms=rec.get("library_ms"),
        **{n: rec[n] for n in ("flush_ms", "shapes", "gap_ms_main_run")
           if n in rec})
        for name, source, replaces, path, rec in (
            ("nthash", "abyss_tpu_torch/csrc/nthash.cu",
             "abyss_tpu/ops/pallas_kernels.py:192", main_row, kern),
            ("walk", walk_cu, fast_extend, main_row, walk),
            ("branch", walk_cu, branch_depths, main_row, branch),
            ("scatter_max", "abyss_tpu_torch/csrc/scatter_max.cu",
             "abyss_tpu/ops/pallas_scatter.py:187", bloom_row, scatter),
            ("walk_bloom", walk_cu, fast_extend, bloom_row, walk_bloom),
            ("branch_bloom", walk_cu, branch_depths, bloom_row,
             branch_bloom))]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
