#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (abyss_tpu_torch) on one GPU.

    python3 chip_smoke.py          # one card, no arguments: every phase
    python3 chip_smoke.py NAME ... # only these phases (PHASES) and the
                                   # phases they need run first

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
          defaults, traced (abyss_tpu_torch/utils/trace.py: the passes'
          spans, pass 2's split into its spans' self times, the walk
          counters); the kernels' launch counts are reset just before and
          read just after, and the contigs are checked against the
          genome; every ntHash launch is recorded by shape.  Then the ntHash kernel at every shape
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
  pe_parity  the port's whole `pe` pipeline (stages 1 to 8 and stats,
          its own defaults at k=31) on the GPU and on the CPU, on the
          parity phase's reads: every artifact byte-identical.
  pe      `pe.run` on the card with the main phase's reads and pe's own
          defaults (batch 16384, max read length 256, 64 MiB, kc=2) at
          k=31, launch counts reset just before and read just after:
          the tracer's spans (each stage's, the mapper's index, vote and
          fixmate, DistanceEst's) and counters, and spans of RResolver
          and the MLE scan; the groups the scan took on the
          card (64 or more); the first vote and every device MLE call
          held against the CPU; sha256 of name-3.fa, name-6.fa and
          name-8.fa, the count, N50 and sum of unitigs, contigs and
          scaffolds, peak device memory, the ntHash launches by stage and
          shape; every N-free block of 500 bp or more of the scaffolds
          held to an ungapped placement on the genome (substitutions
          only, few in any 100 bases: PathConsensus's tied columns),
          scaffold N50 >= unitig N50, scaffolds summing to 0.9 of the
          genome; samtobreak's breakpoints of the
          scaffolds of 200 bp or more (not gated).  Then the ntHash
          kernel at every shape the pe run launched, as after main.
  exact_parity  on the parity phase's reads, on the GPU and on the CPU:
          `pe engine=exact` (k=31), `pe long=` (both mate files as long
          reads), `pe` on a colour-space copy of the reads (k=25) and
          `assemble -k 64` (wide mode, with its snapshot): every
          artifact byte-identical.
  exact_pe  `pe.run(engine="exact")` on the card with the main phase's
          reads and pe's own defaults at k=31 (e, E and c from the
          coverage model), launch counts reset around it: each stage's
          span, the exact engine's phase spans (count, kc filter,
          adjacency, erode, trim, low-coverage loop, bubbles, assemble),
          peak device memory, sha256, count, N50 and sum of unitigs,
          contigs and scaffolds, and the pe phase's genome gates.
  wide    `assemble -k 96 --kc 3` (the exact engine in wide mode, the
          JAX package's BASELINE config #2) on the same reads through
          the tool's entry point, launch counts reset around it: phase
          spans, fingerprint collisions, peak memory, the contigs of
          500 bp or more held to the genome as in main; every ntHash
          launch recorded by stage and shape, then the kernel at each of
          those shapes against the plain version (`nthash_exact_shapes`).
  paired  `paired-dbg -k 80 -K 40 --kc 2` (the paired DBG in wide pair
          mode, the JAX package's BASELINE config #4) on the same reads
          through the tool's entry point, launch counts reset around it:
          the phase spans (count, kc filter, fill, probe, trim, chains,
          emission), the pair rows before and after kc, peak memory,
          count, N50 and sum of the contigs, their N-free blocks of
          500 bp or more held to the genome as main holds its contigs;
          then ntHash at every shape the run launched
          (`nthash_paired_shapes`).
  konnector  `konnector -k 31` with its defaults on 2,000 pairs of the
          genome's first 180 kbp (3.3x as the fixture's first 50,000
          pairs, which take 20 minutes; the filter built from them),
          launch counts reset around it: pairs/s, the stats block, the
          chunks the device engine ran and those that fell back to the
          host engine, peak memory, every merged read held to an
          ungapped placement on the genome (the pe phase's rule); then
          ntHash at every shape the run launched
          (`nthash_konnector_shapes`).
  konnector_cascade  `konnector --cascade 2 --extend` with
          ABYSS_TPU_KONN_FILTER=cascade on 1,000 pairs of the genome's
          first 10 kbp (30x; the fixture's first pairs would leave a
          filter of k-mers seen twice nearly empty): the
          cascading Bloom filter's inserts (scatter-max), the host
          engine, and --extend's walks on the cascade; every walk and
          look-ahead launch of the run is recorded and replayed after
          it, bit for bit against its plain version, timed and bounded
          (the walk_cascade and branch_cascade rows: means over the
          launches, and each launch).
  sealer  the pe phase's directory resumed with sealer_ks="41 31" (only
          stage_sealer and the stats run): gaps closed of total, the
          span, each sealed scaffold's N-free blocks of 500 bp or more
          held to the pe phase's placement rule, except (counted) blocks
          whose only departure is a gap between flanks that overlap on
          the genome by fewer than 41 bases, in order on one strand,
          which the sealer closed by writing the overlap twice, as
          abyss_tpu's sealer does (tests/test_torch_sealer.py).
  paired_parity  on the parity phase's reads, on the GPU and on the CPU:
          `paired-dbg` packed (-k 40 -K 14) and wide (-k 80 -K 40), `pe
          k=50 K=25`, `konnector -k 25` on 400 pairs with the device
          engine, with the host engine and with --cascade 2 --extend,
          and `pe sealer_ks` resumed from pe_parity's stage 8: every
          output byte-identical.
  tools_parity  every tool that takes --device (map, index, count,
          distanceest, pathconsensus with a 7-branch bubble, rresolver,
          consensus, gapfill, kmerprint, logcounter, samtobreak, tigmint,
          arcs and the five aligner wrappers) on the parity phase's reads
          and genome, with --device cuda and with --device cpu: the same
          return value (index raises abyss_tpu's AttributeError on both),
          stdout, stderr and files, byte for byte, and each tool's kernel
          launches on the card.
  tools   `logcounter -k 31 -b 1073741824` (2^30 one-byte PLC cells)
          through its entry point on the fixture's reads, launch counts
          reset just before and read just after: wall time, one ntHash and
          one scatter-max launch per batch, k-mers inserted (equal to the
          windows the CPU port marks valid), the counters' sha256 and
          nonzero cells; the first 4 x 4,096 reads again (the first
          file's head) on the card and on the CPU (counters equal); the decoded counts of 1,000 genome k-mers
          against their exact counts in the reads (median ratio in
          0.5-2); the scatter-max kernel against its plain version on one
          logcounter batch (the `scatter_max_plc` row).  Then
          FMIndex.build of the 4.6 Mbp genome (the device suffix array:
          rounds, wall time, a permutation, in suffix order at 2,000
          sampled places), count and locate of 1,000 40-mers against a
          host search, and the suffix array of the first 2^21 bases on
          the card and on the CPU (equal).
  mesh_parity  pe's stage 1 over np x nh devices (pe.stage_unitigs_1
          with an explicit mesh) on the parity phase's reads, on a mesh of
          copies of the card and of the CPU: the sharded exact engine at
          k = 31 and k = 64 (np = 4), the non-power-of-two mesh count (np
          = 3), the 2 x 2 host mesh, and the bloom engine (B=4M) at np =
          2 (the filter replicated) and np = 4 (sharded, pass 2 through
          walk_sharded): name-1.fa byte-identical, each card run's
          launches; with two cards or more the np x nh = 4 runs again on
          a mesh of distinct cards.
  mesh_exact  pe's stage 1, engine=exact, np = 4 on four copies of the
          card with pe's stage-1 arguments (k = 31, kc 2, e/E/c from the
          coverage model) on the 4.6 Mbp reads, launch counts reset
          around it: its contigs, with coverage, the exact_pe phase's
          ex-1.fa as a set; each shard's rows, the phase spans, the
          routing buckets that overflowed, peak memory.
  mesh_bloom  pe's bloom stage 1 with B=1G (2^30 counters; pe's default
          64 MiB is too small for these reads) on the 4.6 Mbp
          reads at np = 2 (2 x 1, replicated filter, walk_bloom) and np
          = 4 (2 x 2, sharded filter, walk_sharded), launch counts reset
          around each: the sharded counters equal the replicated ones,
          both FASTA files hold the same sequences (byte equality
          reported), both pass the main phase's contig gates; then the
          first 3 walk_sharded and branch_sharded launches of the np = 4
          run replayed against their plain versions (and timed again
          through walk_bloom and branch_bloom on the np = 2 run's
          replicated counters, `bloom_ms`), and one load-step
          scatter-max (a shard's counters with their sink slot) against
          its plain version.

Then one `kernels` JSON line (each kernel's launches on the path that
runs it, and on the pe path for the kernels pe runs, error against its
plain version, times and bound; for ntHash also its launches on the
exact_pe, wide, paired and konnector paths, its times at three shapes
and launches x (ms - bound_ms) summed over every shape of the main,
pe, wide and paired runs; for scatter-max also its launches on the
konnector cascade path and its PLC shape; for both, their launches on
the logcounter path and the mesh bloom path, and scatter-max at the
mesh load step's shape; walk_sharded and branch_sharded from the
mesh_bloom np = 4 run), a `total` row (the run's wall time in seconds
from the script's start, the kernels' build included),
and as the last line
{"ok": true, "device": {...}} (a run of named phases prints no
`kernels` line).  Any failed check exits non-zero before the last
line.  Without a CUDA device, or outside a checkout of the
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

START = time.perf_counter()
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


class Patches:
    """Module attributes replaced until restore() (or the end of a `with`
    block): each item (module, name, make) of the constructor replaces
    module.name with make(original) on entering the block, and patch()
    replaces one more at once."""

    def __init__(self, *items):
        self._items = items
        self._undo: list = []

    def patch(self, mod, name: str, fn) -> None:
        self._undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def restore(self) -> None:
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo.clear()

    def __enter__(self):
        for mod, name, make in self._items:
            self.patch(mod, name, make(getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        self.restore()


class NthashShapes(Patches):
    """Records every ntHash launch of a run by (stage, B, L, k, strands),
    and keeps the codes of the first launch of each key and of pass-1
    batch CAPTURE_BATCH, for timing at the shapes the run launched.
    Pass 1 is the time inside bloom_dbg.load_filter; `stages` names
    further functions, (module, function name, stage), whose launches
    take that stage's name; the rest are "pass2"."""

    def __init__(self, stages=()):
        self.hist: dict = {}
        self.codes: dict = {}
        self.pass1_batch = None
        self._pass1 = False
        self._calls1 = 0
        self._stages = stages
        self._stage = None
        super().__init__()

    def _tag(self, mod, name: str, stage: str) -> None:
        fn = getattr(mod, name)

        def tagged(*a, **kw):
            outer, self._stage = self._stage, stage
            try:
                return fn(*a, **kw)
            finally:
                self._stage = outer

        self.patch(mod, name, tagged)

    def __enter__(self):
        from abyss_tpu_torch.dbg import bloom_dbg
        from abyss_tpu_torch.ops import kernels
        self._nthash, self._load = kernels.nthash, bloom_dbg.load_filter
        for stage in self._stages:
            self._tag(*stage)

        def nthash(codes, k, strands=False):
            stage = "pass1" if self._pass1 else (self._stage or "pass2")
            key = (stage, *codes.shape, k, bool(strands))
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

        self.patch(kernels, "nthash", nthash)
        self.patch(bloom_dbg, "load_filter", load_filter)
        return self


def nthash_shape_rows(rec: NthashShapes) -> tuple[list, float]:
    """The ntHash kernel at every shape a run launched, each on the codes
    of its first launch: bit for bit against its plain version, graph_ms,
    bound; and launches x (ms - bound) summed over the run."""
    from abyss_tpu_torch.ops import kernels, nthash
    rows = []
    for key, n in sorted(rec.hist.items(), key=lambda kv: -kv[1]):
        stage, B, L, k, strands = key
        codes = rec.codes[key]
        err, all_equal = nthash_check(codes, k)
        rows.append(dict(
            name=stage, shape=[B, L], k=k, strands=strands, launches=n,
            max_abs_err=err, equal_at_invalid_too=all_equal,
            ms=graph_ms(lambda: kernels.nthash(codes, k, strands),
                        _graph_reps(codes, k, strands)),
            plain_ms=median_ms(lambda: nthash.kmer_hashes_plain(codes, k), 3),
            **nthash_bound(codes, k, strands)))
    return rows, sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows)


def phase_nthash_shapes(rec: NthashShapes, synthetic: dict) -> tuple:
    """The ntHash kernel at every shape the main run launched
    (nthash_shape_rows), and pass-1 batch CAPTURE_BATCH.  Returns the
    row and the kernels line's three shapes: the synthetic batch, pass-1
    batch CAPTURE_BATCH and the most frequent pass-2 shape."""
    from abyss_tpu_torch.ops import kernels, nthash
    check(rec.pass1_batch is not None, f"pass 1 launched ntHash fewer than "
                                      f"{CAPTURE_BATCH + 1} times")
    rows, gap = nthash_shape_rows(rec)
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
    walk filter: a ProbeSet's table, a counting Bloom filter, a
    cascading Bloom filter or a sharded counting filter."""
    if hasattr(wf, "tab"):
        return wf.tab, ""
    if hasattr(wf, "shards"):
        return wf, "_sharded"
    return wf, "_cascade" if hasattr(wf, "levels") else "_bloom"


WALK_FIELDS = ("buf", "length", "f", "r", "status", "has_prev")


def _hold_walk(wf, st0, k: int, steps: int, reps: int,
               plain_reps: int) -> dict:
    """One walk launch on the lane state st0 (left as it is) against
    fast_extend_plain on the same state, in walk filter `wf`: the error
    (0 or fail), the lanes' outcomes and steps, the bound, the kernel's
    median time over `reps` runs and the plain version's over
    `plain_reps` (0: the time of its one checking run)."""
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.ops import kernels
    solid, variant = _solid(wf)
    P = st0.buf.shape[0]

    def fresh():
        return st0._replace(**{n: getattr(st0, n).clone()
                               for n in WALK_FIELDS})

    kern = fresh()
    kernels.walk(solid, kern.buf, kern.length, kern.f, kern.r, kern.status,
                 kern.seed_canon, kern.has_prev, k, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ext.fast_extend_plain(wf, fresh(), k, steps)
    torch.cuda.synchronize()
    plain_once = (time.perf_counter() - t0) * 1e3
    err = max(_max_abs_err(kern.f, plain.f), _max_abs_err(kern.r, plain.r),
              int((kern.length - plain.length).abs().max()),
              int((kern.status.long() - plain.status.long()).abs().max()),
              int((kern.buf.long() - plain.buf.long()).abs().max()),
              int((kern.has_prev != plain.has_prev).sum()))
    check(err == 0, f"walk{variant} kernel differs from fast_extend_plain "
                    f"(max abs err {err})")
    status = plain.status.cpu().numpy()
    # steps the lanes took: their advances, plus the step that stopped
    # each lane that was ACTIVE when it began
    adv = (plain.length - st0.length).cpu().numpy()
    stopped = (status != ext.ACTIVE) & (st0.status.cpu().numpy()
                                        == ext.ACTIVE)
    lane_steps = int((adv + stopped).sum())
    per_step = WALK_BLOOM_BYTES_PER_STEP if variant else WALK_BYTES_PER_STEP
    nbytes = (lane_steps * per_step + int(adv.sum())
              + 2 * P * (8 * 3 + 2) + P * 8)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = lane_steps * WALK_OPS_PER_STEP / INT_OPS_PER_S * 1e3
    work = fresh()
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=wf.device)

    def reset():
        for n in WALK_FIELDS:
            getattr(work, n).copy_(getattr(st0, n))
        flush_buf.fill_(1)

    ms = median_ms(lambda: kernels.walk(
        solid, work.buf, work.length, work.f, work.r, work.status,
        work.seed_canon, work.has_prev, k, steps), reps, flush=reset)
    plain_ms = median_ms(lambda: ext.fast_extend_plain(wf, work, k, steps),
                         plain_reps, flush=reset) if plain_reps else \
        plain_once
    return dict(lanes=P, buf=st0.buf.shape[1], max_steps=steps,
                lane_steps=lane_steps,
                chain_steps=int((adv + stopped).max()),
                grid_blocks=kernels.walk_blocks(P, k), status=status,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                bytes_ms=bytes_ms, ops_ms=ops_ms, plain=plain)


def _filter_bytes(wf) -> int:
    solid, variant = _solid(wf)
    if variant == "":
        return int(solid.numel() * solid.element_size())
    if variant == "_sharded":
        return int(sum(s.numel() for s in solid.shards))
    return int(solid.levels.numel() if variant == "_cascade"
               else solid.counters.numel())


def _bound(bytes_ms: float, ops_ms: float) -> dict:
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_walk(wf, paths, params, P: int = 4096) -> tuple:
    """The walk kernel against fast_extend_plain on the card, in a path's
    walk filter `wf` (the sorted path's walk table, or the Bloom path's
    counting filter): P lanes seeded with the first k-mer of each read
    of its first batch, with the path's k, buffer and step budget
    (k + chunk bases, chunk steps)."""
    import numpy as np
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.io import read_batches
    _, variant = _solid(wf)
    k, steps = params.k, params.chunk
    first = next(iter(read_batches(paths, P, params.max_read_len)))
    st0 = ext.init_state(np.ascontiguousarray(first.codes[:, :k]), k + steps,
                         k, wf.device)
    got = _hold_walk(wf, st0, k, steps, 10, 3)
    status = got.pop("status")
    check(len(set(status.tolist())) >= 3, "walk check: too few lane outcomes")
    plain = got.pop("plain")
    row = dict(phase="kernel", kernel="walk" + variant, lanes=P,
               buf=k + steps, k=k, max_steps=steps,
               filter_bytes=_filter_bytes(wf),
               lane_steps=got["lane_steps"], chain_steps=got["chain_steps"],
               us_per_chain_step=got["ms"] * 1e3 / got["chain_steps"],
               grid_blocks=got["grid_blocks"],
               outcomes={ext.STATUS_NAMES[int(c)]: int((status == c).sum())
                         for c in np.unique(status)},
               max_abs_err=got["max_abs_err"], ms=got["ms"],
               plain_ms=got["plain_ms"], bytes=got["bytes"],
               **_bound(got["bytes_ms"], got["ops_ms"]))
    return row, (wf, plain, k)


def _hold_branch(wf, roots, f0, r0, k: int, max_depth: int, width: int,
                 reps: int, plain_reps: int) -> dict:
    """One look-ahead launch on roots [N, k] with hashes (f0, r0) against
    branch_depths_plain in walk filter `wf`: the error (0 or fail), the
    depths, the probes and bound, the kernel's median time over `reps`
    runs and the plain version's over `plain_reps` (0: the time of its
    one checking run)."""
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.ops import kernels
    solid, variant = _solid(wf)
    N = roots.shape[0]
    probes = torch.zeros(N, dtype=torch.int64, device=roots.device)
    depth = kernels.branch(solid, roots, f0, r0, k, max_depth, width, probes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ext.branch_depths_plain(wf, roots, (f0, r0), k, max_depth, width)
    torch.cuda.synchronize()
    plain_once = (time.perf_counter() - t0) * 1e3
    err = int((depth.long() - plain.long()).abs().max())
    check(err == 0, f"branch{variant} kernel differs from "
                    f"branch_depths_plain (max abs err {err})")
    n_probes = int(probes.sum())
    nbytes = n_probes * (BRANCH_BLOOM_BYTES_PER_PROBE if variant else 64) \
        + N * (k + 8 + 8 + 4)
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                            device=roots.device)
    ms = median_ms(lambda: kernels.branch(solid, roots, f0, r0, k,
                                          max_depth, width), reps,
                   flush=lambda: flush_buf.fill_(1))
    plain_ms = median_ms(lambda: ext.branch_depths_plain(
        wf, roots, (f0, r0), k, max_depth, width), plain_reps,
        flush=lambda: flush_buf.fill_(1)) if plain_reps else plain_once
    return dict(roots=N, max_depth=max_depth, width=width, probes=n_probes,
                chain_steps=int(plain.max()),
                grid_blocks=kernels.branch_blocks(N), depths=plain,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=n_probes * BRANCH_OPS_PER_PROBE / INT_OPS_PER_S * 1e3)


def phase_branch(wf, walked, k: int, width: int = 16) -> dict:
    """The branch kernel against branch_depths_plain on the card: the 4
    forward branch roots of each walked lane's head k-mer (as _resolve
    builds them for a fork), searched to depth trim = k with the main
    path's frontier width, in the walk filter the lanes walked."""
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.ops import nthash
    _, variant = _solid(wf)
    heads, _ = ext._stuck_heads(walked.buf, k, walked.length)
    P = heads.shape[0]
    roots = torch.cat([heads[:, None, 1:].expand(P, 4, k - 1),
                       torch.arange(4, dtype=torch.uint8, device=heads.device)
                       [None, :, None].expand(P, 4, 1)], dim=2)
    roots = roots.reshape(4 * P, k).contiguous()
    f0, r0 = nthash.hash_base(roots, k)
    got = _hold_branch(wf, roots, f0, r0, k, k, width, 10, 3)
    plain = got.pop("depths")
    check(len(set(plain.tolist())) >= 3, "branch check: too few depths")
    chain = got["chain_steps"]   # the deepest root's depth
    row = dict(phase="kernel", kernel="branch" + variant, roots=4 * P, k=k,
               max_depth=k, width=width, probes=got["probes"],
               chain_steps=chain,
               us_per_chain_step=got["ms"] * 1e3 / max(chain, 1),
               grid_blocks=got["grid_blocks"],
               depth_hist={int(d): int(n) for d, n in zip(
                   *torch.unique(plain, return_counts=True))},
               max_abs_err=got["max_abs_err"], ms=got["ms"],
               plain_ms=got["plain_ms"], bytes=got["bytes"],
               **_bound(got["bytes_ms"], got["ops_ms"]))
    return row


class WalkCalls(Patches):
    """Records every launch of the walk and look-ahead kernels during a
    run: the filter, the inputs as the kernel got them (copies) and the
    scalar arguments, to replay each launch against its plain version
    after the run at the run's own shapes."""

    def __init__(self, limit: int | None = None):
        super().__init__()
        self.walks: list = []
        self.branches: list = []
        self.limit = limit          # launches of each kernel kept
        self.seen = {"walk": 0, "branch": 0}

    def _keep(self, kernel: str) -> bool:
        self.seen[kernel] += 1
        return self.limit is None or self.seen[kernel] <= self.limit

    def __enter__(self):
        from abyss_tpu_torch.dbg import extend as ext
        from abyss_tpu_torch.ops import kernels
        walk, branch = kernels.walk, kernels.branch

        def recording_walk(solid, buf, length, f, r, status, seed_canon,
                           has_prev, k, max_steps):
            if self._keep("walk"):
                st = ext.ExtendState(buf.clone(), length.clone(), f.clone(),
                                     r.clone(), status.clone(),
                                     seed_canon.clone(), has_prev.clone())
                self.walks.append((solid, st, k, max_steps))
            return walk(solid, buf, length, f, r, status, seed_canon,
                        has_prev, k, max_steps)

        def recording_branch(solid, roots, f0, r0, k, max_depth, width,
                             probes=None):
            if self._keep("branch"):
                self.branches.append((solid, roots.clone(), f0.clone(),
                                      r0.clone(), k, max_depth, width))
            return branch(solid, roots, f0, r0, k, max_depth, width, probes)

        self.patch(kernels, "walk", recording_walk)
        self.patch(kernels, "branch", recording_branch)
        return self


def _replayed(kernel: str, calls: list, filter_bytes: int) -> dict:
    """A kernel row from the per-launch results of a replayed run: `ms`,
    `plain_ms` and `bound_ms` are the means over its launches (each
    launch's own bound), their sums are the `*_run` fields, and `calls`
    lists every launch."""
    n = len(calls)
    tot = {x: sum(c[x] for c in calls)
           for x in ("ms", "plain_ms", "bytes_ms", "ops_ms", "bytes")}
    bound = [max(c["bytes_ms"], c["ops_ms"]) for c in calls]
    bytes_bound = sum(c["bytes_ms"] >= c["ops_ms"] for c in calls)
    keep = ("lanes", "buf", "max_steps", "lane_steps", "roots", "max_depth",
            "width", "probes", "chain_steps", "grid_blocks", "ms",
            "plain_ms")
    return dict(phase="kernel", kernel=kernel, replayed_launches=n,
                filter_bytes=filter_bytes,
                max_abs_err=max(c["max_abs_err"] for c in calls),
                ms=tot["ms"] / n, plain_ms=tot["plain_ms"] / n,
                bound_ms=sum(bound) / n,
                bound_by="bytes" if 2 * bytes_bound >= n else "operations",
                ms_run=tot["ms"], plain_ms_run=tot["plain_ms"],
                bound_ms_run=sum(bound), bytes_run=tot["bytes"],
                calls=[dict({x: c[x] for x in keep if x in c},
                            bound_ms=b) for c, b in zip(calls, bound)])


def phase_replay_walks(rec: WalkCalls, launches: dict,
                       variant: str = "_cascade") -> tuple:
    """Every walk and look-ahead launch a run made (WalkCalls), or the
    first rec.limit of each, replayed on its recorded inputs: each bit
    for bit against its plain version, timed (median of 5 kernel runs;
    the plain look-ahead's median of 3, the plain walk's checking run, a
    second or more each) and bounded.  Returns the walk and look-ahead
    rows of the kernels' `variant`."""
    from abyss_tpu_torch.dbg import extend as ext
    check(rec.seen["walk"] == launches["walk" + variant] and
          rec.seen["branch"] == launches["branch" + variant],
          "replay: the recorded walk and look-ahead launches are not the "
          "run's")
    walks, branches = [], []
    for wf, st0, k, steps in rec.walks:
        got = _hold_walk(wf, st0, k, steps, 5, 0)
        got.pop("plain")
        status = got.pop("status")
        got["outcomes"] = {ext.STATUS_NAMES[int(c)]: int((status == c).sum())
                           for c in set(status.tolist())}
        walks.append(got)
    for wf, roots, f0, r0, k, max_depth, width in rec.branches:
        got = _hold_branch(wf, roots, f0, r0, k, max_depth, width, 5, 3)
        got.pop("depths")
        branches.append(got)
    check(sum(c["lane_steps"] for c in walks) > 0,
          "replay: the recorded walks took no step")
    check(sum(c["probes"] for c in branches) > 0,
          "replay: the recorded look-aheads probed nothing")
    fb = _filter_bytes(rec.walks[0][0])
    walk = _replayed("walk" + variant, walks, fb)
    walk["outcomes"] = {}
    for c in walks:
        for name, n in c["outcomes"].items():
            walk["outcomes"][name] = walk["outcomes"].get(name, 0) + n
    branch = _replayed("branch" + variant, branches, fb)
    for row, kernel in ((walk, "walk"), (branch, "branch")):
        row["path_launches"] = rec.seen[kernel]
    return walk, branch


class Spans(Patches):
    """Host seconds of a few functions that hold no span of the port's
    tracer, each net of the wrapped functions it calls (a stack of open
    spans), with a device sync at the end of each span so device work
    lands in the span that queued it."""

    def __init__(self):
        self.seconds: dict = {}
        self.gross: dict = {}         # the same spans with their insides
        self.calls: dict = {}
        self._open: list = []
        super().__init__()

    def wrap(self, mod, name: str, label: str | None = None) -> None:
        import torch
        fn = getattr(mod, name)
        attr, name = name, label or name

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
                self.gross[name] = self.gross.get(name, 0.0) + dt
                self.calls[name] = self.calls.get(name, 0) + 1
                if self._open:
                    self._open[-1] += dt

        self.patch(mod, attr, span)


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


def _assemble(paths, params, device) -> str:
    from abyss_tpu_torch.dbg import bloom_dbg
    out = io.StringIO()
    bloom_dbg.assemble(paths, params, out=out, device=device)
    return out.getvalue()


def _inside(records, root: str) -> tuple:
    """(self seconds, calls) by name of the tracer's spans inside the
    spans named `root`."""
    from abyss_tpu_torch.utils import trace
    spans = [r for r in records if isinstance(r, trace.SpanRecord)]
    by_id = {r.id: r for r in spans}

    def under(r):
        while r.parent is not None:
            r = by_id[r.parent]
            if r.name == root:
                return True
        return False

    kept = [r for r in spans if under(r)]
    calls: dict = {}
    for r in kept:
        calls[r.name] = calls.get(r.name, 0) + 1
    return trace.self_seconds(kept), calls


def _parity_genome() -> str:
    """The parity phase's 20 kbp genome with 4 repeats of 500 bp."""
    from abyss_tpu_torch import sim
    return sim.genome_with_repeats(20000, seed=5, n_repeats=4,
                                   repeat_len=500)


def phase_parity(tmp: str) -> dict:
    """GPU and CPU runs of the port write the same FASTA bytes."""
    from abyss_tpu_torch import sim
    from abyss_tpu_torch.dbg.params import AssemblyParams
    genome = _parity_genome()
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
    traced (utils/trace: the passes' spans, pass 2's split into its
    spans, the walk counters), with every kernel launch count set to 0
    just before and read just after, and the walk filter the run built
    kept.  Fails if a kernel of `expected` was not launched."""
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.utils import trace
    torch.cuda.reset_peak_memory_stats()
    # keep the walk filter the run builds, for the kernel checks after it
    walk_filters = []
    walk_filter = ext.walk_filter

    def keep_walk_filter(cbf):
        walk_filters.append(walk_filter(cbf))
        return walk_filters[-1]

    kernels.reset_launches()
    with Patches((ext, "walk_filter", lambda _: keep_walk_filter)):
        try:
            with trace.recording() as records:
                fasta = _assemble(paths, params, "cuda")
        finally:
            launches = dict(kernels.launches)
    torch.cuda.synchronize()
    for name in expected:
        check(launches[name] > 0, f"kernel {name} was not launched on the "
                                  f"{params.filter_mode} path")
    check(len(walk_filters) == 1, "the path built no single walk filter")
    return dict(fasta=fasta, records=records, launches=launches,
                walk_filter=walk_filters[0],
                peak=torch.cuda.max_memory_allocated())


def _hold_to_genome(run: dict, genome: str, phase: str, params,
                    n_pairs: int, read_len: int) -> dict:
    """The run's row: times, contig statistics against the genome, the
    FASTA's sha256 and the launches; fails on a contig check."""
    from abyss_tpu_torch.utils import trace
    fasta, records = run["fasta"], run["records"]
    seconds = trace.span_seconds(records)
    split, calls = _inside(records, "bloom.pass2")
    stats = _contig_stats(fasta, genome, phase, params.k)
    kmers = int(n_pairs * 2 * (read_len - params.k + 1))
    row = dict(phase=phase, genome_bp=len(genome), pairs=n_pairs,
               read_len=read_len, k=params.k,
               filter_mode=params.filter_mode,
               bloom_bytes=params.bloom_bytes,
               batch_size=params.batch_size,
               max_read_len=params.max_read_len,
               pass1_s=seconds["bloom.pass1"],
               pass1_kmers_per_s=kmers / seconds["bloom.pass1"],
               pass2_s=seconds["bloom.pass2"],
               pass2_split_s=split, pass2_calls=calls,
               counts=trace.counter_totals(records), **stats,
               peak_mem_bytes=run["peak"], launches=run["launches"])
    return row


def _contig_stats(fasta: str, genome: str, phase: str, k: int) -> dict:
    """Stage-1 contigs against the genome: count, bases, N50, the
    contigs of 500 bp or more (their cover, those not genome substrings,
    and those not substrings even inside their end k-mers) and the
    FASTA's sha256; fails when there is no contig."""
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.io import fastx
    seqs = [r.seq for r in fastx.read_fastx(io.StringIO(fasta))]
    check(len(seqs) > 0, f"{phase}: assembled no contig")
    rc = alphabet.revcomp(genome)
    long_ = [s for s in seqs if len(s) >= 500]
    strict = sum(1 for s in long_ if s not in genome and s not in rc)
    # stage 1 may end a contig in a k-mer that holds a read error (the
    # JAX package writes the same contigs): hold the rest to the genome
    wrong = sum(1 for s in long_
                if s[k:-k] not in genome and s[k:-k] not in rc)
    lengths = [len(s) for s in seqs]
    return dict(contigs=len(seqs), total_bases=sum(lengths),
                n50=_n50(lengths), max_contig=max(lengths),
                contigs_500=len(long_),
                cover_500=sum(len(s) for s in long_) / len(genome),
                not_substring_500=strict, wrong_500_inside_ends=wrong,
                fasta_sha256=hashlib.sha256(fasta.encode()).hexdigest())


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


def make_fixture(tmp: str) -> dict:
    """The 4.6 Mbp genome with 12 repeats of 700 bp and 613,333 read
    pairs of 150 bases at 40x (fragments 500 +- 50, error 0.005, seed
    11) in tmp/r1.fq and tmp/r2.fq: the reads of the main, bloom, pe,
    exact_pe, wide, paired and sealer phases."""
    from abyss_tpu_torch import sim
    from abyss_tpu_torch.core import alphabet
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
    return dict(genome=genome, paths=paths, n_pairs=n_pairs,
                read_len=read_len, simulate_s=sim_s)


def phase_main(fx: dict) -> tuple:
    """The main path at full size on the fixture's reads; returns its
    row, (walk filter, read paths, params) for the walk and look-ahead
    kernel checks, and its ntHash launches (NthashShapes)."""
    from abyss_tpu_torch.dbg.params import AssemblyParams
    paths = fx["paths"]
    # the CLI defaults: batch 4096, max read length 512
    params = AssemblyParams(k=31)
    with NthashShapes() as shapes:
        run = _drive(paths, params, ("nthash", "walk", "branch"))
    row = _hold_to_genome(run, fx["genome"], "main", params, fx["n_pairs"],
                          fx["read_len"])
    row["simulate_s"] = fx["simulate_s"]
    emit(row)
    _check_contigs(row)
    return row, (run["walk_filter"], paths, params), shapes


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
    return dict(phase="kernel", kernel="scatter_max",
                **scatter_replay(capture), batch=CAPTURE_BATCH)


def scatter_replay(capture: dict) -> dict:
    """One captured scatter-max call (`before` counters, `idx`, `val`,
    and the `after` counters the run left) replayed through the kernel
    and through scatter_max_u8_plain, bit for bit, with timings and the
    byte bound."""
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
    # sink slot, which the counting filter clears after each insert (a
    # PLC array drops none)
    library_ms = median_ms(
        lambda: work.scatter_reduce_(0, idx, val, "amax"), 5, flush=reset)
    del work
    return dict(counters=S, updates=Q, real_updates=real,
                counters_raised=written, max_abs_err=err, ms=ms,
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

# the tracer's spans of pe.run's stages, whose seconds its [wall] lines
# print
PE_STAGES = ("pe.unitigs", "pe.graph", "pe.dist", "pe.contigs",
             "pe.scaffolds", "pe.stats")
# the MLE scan runs on the card only for 64 groups or more
MIN_MLE_DEVICE_GROUPS = 64
# Scaffolds against the genome.  PathConsensus (stages 5 and 7) writes
# the column majority of its candidate paths; where two candidates tie,
# the JAX package (and so the port, byte for byte) takes the smaller
# base code, which is the read error's base about half the time: on the
# 200 kbp reads 9 of its 20 consensus contigs differ from the genome in
# one base (PERF.md).  So an N-free block is held to an ungapped
# placement on the genome: substitutions only, at most
# MAX_SUBS_PER_WINDOW in any SUBS_WINDOW bases.  Consensus errors come
# one per bubble (at most 3 within 100 bases in the 4.6 Mbp run); an
# insertion, a deletion or a misjoin leaves about 3 of every 4 bases
# after it differing from any single placement.
SUBS_WINDOW = 100
MAX_SUBS_PER_WINDOW = 10
# scaffolds cover at least this share of the genome, as the JAX
# package's own pipeline test asks of its genome
MIN_SCAFFOLD_SUM = 0.9


def _pe_params(name: str, paths, outdir: str, device: str):
    """`pe`'s own defaults (batch_size 16384, max_read_len 256,
    bloom_bytes 64 MiB, kc 2) at k = 31."""
    from abyss_tpu_torch.pipeline import pe
    return pe.PipelineParams(name=name, k=31, in_files=list(paths),
                             outdir=outdir, verbose=0, device=device)


def _anchor_offsets(n: int, anchor: int = 32, tries: int = 16) -> range:
    """Offsets of the anchors a placement of n bases tries."""
    return range(0, n - anchor + 1, max(1, (n - anchor) // tries))


def _place(codes, strand_codes, hits) -> tuple | None:
    """(differing offsets, strand, start) of the first ungapped placement
    of `codes` with no more than MAX_SUBS_PER_WINDOW differing bases in
    any SUBS_WINDOW consecutive ones, or None.  For each anchor offset
    (_anchor_offsets) and each strand in turn (strand_codes: the
    genome's uint8 codes and its reverse complement's), hits(strand,
    off) gives where the anchor occurs exactly on that strand, its first
    16 occurrences in order; the first that passes is taken."""
    import numpy as np
    n = len(codes)
    for off in _anchor_offsets(n):
        for strand, ref in enumerate(strand_codes):
            for pos in hits(strand, off):
                start = int(pos) - off
                if not 0 <= start <= len(ref) - n:
                    continue
                diff = np.nonzero(codes != ref[start:start + n])[0]
                ends = np.searchsorted(diff, diff + SUBS_WINDOW)
                if not len(diff) or int((ends - np.arange(len(diff)))
                                        .max()) <= MAX_SUBS_PER_WINDOW:
                    return diff.tolist(), strand, start
    return None


def ungapped_mismatches(block: str, strands) -> list | None:
    """Offsets where `block` differs from the genome at its first
    placement under _place's rule, or None when there is none; the
    anchors are found by str.find (strands: (sequence, uint8 codes) of
    the genome and of its reverse complement).  GenomeIndex places many
    sequences on a large genome the same way."""
    from abyss_tpu_torch.core import alphabet

    def hits(strand, off):
        seq, anchor = strands[strand][0], block[off:off + 32]
        pos = seq.find(anchor)
        for _ in range(16):
            if pos < 0:
                return
            yield pos
            pos = seq.find(anchor, pos + 1)

    found = _place(alphabet.encode(block), [c for _, c in strands], hits)
    return None if found is None else found[0]


def _fa_lengths(path: str) -> list:
    from abyss_tpu_torch.io import fastx
    return [len(r.seq) for r in fastx.read_fastx(path)]


class PeCapture(Patches):
    """Wraps the mapper's vote and the MLE scan during a pe run: counts
    the groups the scan took on the card, and keeps the first vote's
    inputs and outputs and every estimate_distances_device call's
    arguments and answer, to hold them against the CPU afterwards."""

    def __init__(self):
        self.mle_groups = 0
        self.mle_calls = []
        self.vote = None
        super().__init__()

    def __enter__(self):
        from abyss_tpu_torch.align import distance_est, mapper
        scan, est, vote = (distance_est._mle_scan,
                           distance_est.estimate_distances_device,
                           mapper._vote_kernel)

        def counting_scan(tab, filter_size, T, s, *a):
            self.mle_groups += s.shape[0]
            return scan(tab, filter_size, T, s, *a)

        def recording_est(groups, pmf, first, last, **kw):
            out = est(groups, pmf, first, last, **kw)
            self.mle_calls.append((groups, pmf, first, last, kw, out))
            return out

        def recording_vote(index, codes, k):
            out = vote(index, codes, k)
            if self.vote is None:
                self.vote = (index, codes.clone(), k, out)
            return out

        self.patch(distance_est, "_mle_scan", counting_scan)
        self.patch(distance_est, "estimate_distances_device", recording_est)
        self.patch(mapper, "_vote_kernel", recording_vote)
        return self

    def hold_to_cpu(self) -> dict:
        """The first vote and every device MLE call of the run, again on
        the CPU: outputs must be equal (integers, no tolerance)."""
        import torch
        from abyss_tpu_torch.align import distance_est, mapper
        check(self.vote is not None, "pe: the mapper's vote never ran")
        index, codes, k, out = self.vote
        cpu_index = mapper.KmerIndex(
            k=index.k, **{n: getattr(index, n).cpu() for n in (
                "hashes", "contig", "pos", "is_fwd", "first_row")},
            names=index.names, lengths=index.lengths)
        t0 = time.perf_counter()
        cpu = mapper._vote_kernel(cpu_index, codes.cpu(), k)
        vote_cpu_s = time.perf_counter() - t0
        vote_equal = all(torch.equal(a.cpu(), b) for a, b in zip(out, cpu))
        check(vote_equal, "pe: the vote on the card differs from the CPU's")
        t0 = time.perf_counter()
        mle_equal = all(
            distance_est.estimate_distances_device(
                groups, pmf, first, last, **dict(kw, device="cpu")) == got
            for groups, pmf, first, last, kw, got in self.mle_calls)
        check(mle_equal, "pe: the MLE distances on the card differ from "
                         "the CPU's")
        return dict(vote_batch=list(codes.shape), vote_equal=vote_equal,
                    vote_cpu_s=vote_cpu_s,
                    mle_cpu_s=time.perf_counter() - t0,
                    mle_device_calls=len(self.mle_calls),
                    mle_groups_compared=sum(len(c[0]) for c in self.mle_calls),
                    mle_equal=mle_equal)


def _pe_outputs(params, genome: str) -> tuple[dict, list]:
    """A finished pe run held to its genome: the count, N50 and sums of
    unitigs, contigs and scaffolds, sha256 of name-3/6/8.fa, and every
    N-free block of 500 bp or more of the scaffolds placed on the genome
    (ungapped_mismatches).  Returns the row's fields and the scaffolds;
    _check_pe_outputs applies the gates."""
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.core.histogram import contiguity_stats
    from abyss_tpu_torch.io import fastx
    stats = {}
    for suffix, label in (("3.fa", "unitigs"), ("6.fa", "contigs"),
                          ("8.fa", "scaffolds")):
        lengths = _fa_lengths(params.path(suffix))
        st = contiguity_stats(lengths, min_size=500, name=label)
        stats[label] = dict(n=st["n"], n_500=st["n:500"], N50=st["N50"],
                            sum_500=st["sum"], sum=sum(lengths),
                            max=st["max"])
    sha = {}
    for suffix in ("3.fa", "6.fa", "8.fa"):
        with open(params.path(suffix), "rb") as f:
            sha[f"name-{suffix}"] = hashlib.sha256(f.read()).hexdigest()
    scaffolds = [(r.id, r.seq)
                 for r in fastx.read_fastx(params.path("8.fa"))]
    rc = alphabet.revcomp(genome)
    blocks = [b for _, s in scaffolds for b in s.split("N") if len(b) >= 500]
    strict = sum(1 for b in blocks if b not in genome and b not in rc)
    strands = ((genome, alphabet.encode(genome)), (rc, alphabet.encode(rc)))
    placed = [ungapped_mismatches(b, strands) for b in blocks]
    return dict(
        sha256=sha, stats=stats,
        n_scaffolds_with_gap=sum(1 for _, s in scaffolds if "N" in s),
        blocks_500=len(blocks), not_substring_500=strict,
        blocks_500_unplaced=sum(p is None for p in placed),
        substitutions_500=sum(len(p) for p in placed if p),
        block_bases_500=sum(len(b) for b in blocks)), scaffolds


def _check_pe_outputs(row: dict, phase: str) -> None:
    """The genome gates of a pe run's row (_pe_outputs' fields)."""
    stats, unplaced = row["stats"], row["blocks_500_unplaced"]
    check(unplaced == 0,
          f"{phase}: {unplaced} N-free blocks >= 500 bp of the scaffolds "
          f"have no ungapped placement on the genome with at most "
          f"{MAX_SUBS_PER_WINDOW} substitutions in {SUBS_WINDOW} bases")
    check(stats["scaffolds"]["N50"] >= stats["unitigs"]["N50"],
          f"{phase}: scaffold N50 below unitig N50")
    check(stats["scaffolds"]["sum"] >= MIN_SCAFFOLD_SUM * row["genome_bp"],
          f"{phase}: scaffolds sum to {stats['scaffolds']['sum']} bp, below "
          f"{MIN_SCAFFOLD_SUM} of the genome")


def phase_pe(tmp: str, paths, genome: str) -> tuple:
    """`pe.run` on the card with the main phase's reads and pe's own
    defaults at k = 31: stages 1 to 8 and stats, launch counts set to 0
    just before and read just after, each stage's span (and the vote's,
    the MLE scan's, RResolver's and the index builds'), every ntHash
    launch by stage and shape; then the vote and the MLE held against
    the CPU, and the scaffolds against the genome.  Returns its row and
    the ntHash recorder."""
    import torch
    from abyss_tpu_torch.align import distance_est, mapper
    from abyss_tpu_torch.graph import rresolver
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.pipeline import pe
    from abyss_tpu_torch.stats import samtobreak
    from abyss_tpu_torch.utils import trace
    out = os.path.join(tmp, "pe")
    params = _pe_params("pe", paths, out, "cuda")
    # the stages, the mapper and DistanceEst are the tracer's spans
    spans = Spans()
    for mod, name in ((rresolver, "build_rmer_filter"),
                      (rresolver, "resolve_repeats"),
                      (distance_est, "_mle_scan")):
        spans.wrap(mod, name)
    stages = ((rresolver, "build_rmer_filter", "rmer_reads"),
              (rresolver, "resolve_repeats", "rmer_windows"),
              (mapper.KmerAligner, "__init__", "mapper_index"),
              (mapper, "_vote_kernel", "mapper_reads"))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with PeCapture() as cap, NthashShapes(stages) as shapes, \
                trace.recording() as records:
            pe.run(params)
    finally:
        launches = dict(kernels.launches)
        spans.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    traced = trace.span_seconds(records)
    calls = dict(spans.calls)
    for r in records:
        if isinstance(r, trace.SpanRecord) and r.name not in PE_STAGES:
            calls[r.name] = calls.get(r.name, 0) + 1
    for name in ("nthash", "walk", "branch"):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
                                  "pe path")
    check(cap.mle_groups >= MIN_MLE_DEVICE_GROUPS,
          f"pe: the MLE scan took {cap.mle_groups} groups on the card, "
          f"fewer than {MIN_MLE_DEVICE_GROUPS}")
    held = cap.hold_to_cpu()

    held_genome, scaffolds = _pe_outputs(params, genome)
    t1 = time.perf_counter()
    brk = samtobreak.contig_breakpoints(
        genome, [(n, s) for n, s in scaffolds if len(s) >= 200],
        device="cuda")
    brk_s = time.perf_counter() - t1
    genome_bp = len(genome)
    row = dict(phase="pe", genome_bp=genome_bp,
        reads=[os.path.basename(p) for p in paths], k=params.k,
        batch_size=params.batch_size, max_read_len=params.max_read_len,
        bloom_bytes=params.bloom_bytes, kc=params.kc, wall_s=wall,
        stage_s={n: traced.get(n, 0.0) for n in PE_STAGES},
        spans_s={**{n: s for n, s in traced.items() if n not in PE_STAGES},
                 **spans.gross},
        calls=calls, counts=trace.counter_totals(records),
        mle_groups_device=cap.mle_groups, **held, **held_genome,
        breakpoints_200=brk.breakpoints,
        breakpoint_contigs_200=brk.contigs,
        aligned_fraction_200=brk.aligned_fraction, samtobreak_s=brk_s,
        peak_mem_bytes=peak, launches=launches,
        nthash_launches=[dict(stage=key[0], shape=list(key[1:3]), k=key[3],
                              strands=key[4], launches=n)
                         for key, n in sorted(shapes.hist.items())])
    emit(row)
    _check_pe_outputs(row, "pe")
    return row, shapes


def phase_shapes(rec: NthashShapes, kernel: str) -> dict:
    """The ntHash kernel at every shape a run launched (as
    phase_nthash_shapes does for the main run)."""
    rows, gap = nthash_shape_rows(rec)
    return dict(phase="kernel", kernel=kernel,
                launches=sum(r["launches"] for r in rows), gap_ms=gap,
                histogram=rows)


def _tree_bytes(root: str) -> dict:
    """{relative path: bytes, or "-> target" for a link} of a directory."""
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if os.path.islink(path):
            out[name] = "-> " + os.readlink(path)
        else:
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def phase_pe_parity(tmp: str) -> dict:
    """`pe.run` on the card and on the CPU, on the parity phase's reads:
    every artifact (FASTA, graphs, paths, histograms, distances, stats,
    links) byte-identical."""
    paths = [os.path.join(tmp, "p1.fq"), os.path.join(tmp, "p2.fq")]
    from abyss_tpu_torch.pipeline import pe
    times = {}
    trees = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(tmp, f"pe_parity_{device}")
        t0 = time.perf_counter()
        pe.run(_pe_params("par", paths, out, device))
        times[device] = time.perf_counter() - t0
        trees[device] = _tree_bytes(out)
    gpu, cpu = trees["cuda"], trees["cpu"]
    differ = sorted(n for n in set(gpu) | set(cpu) if gpu.get(n) != cpu.get(n))
    check(not differ, f"pe parity: GPU and CPU artifacts differ: {differ}")
    check(len(gpu) >= 30, f"pe parity: only {len(gpu)} artifacts")
    with open(os.path.join(tmp, "pe_parity_cuda", "par-8.fa")) as f:
        scaffolds = f.read().count(">")
    return dict(phase="pe_parity", artifacts=len(gpu), identical=True,
                scaffolds=scaffolds, gpu_s=times["cuda"], cpu_s=times["cpu"])



# the exact engine's phases: the tracer's spans of assemble_reads
EXACT_PHASES = ("hash.count", "hash.kc_filter", "hash.wide_fill",
                "hash.adjacency", "hash.erode", "hash.trim", "hash.lowcov",
                "hash.bubbles", "hash.emit")
# the wide phase: `assemble -k 96 --kc 3`, the JAX package's BASELINE
# config #2 (stage 1 in wide mode, BENCH_NOTES.md)
WIDE_K = 96
WIDE_KC = 3


class ExactCapture(Patches):
    """During a run of the exact engine, traced: the seconds of each of
    its phases (the tracer's spans, each ended by a device
    synchronisation), the engine's calls and the wide fill's rows and
    fingerprint collisions."""

    def __init__(self):
        self.records: list = []
        self.calls = 0
        self.collisions = 0
        self.fill_rows = 0
        super().__init__()

    def __enter__(self):
        from abyss_tpu_torch.dbg import hash_dbg
        from abyss_tpu_torch.utils import trace
        assemble, fill = hash_dbg.assemble_reads, hash_dbg.fill_wide_side

        def assemble_reads(*a, **kw):
            self.calls += 1
            return assemble(*a, **kw)

        def fill_wide_side(t, *a, **kw):
            out = fill(t, *a, **kw)
            self.collisions += t.collisions
            self.fill_rows += t.n
            return out

        self.patch(hash_dbg, "assemble_reads", assemble_reads)
        self.patch(hash_dbg, "fill_wide_side", fill_wide_side)
        self._recording = trace.recording()
        self.records = self._recording.__enter__()
        return self

    def __exit__(self, *exc):
        self._recording.__exit__(*exc)
        super().__exit__(*exc)

    def seconds(self) -> dict:
        from abyss_tpu_torch.utils import trace
        return trace.span_seconds(self.records)

    def phases(self) -> dict:
        seconds = self.seconds()
        return {n: seconds[n] for n in EXACT_PHASES if n in seconds}


def phase_exact_pe(tmp: str, paths, genome: str) -> dict:
    """`pe.run(engine="exact")` on the card with the main phase's reads
    and pe's own defaults at k = 31 (auto e, E and c from the coverage
    model, as scripts/genome_e2e.py runs it), launch counts set to 0
    just before and read just after: each stage's span, the exact
    engine's phase spans, peak device memory; unitigs, contigs and
    scaffolds against the genome with the pe phase's gates."""
    import torch
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.pipeline import pe
    params = _pe_params("ex", paths, os.path.join(tmp, "exact_pe"), "cuda")
    params.engine = "exact"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with ExactCapture() as cap:
            pe.run(params)
    finally:
        launches = dict(kernels.launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the packed engine hashes nothing; stages 4-8's mapper launch ntHash
    check(launches["nthash"] > 0, "kernel nthash was not launched on the "
                                  "exact pe path")
    check(cap.calls == 1, f"pe ran the exact engine {cap.calls} times")
    held, _ = _pe_outputs(params, genome)
    row = dict(phase="exact_pe", genome_bp=len(genome), engine="exact",
               reads=[os.path.basename(p) for p in paths], k=params.k,
               batch_size=params.batch_size,
               max_read_len=params.max_read_len, kc=params.kc,
               wall_s=wall,
               stage_s={n: cap.seconds().get(n, 0.0) for n in PE_STAGES},
               exact_phase_s=cap.phases(), **held,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    emit(row)
    _check_pe_outputs(row, "exact_pe")
    return row


def phase_wide(tmp: str, paths, genome: str) -> tuple:
    """`assemble -k 96 --kc 3` (the exact engine in wide mode, through
    the assemble tool's entry point) on the card with the main phase's
    reads, launch counts set to 0 just before and read just after, and
    every ntHash launch recorded by stage (count, fill) and shape: the
    phase spans, the fingerprint collisions (0 expected), peak memory,
    and the contigs of 500 bp or more held to the genome as the main
    phase holds its own.  Returns its row and the ntHash recorder."""
    import torch
    from abyss_tpu_torch.cli import tools
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.dbg import hash_dbg
    from abyss_tpu_torch.io import fastx
    from abyss_tpu_torch.ops import kernels
    out = os.path.join(tmp, "wide.fa")
    opts = ["-k", str(WIDE_K), "--kc", str(WIDE_KC)]
    argv = [*paths, *opts, "-o", out, "--device", "cuda"]
    stages = ((hash_dbg, "_count_kmers_wide", "count"),
              (hash_dbg, "fill_wide_side", "fill"))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with ExactCapture() as cap, NthashShapes(stages) as shapes:
            tools.assemble_main(argv)
    finally:
        launches = dict(kernels.launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(launches["nthash"] > 0, "kernel nthash was not launched on the "
                                  "wide path")
    check(cap.fill_rows > 0, "the wide path filled no side arrays")
    seqs = [r.seq for r in fastx.read_fastx(out)]
    check(len(seqs) > 0, "wide: assembled no contig")
    rc = alphabet.revcomp(genome)
    long_ = [s for s in seqs if len(s) >= 500]
    off = [s for s in long_ if s not in genome and s not in rc]
    # a genome substring's inside is one too
    wrong = sum(1 for s in off if s[WIDE_K:-WIDE_K] not in genome
                and s[WIDE_K:-WIDE_K] not in rc)
    lengths = [len(s) for s in seqs]
    with open(out, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    row = dict(phase="wide", command=" ".join(["assemble", *opts]),
               genome_bp=len(genome), k=WIDE_K, kc=WIDE_KC, wall_s=wall,
               exact_phase_s=cap.phases(), solid_rows=cap.fill_rows,
               collisions=cap.collisions, contigs=len(seqs),
               total_bases=sum(lengths), n50=_n50(lengths),
               max_contig=max(lengths), contigs_500=len(long_),
               cover_500=sum(len(s) for s in long_) / len(genome),
               not_substring_500=len(off), wrong_500_inside_ends=wrong,
               fasta_sha256=sha,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches,
               nthash_launches=[dict(stage=key[0], shape=list(key[1:3]),
                                     k=key[3], strands=key[4], launches=n)
                                for key, n in sorted(shapes.hist.items())])
    emit(row)
    _check_contigs(row)
    return row, shapes


def phase_wide_shapes(rec: NthashShapes) -> dict:
    """The ntHash kernel at every shape the wide run launched, as
    phase_nthash_shapes does for the main run: launches, graph_ms, bound,
    plain ms, bit-identity.  Also the wide fill's text checksum
    (nthash.kmer_hashes_alt, torch ops) on the codes of its most frequent
    shape: its time, by CUDA events around each call."""
    from abyss_tpu_torch.ops import nthash
    rows, gap = nthash_shape_rows(rec)
    fill = max((key for key in rec.hist if key[0] == "fill"),
               key=lambda key: rec.hist[key])
    codes, k = rec.codes[fill], fill[3]
    alt = dict(shape=list(codes.shape), k=k, form="torch ops",
               ms=median_ms(lambda: nthash.kmer_hashes_alt(codes, k), 21))
    return dict(phase="kernel", kernel="nthash_exact_shapes",
                launches=sum(r["launches"] for r in rows), gap_ms=gap,
                histogram=rows, alt_checksum=alt)


def _cs_copy(src: str, dst: str) -> None:
    """A colour-space FASTA copy of a FASTQ file (anchor base, then the
    colours)."""
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.io import fastx
    with open(dst, "w") as f:
        for rec in fastx.read_fastx(src):
            f.write(f">{rec.id}\n{alphabet.nucleotide_to_colour(rec.seq)}\n")


def phase_exact_parity(tmp: str) -> dict:
    """On the parity phase's reads, on the card and on the CPU: `pe
    engine=exact` at k = 31, `pe long=` (both mate files as long reads,
    exact engine), `pe` on a colour-space copy of the reads (k = 25) and
    `assemble -k 64` (wide) with its snapshot: every artifact
    byte-identical."""
    from abyss_tpu_torch.cli import tools
    from abyss_tpu_torch.pipeline import pe
    paths = [os.path.join(tmp, "p1.fq"), os.path.join(tmp, "p2.fq")]
    cs_paths = [os.path.join(tmp, f"p{i}-cs.fa") for i in (1, 2)]
    for src, dst in zip(paths, cs_paths):
        _cs_copy(src, dst)

    def run_pe(out, device, **kw):
        params = _pe_params("par", kw.pop("reads", paths), out, device)
        params.engine = "exact"
        for name, value in kw.items():
            setattr(params, name, value)
        pe.run(params)

    def run_assemble(out, device):
        os.makedirs(out)
        tools.assemble_main([*paths, "-k", "64", "-o",
                             os.path.join(out, "out.fa"), "--snapshot",
                             os.path.join(out, "snap.kmer"), "--bubbles",
                             os.path.join(out, "bubbles.fa"), "--device",
                             device])

    runs = {"pe_exact": lambda out, dev: run_pe(out, dev),
            "pe_long": lambda out, dev: run_pe(out, dev,
                                               long_files=list(paths)),
            "pe_cs": lambda out, dev: run_pe(out, dev, reads=cs_paths, k=25,
                                             min_pairs=2, min_len=100),
            "assemble_k64": run_assemble}
    row = dict(phase="exact_parity", identical=True, runs={})
    for name, fn in runs.items():
        trees, times = {}, {}
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"exact_parity_{name}_{device}")
            t0 = time.perf_counter()
            fn(out, device)
            times[device] = time.perf_counter() - t0
            trees[device] = _tree_bytes(out)
        gpu, cpu = trees["cuda"], trees["cpu"]
        differ = sorted(n for n in set(gpu) | set(cpu)
                        if gpu.get(n) != cpu.get(n))
        check(not differ, f"exact parity {name}: GPU and CPU artifacts "
                          f"differ: {differ}")
        first = gpu.get("par-1.fa", gpu.get("out.fa", b""))
        check(first.count(b">") > 0, f"exact parity {name}: no contig")
        row["runs"][name] = dict(artifacts=len(gpu), gpu_s=times["cuda"],
                                 cpu_s=times["cpu"])
    check("par-10.fa" in _tree_bytes(os.path.join(
        tmp, "exact_parity_pe_long_cuda")), "pe long= wrote no name-10.fa")
    check("par-cs.fa" in _tree_bytes(os.path.join(
        tmp, "exact_parity_pe_cs_cuda")), "cs pe wrote no name-cs.fa")
    return row



# ---------------------------------------------------------------------------
# the paired DBG and Konnector/Sealer paths

# `paired-dbg -k 80 -K 40 --kc 2`: the JAX package's BASELINE config #4
# (BENCH_NOTES.md, "Paired DBG, span k=80 / K=40")
PAIRED_ARGS = ("-k", "80", "-K", "40", "--kc", "2")
PAIRED_SPAN = 80
# konnector -k 31 on KONN_PAIRS pairs sampled as the fixture's are
# (fragments 500 +- 50, error 0.005) from the genome's first KONN_BP
# bases, the filter built from them: 3.3x, the coverage of
# BENCH_NOTES.md's subset ("Konnector throughput", the fixture's first
# 50,000 pairs) on a 25th of the genome.  That subset takes 1,241 s on
# an H100: at the tool's threshold of 1 all 7 of its chunks overflow
# the device engine's stores and run the host engine.  The coverage
# has to stay: the fixture's first 2,000 pairs (0.13x) merge nothing
# (no path), and 2,000 pairs at 40x merge nothing either (every pair
# meets more than max_paths error bubbles).  The cascade run takes
# KONN_CASCADE_PAIRS pairs of the genome's first KONN_CASCADE_BP bases
# (30x): a filter of k-mers seen twice needs the coverage.
KONN_K = 31
KONN_PAIRS = 2_000
KONN_BP = 180_000
KONN_CASCADE_PAIRS = 1_000
KONN_CASCADE_BP = 10_000
# sealer_ks of the sealer phase, resumed from the pe phase's stage 8
SEALER_KS = (41, 31)
# the parity phase's konnector subset (the device engine on the CPU runs
# a few hundred small tensor ops a BFS level)
PARITY_KONN_PAIRS = 400


def _head_fastq(src: str, dst: str, n: int) -> None:
    """The first n records of a FASTQ file."""
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= 4 * n:
                break
            g.write(line)


class GenomeIndex:
    """ungapped_mismatches' placement of many sequences on a genome, its
    anchors looked up in a sorted array of the genome's packed 32-mers
    on both strands (str.find takes milliseconds a lookup on 4.6 Mbp):
    the same hits in the same order, so the same placements."""

    def __init__(self, genome: str):
        import numpy as np
        from abyss_tpu_torch.core import alphabet
        self.strands = []
        for codes in (alphabet.encode(genome),
                      alphabet.encode(alphabet.revcomp(genome))):
            keys = self._pack(codes)
            order = np.argsort(keys, kind="stable")
            self.strands.append((codes, keys[order], order))

    @staticmethod
    def _pack(codes):
        import numpy as np
        n = len(codes) - 31
        w = np.zeros(max(n, 0), np.uint64)
        for j in range(32):
            w = (w << np.uint64(2)) | codes[j:j + n].astype(np.uint64)
        return w

    def place(self, seq: str) -> list | None:
        """Offsets where seq differs from its placement, or None."""
        found = self.locate(seq)
        return None if found is None else found[0]

    def locate(self, seq: str) -> tuple | None:
        """(differing offsets, strand 0/1, start) of seq's first
        placement (_place), or None."""
        import numpy as np
        from abyss_tpu_torch.core import alphabet
        c = alphabet.encode(seq.upper())

        def hits(strand, off):
            anchor = c[off:off + 32]
            if (anchor > 3).any():   # the genome has no N
                return ()
            _, keys, pos = self.strands[strand]
            key = self._pack(anchor)
            lo = np.searchsorted(keys, key, "left")[0]
            hi = np.searchsorted(keys, key, "right")[0]
            return pos[lo:min(hi, lo + 16)]

        return _place(c, [codes for codes, _, _ in self.strands], hits)

    def explain(self, seq: str) -> dict:
        """Where the two halves of an unplaced sequence place (an indel
        shows as the halves' starts differing by the half length plus
        the indel's size, on one strand)."""
        h = len(seq) // 2
        out = dict(length=len(seq))
        for name, part in (("first_half", seq[:h]), ("second_half", seq[h:])):
            found = self.locate(part)
            out[name] = None if found is None else dict(
                strand=found[1], start=found[2], substitutions=len(found[0]))
        return out


def phase_paired(tmp: str, paths, genome: str) -> tuple:
    """`paired-dbg -k 80 -K 40 --kc 2` (BASELINE config #4, the wide pair
    mode) through the tool's entry point on the card with the main
    phase's reads, launch counts set to 0 just before and read just
    after: the phase spans (count, kc filter, fill, probe, trim, chains,
    emission), the pair rows before and after kc, peak memory, count,
    N50 and sum of the contigs, every ntHash launch by stage and shape;
    the contigs' N-free blocks of 500 bp or more held to the genome with
    the main phase's checks.  Returns its row and the ntHash recorder."""
    import torch
    from abyss_tpu_torch.cli import tools2
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.dbg import paired_dbg
    from abyss_tpu_torch.io import fastx
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.utils import trace
    out = os.path.join(tmp, "paired.fa")
    stages = ((paired_dbg, "_pair_canon_batch", "count"),
              (paired_dbg, "_pair_fill_batch", "fill"))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with NthashShapes(stages) as shapes, trace.recording() as records:
            tools2.paireddbg_main([*paths, *PAIRED_ARGS, "-o", out,
                                   "--device", "cuda"])
    finally:
        launches = dict(kernels.launches)
    seconds = trace.span_seconds(records)
    counts = trace.counter_totals(records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(launches["nthash"] > 0, "kernel nthash was not launched on the "
                                  "paired path")
    seqs = [r.seq for r in fastx.read_fastx(out)]
    check(len(seqs) > 0, "paired: assembled no contig")
    rc = alphabet.revcomp(genome)
    blocks = [b for s in seqs for b in s.split("N") if len(b) >= 500]
    off = [b for b in blocks if b not in genome and b not in rc]
    wrong = sum(1 for b in off if b[PAIRED_SPAN:-PAIRED_SPAN] not in genome
                and b[PAIRED_SPAN:-PAIRED_SPAN] not in rc)
    lengths = [len(s) for s in seqs]
    with open(out, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    row = dict(phase="paired", command=" ".join(["paired-dbg",
                                                 *PAIRED_ARGS]),
               genome_bp=len(genome), wall_s=wall,
               phase_s={n: s for n, s in seconds.items()
                        if n.startswith("paired.")},
               pair_rows=counts.get("paired.rows"),
               pair_rows_kc=counts.get("paired.rows_kc"),
               contigs=len(seqs), total_bases=sum(lengths),
               n50=_n50(lengths), max_contig=max(lengths),
               contigs_with_n=sum("N" in s for s in seqs),
               blocks_500=len(blocks),
               cover_500=sum(len(b) for b in blocks) / len(genome),
               not_substring_500=len(off), wrong_500_inside_ends=wrong,
               fasta_sha256=sha,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches,
               nthash_launches=[dict(stage=key[0], shape=list(key[1:3]),
                                     k=key[3], strands=key[4], launches=n)
                                for key, n in sorted(shapes.hist.items())])
    emit(row)
    _check_contigs(row)
    return row, shapes


class KonnCapture:
    """During a konnector run: the chunks the device engine finished and
    those it handed to the host engine (or never took: a filter it
    cannot search), and the span of connect_pairs_full."""

    def __init__(self):
        self.chunks = 0
        self.device = 0
        self.fallback = 0
        self.search_s = 0.0
        self.connect_s = 0.0

    def wrapped(self):
        from abyss_tpu_torch.gap import konnector, konnector_dev

        def chunk(fn):
            def run(*a, **kw):
                self.chunks += 1
                return fn(*a, **kw)
            return run

        def search(fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.search_s += time.perf_counter() - t0
                self.device += out is not None
                self.fallback += out is None
                return out
            return run

        def connect(fn):
            def run(*a, **kw):
                import torch
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.connect_s += time.perf_counter() - t0
                return out
            return run

        return Patches((konnector, "_connect_chunk", chunk),
                       (konnector_dev, "search", search),
                       (konnector, "connect_pairs_full", connect))

    def fields(self) -> dict:
        return dict(chunks=self.chunks, chunks_device=self.device,
                    chunks_host=self.chunks - self.device,
                    chunks_device_fell_back=self.fallback,
                    device_search_s=self.search_s,
                    connect_s=self.connect_s)


def _run_konnector(argv, env: dict | None = None) -> str:
    """The konnector tool's main with `env` set around it; returns what
    it wrote to stderr (its stats block)."""
    import contextlib
    from abyss_tpu_torch.cli import tools
    saved = {n: os.environ.get(n) for n in (env or {})}
    err = io.StringIO()
    try:
        os.environ.update(env or {})
        with contextlib.redirect_stderr(err):
            tools.konnector_main(argv)
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
    return err.getvalue()


def _merged_reads(prefix: str) -> list:
    from abyss_tpu_torch.io import fastx
    return [r.seq for r in fastx.read_fastx(prefix + "_merged.fa")]


def phase_konnector(tmp: str, genome: str, gidx: GenomeIndex) -> tuple:
    """`konnector -k 31` with its defaults on KONN_PAIRS pairs of the
    genome's first KONN_BP bases (the filter built from them), on the
    card through the tool's entry point, launch counts set to 0 just before and read just
    after: pairs/s, the stats block, the chunks the device engine ran and
    those that fell back, peak memory and every ntHash launch by stage
    and shape; every merged read held to an ungapped placement on the
    genome (the pe phase's rule).  Returns its row and the ntHash
    recorder."""
    import torch
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.gap import konnector
    from abyss_tpu_torch.ops import kernels
    sub = [os.path.join(tmp, f"konn{i}.fq") for i in (1, 2)]
    simulate_reads(alphabet.encode(genome[:KONN_BP]), KONN_PAIRS, 150, 500,
                   50, 0.005, 12, *sub)
    prefix = os.path.join(tmp, "konn")
    cap = KonnCapture()
    stages = ((konnector, "_connect_chunk", "seeds"),
              (konnector, "_solid_windows", "solid_windows"))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with cap.wrapped(), NthashShapes(stages) as shapes:
            summary = _run_konnector([*sub, "-k", str(KONN_K), "-o", prefix,
                                      "--device", "cuda"])
    finally:
        launches = dict(kernels.launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(launches["nthash"] > 0, "kernel nthash was not launched on the "
                                  "konnector path")
    merged = _merged_reads(prefix)
    check(len(merged) > 0, "konnector: merged no pair")
    t1 = time.perf_counter()
    unplaced = [s for s in merged if gidx.place(s) is None]
    row = dict(phase="konnector", k=KONN_K, pairs=KONN_PAIRS,
               region_bp=KONN_BP, wall_s=wall,
               pairs_per_s=KONN_PAIRS / cap.connect_s, **cap.fields(),
               merged=len(merged), stats=summary.strip().splitlines(),
               merged_unplaced=len(unplaced),
               unplaced_examples=[gidx.explain(s) for s in unplaced[:3]],
               placement_s=time.perf_counter() - t1,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches,
               nthash_launches=[dict(stage=key[0], shape=list(key[1:3]),
                                     k=key[3], strands=key[4], launches=n)
                                for key, n in sorted(shapes.hist.items())])
    emit(row)
    check(not unplaced, f"konnector: {len(unplaced)} merged reads have no "
                        f"ungapped placement on the genome with at most "
                        f"{MAX_SUBS_PER_WINDOW} substitutions in "
                        f"{SUBS_WINDOW} bases")
    return row, shapes


def phase_konnector_cascade(tmp: str, genome: str) -> tuple:
    """`konnector -k 31 --cascade 2 --extend` with
    ABYSS_TPU_KONN_FILTER=cascade on KONN_CASCADE_PAIRS pairs of the
    genome's first KONN_CASCADE_BP bases: the cascading Bloom filter's inserts (the scatter-max kernel), the
    host search engine and the walks of --extend on the cascade (the
    cascade variants of the walk and look-ahead kernels), launch counts
    set to 0 just before and read just after.  Returns its row and the
    run's walk and look-ahead launches (WalkCalls)."""
    import torch
    from abyss_tpu_torch.dbg import extend as ext
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.core import alphabet
    sub = [os.path.join(tmp, f"kc{i}.fq") for i in (1, 2)]
    simulate_reads(alphabet.encode(genome[:KONN_CASCADE_BP]),
                   KONN_CASCADE_PAIRS, 150, 500, 50, 0.005, 13, *sub)
    prefix = os.path.join(tmp, "konn_cascade")
    cap = KonnCapture()
    walk_filters = []

    def keep(fn):
        return lambda cbf: walk_filters.append(fn(cbf)) or walk_filters[-1]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with cap.wrapped(), Patches((ext, "walk_filter", keep)), \
                WalkCalls() as calls:
            summary = _run_konnector(
                [*sub, "-k", str(KONN_K), "--cascade", "2", "--extend", "-o",
                 prefix, "--device", "cuda"],
                {"ABYSS_TPU_KONN_FILTER": "cascade"})
    finally:
        launches = dict(kernels.launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for name in ("nthash", "scatter_max", "walk_cascade", "branch_cascade"):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
                                  "konnector cascade path")
    check(cap.device == 0 and cap.chunks > 0,
          "konnector cascade: a chunk did not take the host engine")
    check(len(walk_filters) == 1 and hasattr(walk_filters[0], "levels"),
          "konnector cascade: --extend walked no single cascading filter")
    merged = _merged_reads(prefix)
    check(len(merged) > 0, "konnector cascade: merged no pair")
    row = dict(phase="konnector_cascade", k=KONN_K,
               pairs=KONN_CASCADE_PAIRS, wall_s=wall, **cap.fields(),
               merged=len(merged),
               merged_bases=sum(len(s) for s in merged),
               stats=summary.strip().splitlines(),
               filter_bytes=walk_filters[0].levels.numel(),
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    emit(row)
    return row, calls


def phase_sealer(tmp: str, paths, gidx: GenomeIndex) -> dict:
    """The pe phase's output directory resumed with sealer_ks="41 31", so
    that only stage_sealer (and the stats) run, launch counts set to 0
    just before and read just after: gaps closed of total and the
    sealer's span; each sealed scaffold's N-free blocks of 500 bp or
    more held to the pe phase's placement rule."""
    import torch
    from abyss_tpu_torch.gap import sealer
    from abyss_tpu_torch.io import fastx
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.pipeline import pe
    from abyss_tpu_torch.utils import trace
    out = os.path.join(tmp, "pe")
    check(os.path.exists(os.path.join(out, "pe-8.fa")),
          "sealer: the pe phase left no pe-8.fa")
    params = _pe_params("pe", paths, out, "cuda")
    params.sealer_ks = list(SEALER_KS)
    stats = []

    def keep_stats(fn):
        def run(*a, **kw):
            sealed, st = fn(*a, **kw)
            stats.append(st)
            return sealed, st
        return run

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with Patches((sealer, "seal", keep_stats)), \
                trace.recording() as records:
            pe.run(params)
    finally:
        launches = dict(kernels.launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(stats) == 1, "sealer: stage_sealer did not run once")
    check(launches["nthash"] > 0, "kernel nthash was not launched on the "
                                  "sealer path")
    sealed = [(r.id, r.seq)
              for r in fastx.read_fastx(params.path("8-sealed.fa"))]
    before = {r.id: r.seq for r in fastx.read_fastx(params.path("8.fa"))}
    blocks = [(n, b) for n, s in sealed for b in s.split("N")
              if len(b) >= 500]
    placed = [gidx.place(b) for _, b in blocks]
    # an unplaced block: where its halves place, and where the blocks of
    # its scaffold before sealing (the gaps' flanks) sit in it and on
    # the genome
    unplaced, duplications = [], 0
    for (name, b), p in zip(blocks, placed):
        if p is not None:
            continue
        parts = _flank_parts(b, before.get(name, ""), gidx)
        dup = _overlap_duplication(parts, len(b), max(SEALER_KS))
        duplications += dup
        if len(unplaced) < 3:
            unplaced.append(dict(gidx.explain(b), scaffold=name, parts=parts,
                                 overlap_duplication=dup))
    with open(params.path("8-sealed.fa"), "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    row = dict(phase="sealer", sealer_ks=list(SEALER_KS), wall_s=wall,
               sealer_s=trace.span_seconds(records).get("pe.sealer", 0.0),
               gaps=stats[0].gaps, closed=stats[0].closed,
               scaffolds=len(sealed),
               scaffolds_with_gap=sum("N" in s for _, s in sealed),
               blocks_500=len(blocks),
               blocks_500_unplaced=sum(p is None for p in placed),
               blocks_500_overlap_duplications=duplications,
               unplaced_examples=unplaced,
               substitutions_500=sum(len(p) for p in placed if p),
               sha256_8_sealed=sha,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    emit(row)
    wrong = row["blocks_500_unplaced"] - duplications
    check(wrong == 0,
          f"sealer: {wrong} N-free blocks >= 500 bp of the sealed scaffolds "
          f"have no ungapped placement on the genome (besides "
          f"{duplications} whose only fault is a gap between flanks that "
          f"overlap by fewer than {max(SEALER_KS)} bases, closed by "
          f"writing the overlap twice)")
    return row


def _flank_parts(block: str, before: str, gidx: GenomeIndex) -> list:
    """Where the blocks of a scaffold before sealing (the flanks of its
    gaps) sit in one of its sealed blocks and on the genome: offset and
    length in the block, strand and start of their placement."""
    parts = []
    for q in before.split("N"):
        where = gidx.locate(q) if len(q) >= 32 and q in block else None
        if where is not None:
            parts.append(dict(offset=block.find(q), length=len(q),
                              strand=where[1], start=where[2]))
    return parts


def _overlap_duplication(parts: list, length: int, limit: int) -> bool:
    """Whether a sealed block's only departures from the genome are gaps
    between overlapping flanks that the sealer closed with an empty
    interior, so that the overlap is written twice (abyss_tpu's
    `gap/sealer.seal`, ROADMAP section C).  parts: the blocks of the
    block's scaffold before sealing, each with its offset and length in
    the block and its strand and start on the genome.  They must cover
    the block end to end, on one strand; at each junction the next part
    either starts as far along the genome as along the block, or starts
    right where the last one ends in the block while on the genome it
    starts 1 to limit - 1 bases before the last one's end: an overlap
    shorter than `limit`, never a backward or distant join."""
    parts = sorted(parts, key=lambda q: q["offset"])
    if not parts or parts[0]["offset"] != 0 or \
            parts[-1]["offset"] + parts[-1]["length"] != length or \
            len({q["strand"] for q in parts}) != 1:
        return False
    dup = False
    for a, b in zip(parts, parts[1:]):
        if b["start"] - a["start"] == b["offset"] - a["offset"]:
            continue
        overlap = a["start"] + a["length"] - b["start"]
        if b["offset"] == a["offset"] + a["length"] and \
                b["start"] > a["start"] and 0 < overlap < limit:
            dup = True
            continue
        return False
    return dup


def phase_paired_parity(tmp: str) -> dict:
    """On the parity phase's reads, on the card and on the CPU, every
    output byte-identical: `paired-dbg` packed (-k 40 -K 14) and wide
    (-k 80 -K 40); `pe k=50 K=25` (every artifact); `konnector -k 25` on
    the first PARITY_KONN_PAIRS pairs with the device engine, with
    ABYSS_TPU_KONNECTOR=host and with --cascade 2 --extend
    (ABYSS_TPU_KONN_FILTER=cascade); and `pe sealer_ks="31 25"` resumed
    from the pe_parity phase's stage 8."""
    from abyss_tpu_torch.cli import tools2
    from abyss_tpu_torch.pipeline import pe
    paths = [os.path.join(tmp, "p1.fq"), os.path.join(tmp, "p2.fq")]
    sub = [os.path.join(tmp, f"pk{i}.fq") for i in (1, 2)]
    for src, dst in zip(paths, sub):
        _head_fastq(src, dst, PARITY_KONN_PAIRS)

    def paired(kk, KK):
        def run(out, dev):
            os.makedirs(out)
            tools2.paireddbg_main([*paths, "-k", kk, "-K", KK, "-o",
                                   os.path.join(out, "out.fa"), "--device",
                                   dev])
        return run

    def pe_paired(out, dev):
        params = _pe_params("par", paths, out, dev)
        params.k, params.K = 50, 25
        pe.run(params)

    engines = {}

    def konn(name, opts, env=None):
        def run(out, dev):
            os.makedirs(out)
            cap = KonnCapture()
            with cap.wrapped():
                _run_konnector([*sub, "-k", "25", *opts, "-o",
                                os.path.join(out, "konn"), "--device", dev],
                               env)
            engines[name, dev] = cap.fields()
        return run

    def sealed(out, dev):
        src = os.path.join(tmp, "pe_parity_cuda")
        shutil.copytree(src, out, symlinks=True)
        params = _pe_params("par", paths, out, dev)
        params.sealer_ks = [31, 25]
        pe.run(params)

    runs = {"paired_packed_k40_K14": paired("40", "14"),
            "paired_wide_k80_K40": paired("80", "40"),
            "pe_k50_K25": pe_paired,
            "konnector_device": konn("konnector_device", []),
            "konnector_host": konn("konnector_host", [],
                                   {"ABYSS_TPU_KONNECTOR": "host"}),
            "konnector_cascade_extend": konn(
                "konnector_cascade_extend", ["--cascade", "2", "--extend"],
                {"ABYSS_TPU_KONN_FILTER": "cascade"}),
            "pe_sealer_ks": sealed}
    row = dict(phase="paired_parity", identical=True, runs={})
    for name, fn in runs.items():
        trees, times = {}, {}
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"paired_parity_{name}_{device}")
            t0 = time.perf_counter()
            fn(out, device)
            times[device] = time.perf_counter() - t0
            trees[device] = _tree_bytes(out)
        gpu, cpu = trees["cuda"], trees["cpu"]
        differ = sorted(n for n in set(gpu) | set(cpu)
                        if gpu.get(n) != cpu.get(n))
        check(not differ, f"paired parity {name}: GPU and CPU outputs "
                          f"differ: {differ}")
        first = gpu.get("out.fa", gpu.get("par-1.fa",
                                          gpu.get("konn_merged.fa", b"")))
        if name == "pe_sealer_ks":
            first = gpu.get("par-8-sealed.fa", b"")
        check(first.count(b">") > 0, f"paired parity {name}: empty output")
        row["runs"][name] = dict(files=len(gpu), gpu_s=times["cuda"],
                                 cpu_s=times["cpu"])
        if (name, "cuda") in engines:
            row["runs"][name]["engines"] = engines[name, "cuda"]
    check(engines["konnector_device", "cuda"]["chunks_device"] > 0,
          "paired parity: the konnector device engine finished no chunk")
    return row


# the tool suite: the tools_parity and tools phases
TOOLS_K = 25                     # k of the tools_parity inputs
LOGCOUNTER_K = 31
LOGCOUNTER_CELLS = 1 << 30       # logcounter -b: 2^30 one-byte cells, 1 GiB
LOGCOUNTER_HELD_BATCHES = 4      # card == CPU counters on the first batches
PLC_SAMPLE_KMERS = 1000          # genome k-mers whose PLC counts are read
PLC_MEDIAN_RATIO = (0.5, 2.0)    # decoded / exact count, median
FM_PATTERNS = 1000               # count/locate queries of the 4.6 Mbp index
FM_PATTERN_LEN = 40
FM_ORDER_PAIRS = 2000            # adjacent suffix pairs checked in order
FM_SA_HELD = 1 << 21             # card == CPU suffix array on these bases
PARITY_TOOL_VARIANTS = 6         # low-coverage copies of the bubble contig


def _run_tool(main, argv, workdir: str) -> tuple:
    """main(argv) with workdir as the working directory and stdout and
    stderr captured: (its return value, or the type and text of the
    exception it raised; stdout; stderr)."""
    import contextlib
    out, err = io.StringIO(), io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                result = main(argv)
            except Exception as e:     # compared between the devices
                result = f"{type(e).__name__}: {e}"
    finally:
        os.chdir(cwd)
    return result, out.getvalue(), err.getvalue()


def _write_fasta(path: str, recs) -> None:
    with open(path, "w") as f:
        for name, seq in recs:
            f.write(f">{name}\n{seq}\n")


def _tools_inputs(d: str, reads) -> dict:
    """The inputs of tools_parity, from the parity genome and its reads:
    the genome, four overlapping contigs, a contig chain with k-1
    overlaps whose second contig has PARITY_TOOL_VARIANTS one-base
    variants (a bubble of 7 branches, so PathConsensus aligns them on
    the device) with its graph and an ambiguous path across it, a
    scaffold with a 30 bp gap, linked reads and the first 1,000 pairs.
    Returns {name: absolute path}."""
    import numpy as np
    from abyss_tpu_torch.graph import adjlist, graphio
    g = _parity_genome()
    p = {n: os.path.join(d, n) for n in (
        "genome.fa", "contigs.fa", "bub.fa", "bub.dot", "amb.path",
        "scaf.fa", "lr.fq", "h1.fq")}
    p["r1"], p["r2"] = reads
    _write_fasta(p["genome.fa"], [("ref", g)])
    with open(p["contigs.fa"], "w") as f:
        for i, (a, b) in enumerate(((0, 5100), (5000, 10100),
                                    (10000, 15100), (15000, 20000))):
            f.write(f">{i} {b - a} 99\n{g[a:b]}\n")
    k1 = TOOLS_K - 1
    chain = [g[a:b] for a, b in ((0, 3000), (3000 - k1, 6000),
                                 (6000 - k1, 9000), (9000 - k1, 12000))]
    mid = chain[1]
    seqs, covs = list(chain), [500, 400, 450, 520]
    for v in range(PARITY_TOOL_VARIANTS):
        at = 200 + 400 * v
        seqs.append(mid[:at] + "ACGT"[("ACGT".index(mid[at]) + 1) % 4]
                    + mid[at + 1:])
        covs.append(10 + v)
    with open(p["bub.fa"], "w") as f:
        for i, (s, c) in enumerate(zip(seqs, covs)):
            f.write(f">{i} {len(s)} {c}\n{s}\n")
    graph = adjlist.build_overlap_graph(
        [(str(i), s) for i, s in enumerate(seqs)], TOOLS_K, covs)
    graphio.write_dot(graph, p["bub.dot"], k=TOOLS_K)
    with open(p["amb.path"], "w") as f:    # the gap spans contig 1
        f.write(f"20\t0+ {len(mid) - k1}N 2+ 3+\n")
    _write_fasta(p["scaf.fa"], [("s0", g[:8000] + "N" * 30 + g[8030:16000])])
    rng = np.random.default_rng(12)
    with open(p["lr.fq"], "w") as f:
        for mol in range(150):
            start = int(rng.integers(0, len(g) - 2000))
            for r in range(12):
                at = start + int(rng.integers(0, 2000 - 60))
                f.write(f"@m{mol}r{r} BX:Z:BC{mol:04d}\n{g[at:at + 60]}\n"
                        f"+\n{'I' * 60}\n")
    _head_fastq(reads[0], p["h1.fq"], 1000)
    return p


def _parity_tool_runs(p: dict) -> dict:
    """{tool: (entry point, arguments)} for every tool that takes
    --device, except paired-dbg (the paired_parity phase's)."""
    from abyss_tpu_torch.align import wrappers
    from abyss_tpu_torch.cli import tools2
    reads = [p["r1"], p["r2"]]
    runs = {
        "map": (tools2.map_main, [*reads, p["contigs.fa"], "-l", "32"]),
        "index": (tools2.index_main, [p["contigs.fa"]]),
        "count": (tools2.count_main, ["-k", "40", p["contigs.fa"]]),
        "distanceest": (tools2.distanceest_main, [
            *reads, "--target", p["contigs.fa"], "--dot", "-n", "1", "-o",
            "out.dist.dot", "--hist", "h.hist", "-k", str(TOOLS_K)]),
        "pathconsensus": (tools2.pathconsensus_main, [
            p["bub.fa"], p["bub.dot"], p["amb.path"], "-k", str(TOOLS_K),
            "-a", "8", "-o", "out.path", "-s", "cons.fa", "-g", "pc.dot"]),
        "rresolver": (tools2.rresolver_main, [
            p["bub.fa"], p["bub.dot"], *reads, "-k", str(TOOLS_K), "-o",
            "rr.dot"]),
        "consensus": (tools2.consensus_main, [p["contigs.fa"], *reads, "-o",
                                              "cons.fa"]),
        "gapfill": (tools2.gapfill_main, [p["scaf.fa"], *reads, "-k",
                                          str(TOOLS_K), "-b", "4M", "-o",
                                          "sealed.fa"]),
        # k > 32: the wide table, which hashes with the ntHash kernel
        "kmerprint": (tools2.kmerprint_main, [p["h1.fq"], "-k", "40"]),
        "logcounter": (tools2.logcounter_main, [*reads, "-k", str(TOOLS_K),
                                                "-b", "1000003"]),
        "samtobreak": (tools2.samtobreak_main, [p["genome.fa"],
                                                p["contigs.fa"]]),
        "tigmint": (tools2.tigmint_main, [p["contigs.fa"], p["lr.fq"], "-o",
                                          "cut.fa", "--bed", "mol.bed", "-d",
                                          "2000"]),
        "arcs": (tools2.arcs_main, [p["contigs.fa"], p["lr.fq"], "-e", "2000",
                                    "-n", "2", "-s", "400", "-o",
                                    "links.dot"])}
    for name in ("bwa", "bwamem", "bowtie2", "kaligner", "dida"):
        runs[name] = (getattr(wrappers, name + "_main"),
                      [p["contigs.fa"], p["r1"]])
    return runs


def phase_tools_parity(tmp: str) -> dict:
    """Every tool that takes --device, on the parity phase's reads, with
    --device cuda and with --device cpu: the same return value (`index`
    raises abyss_tpu's AttributeError on both), stdout, stderr and
    files, byte for byte.  Each tool's kernel launches on the card are
    recorded."""
    from abyss_tpu_torch.ops import kernels
    inp = os.path.join(tmp, "tools_inputs")
    os.makedirs(inp)
    p = _tools_inputs(inp, [os.path.join(tmp, "p1.fq"),
                            os.path.join(tmp, "p2.fq")])
    row = dict(phase="tools_parity", identical=True, runs={})
    for name, (main, argv) in _parity_tool_runs(p).items():
        res, times = {}, {}
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"tools_parity_{name}_{device}")
            os.makedirs(out)
            kernels.reset_launches()
            t0 = time.perf_counter()
            result, stdout, stderr = _run_tool(main, argv + ["--device",
                                                             device], out)
            times[device] = time.perf_counter() - t0
            if device == "cuda":
                launched = {k: v for k, v in kernels.launches.items() if v}
            res[device] = (result, stdout, stderr, _tree_bytes(out))
        gpu, cpu = res["cuda"], res["cpu"]
        for i, what in enumerate(("return value", "stdout", "stderr")):
            check(gpu[i] == cpu[i], f"tools parity {name}: the {what} "
                                    f"differs between GPU and CPU")
        differ = sorted(n for n in set(gpu[3]) | set(cpu[3])
                        if gpu[3].get(n) != cpu[3].get(n))
        check(not differ, f"tools parity {name}: files differ: {differ}")
        if name == "pathconsensus":
            check(gpu[3].get("cons.fa", b"").count(b">") == 1,
                  "tools parity pathconsensus: the bubble was not merged")
        if name == "index":
            check(str(gpu[0]).startswith("AttributeError") and not gpu[3],
                  f"tools parity index: expected abyss_tpu's AttributeError "
                  f"and no file, got {gpu[0]!r}")
        else:
            check(gpu[0] in (0, None) and (gpu[1] or gpu[2] or gpu[3]),
                  f"tools parity {name}: returned {gpu[0]!r} with no output")
        row["runs"][name] = dict(gpu_s=times["cuda"], cpu_s=times["cpu"],
                                 stdout_bytes=len(gpu[1]),
                                 files=sorted(gpu[3]), launches=launched,
                                 stderr=gpu[2].strip().splitlines()[-6:])
    for name in ("map", "count", "kmerprint", "logcounter"):
        check(row["runs"][name]["launches"].get("nthash", 0) > 0,
              f"tools parity {name}: the ntHash kernel was not launched")
    check(row["runs"]["logcounter"]["launches"].get("scatter_max", 0) > 0,
          "tools parity logcounter: the scatter-max kernel was not launched")
    return row


def _kmer_counts(paths, k: int, targets) -> tuple:
    """One pass over the reads: the windows the CPU port marks valid
    (nthash.valid_windows on the host), and the exact count of each of
    the sorted unique canonical hashes `targets` (on the card)."""
    import torch
    from abyss_tpu_torch import u64
    from abyss_tpu_torch.io import read_batches
    from abyss_tpu_torch.ops import nthash
    exact = torch.zeros(len(targets), dtype=torch.int64,
                        device=targets.device)
    n_cpu = 0
    for batch in read_batches(paths, 4096, 512):
        codes = torch.from_numpy(batch.codes)
        n_cpu += int(nthash.valid_windows(codes, k).sum())
        canon, valid = nthash.canonical_hashes(codes.to(targets.device), k)
        c = canon[valid]
        at = u64.usearchsorted(targets, c).clamp(max=len(targets) - 1)
        hit = targets[at] == c
        exact += torch.bincount(at[hit], minlength=len(targets))
    return n_cpu, exact


def _host_find_all(text: str, pat: str) -> list:
    out, at = [], text.find(pat)
    while at >= 0:
        out.append(at)
        at = text.find(pat, at + 1)
    return out


def _suffix_order_ok(tb: bytes, sa, pairs) -> bool:
    """sa[i] sorts before sa[i + 1] for each i of pairs (suffixes compared
    on their first 4 kbp, in full where those agree)."""
    for i in pairs:
        a, b = int(sa[i]), int(sa[i + 1])
        x, y = tb[a:a + 4096], tb[b:b + 4096]
        if x == y:
            x, y = tb[a:], tb[b:]
        if not x < y:
            return False
    return True


def phase_tools(tmp: str, paths, genome: str) -> tuple:
    """The tool suite at full size on the card.  `logcounter -k 31 -b
    2^30` through its entry point on the fixture's reads, launch counts
    reset just before and read just after: wall time, k-mers inserted
    (equal to the windows the CPU port marks valid), the counters'
    sha256 and nonzero cells, one scatter-max batch kept for the replay;
    the first LOGCOUNTER_HELD_BATCHES x 4,096 reads on the card and on the
    CPU (counters equal); the decoded counts of PLC_SAMPLE_KMERS genome
    k-mers against their exact counts in the reads.  Then FMIndex.build
    of the genome (the device suffix array: rounds, wall time, a
    permutation in suffix order at FM_ORDER_PAIRS sampled places),
    count and locate of FM_PATTERNS 40-mers against a host search of
    the genome, and the suffix array of the genome's first FM_SA_HELD
    bases on the card and on the CPU.  Returns the row and the replay's
    scatter-max row."""
    import numpy as np
    import torch
    from abyss_tpu_torch import u64
    from abyss_tpu_torch.align import fmindex
    from abyss_tpu_torch.cli import tools2
    from abyss_tpu_torch.core import alphabet
    from abyss_tpu_torch.ops import kernels, nthash
    from abyss_tpu_torch.ops import plc as plc_mod
    k, size = LOGCOUNTER_K, LOGCOUNTER_CELLS
    row = dict(phase="tools")
    runs, capture = [], {}
    logcounter, scatter = tools2.logcounter, plc_mod.scatter_max_u8

    def keep(*a, **kw):
        runs.append(logcounter(*a, **kw))
        return runs[-1]

    def recording(counters, idx, val):
        n = capture.setdefault("calls", 0)
        if n == CAPTURE_BATCH:
            capture.update(before=counters.clone(), idx=idx.clone(),
                           val=val.clone())
        out = scatter(counters, idx, val)
        if n == CAPTURE_BATCH:
            capture["after"] = counters.clone()
        capture["calls"] = n + 1
        return out

    argv = ["-k", str(k), "-b", str(size), *paths]
    with Patches() as patches:
        patches.patch(tools2, "logcounter", keep)
        patches.patch(plc_mod, "scatter_max_u8", recording)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            result, _, err = _run_tool(tools2.logcounter_main, argv, tmp)
            torch.cuda.synchronize()
        finally:
            launches = dict(kernels.launches)
        wall = time.perf_counter() - t0
    check(result == 0 and len(runs) == 1, f"logcounter failed: {result!r}")
    plc, n = runs[0]
    batches = capture["calls"]
    check(err == f"inserted {n} k-mers into a {size}-cell PLC array\n",
          f"logcounter printed {err!r}")
    for name in ("nthash", "scatter_max"):
        check(launches[name] == batches, f"logcounter launched {name} "
              f"{launches[name]} times over {batches} batches")
    check("after" in capture, f"logcounter ran fewer than "
                              f"{CAPTURE_BATCH + 1} batches")
    counters = plc.counters
    host = counters.cpu().numpy()
    lc = dict(command="logcounter " + " ".join(argv[:4]), wall_s=wall,
              batches=batches, kmers_inserted=n, launches=launches,
              counters_sha256=hashlib.sha256(host.tobytes()).hexdigest(),
              nonzero_cells=int(np.count_nonzero(host)),
              max_code=int(host.max()))
    del host
    # the decoded counts of genome k-mers against their exact counts
    rng = np.random.default_rng(2026)
    codes = alphabet.encode(genome)
    at = rng.integers(0, len(codes) - k + 1, PLC_SAMPLE_KMERS)
    sample = torch.from_numpy(codes[at[:, None] + np.arange(k)])
    canon = nthash.kmer_hashes_plain(sample, k)[2][:, 0].cuda()
    targets, inverse = torch.unique(canon, return_inverse=True)
    targets, order = u64.usort(targets)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order), device=order.device)
    t1 = time.perf_counter()
    n_cpu, exact = _kmer_counts(paths, k, targets)
    lc["second_pass_s"] = time.perf_counter() - t1
    check(n_cpu == n, f"logcounter inserted {n} k-mers, the CPU port's "
                      f"valid windows are {n_cpu}")
    lc["kmers_cpu"] = n_cpu
    exact = exact[rank[inverse]].double()
    decoded = plc.count(u64.umod(canon, size)).double()
    seen = exact > 0
    ratio = (decoded[seen] / exact[seen]).cpu().numpy()
    q10, med, q90 = (float(x) for x in np.quantile(ratio, [0.1, 0.5, 0.9]))
    lc.update(sampled_kmers=PLC_SAMPLE_KMERS, sampled_seen=int(seen.sum()),
              exact_count_median=float(exact.median()),
              ratio_median=med, ratio_p10=q10, ratio_p90=q90)
    check(PLC_MEDIAN_RATIO[0] <= med <= PLC_MEDIAN_RATIO[1],
          f"logcounter: median decoded / exact count {med:.3f} outside "
          f"{PLC_MEDIAN_RATIO}")
    del plc, runs, counters
    torch.cuda.empty_cache()
    # the first batches on the card and on the CPU: read_batches takes
    # the files in turn, so these are the first reads of the first file
    head = os.path.join(tmp, "logcounter_head.fq")
    _head_fastq(paths[0], head, LOGCOUNTER_HELD_BATCHES * 4096)
    held = {}
    for device in ("cuda", "cpu"):
        t1 = time.perf_counter()
        arr, m = tools2.logcounter([head], k, size, device)
        held[device] = (arr.counters.cpu(), m, time.perf_counter() - t1)
        del arr
    check(held["cuda"][1] == held["cpu"][1] and
          torch.equal(held["cuda"][0], held["cpu"][0]),
          f"logcounter's first {LOGCOUNTER_HELD_BATCHES} batches: card and "
          "CPU counters differ")
    lc.update(held_batches=LOGCOUNTER_HELD_BATCHES, held_equal=True,
              held_kmers=held["cpu"][1], held_gpu_s=held["cuda"][2],
              held_cpu_s=held["cpu"][2])
    del held
    row["logcounter"] = lc
    replay = dict(phase="kernel", kernel="scatter_max_plc",
                  **scatter_replay(capture), batch=CAPTURE_BATCH)
    del capture
    torch.cuda.empty_cache()

    # the FM-index of the genome: its suffix array on the card
    sas, rounds = [], [0]
    suffix_array, doubling = fmindex.suffix_array, fmindex._doubling_round

    def keep_sa(*a, **kw):
        sas.append(suffix_array(*a, **kw))
        return sas[-1]

    def count_round(*a, **kw):
        rounds[0] += 1
        return doubling(*a, **kw)

    with Patches() as patches:
        patches.patch(fmindex, "suffix_array", keep_sa)
        patches.patch(fmindex, "_doubling_round", count_round)
        t1 = time.perf_counter()
        fm = fmindex.FMIndex.build(codes, device="cuda")
        build_s = time.perf_counter() - t1
    sa = sas[0]
    n_text = len(codes) + 1
    check(rounds[0] > 0 and n_text >= fmindex._DEVICE_MIN,
          "FMIndex.build did not take the device branch")
    perm = bool(np.array_equal(np.bincount(sa, minlength=n_text),
                               np.ones(n_text, np.int64)))
    check(perm, "the genome's suffix array is not a permutation")
    tb = (np.concatenate([codes.astype(np.int64) + 1, [0]])
          .astype(np.uint8).tobytes())
    pairs = rng.integers(0, n_text - 1, FM_ORDER_PAIRS)
    check(_suffix_order_ok(tb, sa, pairs),
          "the genome's suffix array is out of order")
    t1 = time.perf_counter()
    counted = located = 0
    for i in range(FM_PATTERNS):
        if i % 10 == 9:     # one in ten: random bases, mostly absent
            pat = "".join("ACGT"[c] for c in rng.integers(0, 4,
                                                          FM_PATTERN_LEN))
        else:
            s = int(rng.integers(0, len(genome) - FM_PATTERN_LEN))
            pat = genome[s:s + FM_PATTERN_LEN]
        want = _host_find_all(genome, pat)
        pc = alphabet.encode(pat)
        check(fm.count(pc) == len(want), f"FM count of {pat} is "
              f"{fm.count(pc)}, the host search finds {len(want)}")
        check(fm.locate(pc) == want, f"FM locate of {pat} differs from the "
                                     "host search")
        counted += 1
        located += len(want)
    query_s = time.perf_counter() - t1
    head = np.concatenate([codes[:FM_SA_HELD].astype(np.int64) + 1, [0]])
    t1 = time.perf_counter()
    sa_gpu = fmindex._suffix_array_device(head, "cuda")
    t2 = time.perf_counter()
    sa_cpu = fmindex._suffix_array_device(head, "cpu")
    t3 = time.perf_counter()
    check(np.array_equal(sa_gpu, sa_cpu), f"the suffix array of the first "
          f"{FM_SA_HELD} bases differs between the card and the CPU")
    row["fmindex"] = dict(
        bases=len(codes), device_branch=True, rounds=rounds[0],
        build_s=build_s, bytes_per_base=(
            fm.bwt.nbytes + fm.occ_ck.nbytes + fm.sa_vals.nbytes
            + fm.sa_mask.nbytes + fm.sa_rank.nbytes) / fm.n,
        permutation=perm, order_pairs=FM_ORDER_PAIRS,
        patterns=counted, occurrences=located, query_s=query_s,
        held_bases=FM_SA_HELD, held_equal=True, held_gpu_s=t2 - t1,
        held_cpu_s=t3 - t2)
    emit(row)
    return row, replay


# ---------------------------------------------------------------------------
# multi-device stage 1 (pe np= / nh=) on meshes of this one card

# pe np= / nh= configurations run card against CPU on the parity reads:
# (name, engine, np, nh, k) through pe.stage_unitigs_1 on an explicit
# mesh of np x nh copies of one device
MESH_PARITY_CONFIGS = (("exact_k31_np4", "exact", 4, 1, 31),
                       ("exact_k64_np4", "exact", 4, 1, 64),
                       ("exact_np3", "exact", 3, 1, 31),
                       ("exact_2x2", "exact", 2, 2, 31),
                       ("bloom_np2", "bloom", 2, 1, 31),
                       ("bloom_np4", "bloom", 4, 1, 31))
MESH_EXACT_NP = 4                 # the mesh_exact table's shards
# the bloom engine's filter in mesh_parity (the parity phase's 4 MiB)
# and in mesh_bloom (2^30 counters, as the tool and logcounter phases'):
# pe's default 64 MiB (2^26 counters) holds the 4.6 Mbp reads' ~25 M
# distinct k-mers so densely that false positives join unrelated
# sequence (178 contigs of 500 bp or more off the genome at np = 2, in
# the first chip run of this phase)
MESH_PARITY_BLOOM_BYTES = 1 << 22
MESH_BLOOM_BYTES = 1 << 30
# mesh_parity's batches: the parity phase's read length, 4,096 reads a
# batch (pe's 16,384 would pad the 6,000 reads into one batch of
# mostly empty rows, which the CPU's plain walks pay for)
MESH_PARITY_BATCH = (4096, 128)
MESH_REPLAY = 3                   # walk / look-ahead launches replayed
MESH_LOAD_CAPTURE = 9             # the load step's scatter-max replayed


def _mesh_params(name: str, paths, outdir: str, device: str, engine: str,
                 np_: int, nh: int = 1, k: int = 31, bloom_bytes=None,
                 batch=None):
    params = _pe_params(name, paths, outdir, device)
    params.engine, params.np_devices, params.n_hosts, params.k = \
        engine, np_, nh, k
    if bloom_bytes is not None:
        params.bloom_bytes = bloom_bytes
    if batch is not None:
        params.batch_size, params.max_read_len = batch
    os.makedirs(outdir)
    return params


def _mesh_devices() -> list:
    """The device the full-size mesh phases repeat: cuda:0 (one card
    stands for the mesh)."""
    import torch
    return [torch.device("cuda", 0)]


def phase_mesh_parity(tmp: str) -> dict:
    """pe's stage 1 over np x nh devices (pe.stage_unitigs_1 with an
    explicit mesh, as pe calls it) on the parity phase's reads, on a
    mesh of copies of the card and of the CPU: the sharded exact engine
    at k = 31 and 64, the non-power-of-two count (np = 3), the 2 x 2
    host mesh and the bloom engine at np = 2 and 4 (a 4 MiB filter),
    in batches of 4,096 reads; name-1.fa byte-identical, with each card
    run's kernel launches.  Where the
    machine has two cards or more, the np = 4 configurations run again on
    a mesh of distinct cards (np = 2 of them, each twice)."""
    import torch
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.pipeline import pe
    paths = [os.path.join(tmp, "p1.fq"), os.path.join(tmp, "p2.fq")]
    row = dict(phase="mesh_parity", mesh_kind="copies of cuda:0",
               cards=torch.cuda.device_count(), runs={})
    for name, engine, np_, nh, k in MESH_PARITY_CONFIGS:
        fa, times = {}, {}
        for dev in (torch.device("cuda", 0), torch.device("cpu")):
            params = _mesh_params("mp", paths, os.path.join(
                tmp, f"mesh_parity_{name}_{dev.type}"), dev.type, engine,
                np_, nh, k, MESH_PARITY_BLOOM_BYTES, MESH_PARITY_BATCH)
            kernels.reset_launches()
            t0 = time.perf_counter()
            pe.stage_unitigs_1(params, devices=[dev] * (np_ * nh))
            times[dev.type] = time.perf_counter() - t0
            if dev.type == "cuda":
                launches = {n: c for n, c in kernels.launches.items() if c}
            with open(params.path("1.fa"), "rb") as f:
                fa[dev.type] = f.read()
        check(fa["cuda"] == fa["cpu"], f"mesh parity {name}: card and CPU "
                                       "name-1.fa differ")
        check(fa["cuda"].count(b">") > 0, f"mesh parity {name}: no contig")
        row["runs"][name] = dict(contigs=fa["cuda"].count(b">"),
                                 gpu_s=times["cuda"], cpu_s=times["cpu"],
                                 launches=launches)
    for name in ("bloom_np4",):
        want = "walk_sharded"
        check(row["runs"][name]["launches"].get(want, 0) > 0,
              f"mesh parity {name}: {want} was not launched")
    if torch.cuda.device_count() >= 2:
        row["mesh_kind"] += "; distinct cards"
        two = [torch.device("cuda", 0), torch.device("cuda", 1)] * 2
        for name, engine, np_, nh, k in MESH_PARITY_CONFIGS:
            if np_ * nh != 4:
                continue
            params = _mesh_params("mp", paths, os.path.join(
                tmp, f"mesh_parity_{name}_cards"), "cuda", engine, np_, nh,
                k, MESH_PARITY_BLOOM_BYTES, MESH_PARITY_BATCH)
            pe.stage_unitigs_1(params, devices=two)
            with open(params.path("1.fa"), "rb") as f:
                cards = f.read()
            with open(os.path.join(tmp, f"mesh_parity_{name}_cpu",
                                   "mp-1.fa"), "rb") as f:
                check(cards == f.read(), f"mesh parity {name}: distinct "
                                         "cards and CPU differ")
            row["runs"][name]["distinct_cards"] = True
    return row


def _fasta_records(path: str) -> list:
    """(sequence, coverage) of each record of a stage-1 FASTA."""
    from abyss_tpu_torch.io import fastx
    return [(r.seq, int(r.comment.split()[1])) for r in
            fastx.read_fastx(path)]


class MeshCapture(Patches):
    """During a sharded exact run: its table and the routing buckets
    that overflowed (each a retry with a larger capacity, counted per
    shard)."""

    def __init__(self):
        self.tables: list = []
        self.overflows: list = []
        super().__init__()

    def __enter__(self):
        from abyss_tpu_torch.parallel import sharded_table as tst
        assemble, bucketize = tst.assemble_sharded, tst._bucketize

        def assemble_sharded(*a, **kw):
            out = assemble(*a, **kw)
            self.tables.append(out[1])
            return out

        def recording_bucketize(*a, **kw):
            out = bucketize(*a, **kw)
            self.overflows.append(out[1])
            return out

        self.patch(tst, "assemble_sharded", assemble_sharded)
        self.patch(tst, "_bucketize", recording_bucketize)
        return self


def phase_mesh_exact(tmp: str, paths, genome: str) -> dict:
    """pe's stage 1 with engine=exact and np = 4 on a mesh of four copies
    of the card (the sharded table, every phase on the mesh) with pe's
    stage-1 arguments (k = 31, kc 2, e/E/c from the coverage model, tips
    of k, bubbles of 2k + 1 k-mers) on the 4.6 Mbp reads, launch counts
    set to 0 just before and read just after: its contigs, with their
    coverage, must be the exact_pe phase's ex-1.fa as a set; each
    shard's real rows fewer than the table's; phase spans, overflow
    retries, peak memory."""
    import torch
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.parallel import sharded_table as tst
    from abyss_tpu_torch.pipeline import pe
    from abyss_tpu_torch.utils import trace
    params = _mesh_params("mx", paths, os.path.join(tmp, "mesh_exact"),
                          "cuda", "exact", MESH_EXACT_NP)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with MeshCapture() as cap, trace.recording() as records:
            pe.stage_unitigs_1(params,
                               devices=_mesh_devices() * MESH_EXACT_NP)
    finally:
        launches = dict(kernels.launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(cap.tables) == 1, "mesh_exact: pe did not run the sharded "
                                "engine once")
    t = cap.tables[0]
    rows = [int((keys != tst.SENTINEL).sum()) for keys in t.keys]
    alive = [int(a.sum()) for a in t.alive]
    overflow = sum(1 for o in cap.overflows if int(o) > 0)
    got = _fasta_records(params.path("1.fa"))
    want = _fasta_records(os.path.join(tmp, "exact_pe", "ex-1.fa"))
    with open(params.path("1.fa")) as f:
        stats = _contig_stats(f.read(), genome, "mesh_exact", params.k)
    row = dict(phase="mesh_exact", mesh=f"{MESH_EXACT_NP} x cuda:0",
               k=params.k, wall_s=wall,
               phase_s={n: s for n, s in trace.span_seconds(records).items()
                        if n.startswith("mesh.")},
               shard_rows=rows, shard_size=t.shard_size,
               table_rows=sum(rows), alive_rows=alive,
               bucketizations=len(cap.overflows), overflow_retries=overflow,
               same_contigs_as_exact_pe=sorted(got) == sorted(want),
               exact_pe_contigs=len(want), **stats,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=launches)
    emit(row)
    check(row["same_contigs_as_exact_pe"], "mesh_exact: contigs differ "
                                           "from exact_pe's ex-1.fa")
    check(all(r < sum(rows) for r in rows),
          "mesh_exact: a shard holds the whole table")
    return row


def phase_mesh_bloom(tmp: str, paths, genome: str) -> tuple:
    """pe's bloom stage 1 with B = 1 GiB (2^30 counters,
    MESH_BLOOM_BYTES) on the 4.6 Mbp reads at np = 2 (a 2 x 1 mesh of
    copies of the card, the filter replicated, pass 2 through
    walk_bloom) and np = 4 (2 x 2, the filter sharded, pass 2 through
    walk_sharded), launch counts set to 0 just
    before and read just after each: the two runs split the data alike,
    so the sharded counters, concatenated, must equal the replicated
    ones, and the FASTA files hold the same sequences (byte equality
    reported); both held to the main phase's contig gates.  Returns the
    row, the np = 4 run's recorded walk and look-ahead launches and one
    of its load-step scatter-max calls."""
    import torch
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.parallel import distributed as tdist
    from abyss_tpu_torch.pipeline import pe
    row = dict(phase="mesh_bloom", runs={})
    filters, fastas = {}, {}
    rec = WalkCalls(limit=MESH_REPLAY)
    capture: dict = {}
    scatter = tdist.scatter_max_u8

    def recording(counters, idx, val):
        n = capture.setdefault("calls", 0)
        if n == MESH_LOAD_CAPTURE:
            capture.update(before=counters.clone(), idx=idx.clone(),
                           val=val.clone())
        out = scatter(counters, idx, val)
        if n == MESH_LOAD_CAPTURE:
            capture["after"] = counters.clone()
        capture["calls"] = n + 1
        return out

    for np_ in (2, 4):
        params = _mesh_params(f"mb{np_}", paths, os.path.join(
            tmp, f"mesh_bloom_{np_}"), "cuda", "bloom", np_,
            bloom_bytes=MESH_BLOOM_BYTES)
        patches = Patches()
        build = pe.bloom_mesh_filter
        built: dict = {}

        def capture_filter(p, devices):
            t0 = time.perf_counter()
            filt, prm = build(p, devices)
            torch.cuda.synchronize()
            built.update(filter=filt, pass1_s=time.perf_counter() - t0)
            return filt, prm

        patches.patch(pe, "bloom_mesh_filter", capture_filter)
        if np_ == 4:
            patches.patch(tdist, "scatter_max_u8", recording)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            if np_ == 4:
                with rec:
                    pe.stage_unitigs_1(params, devices=_mesh_devices() * np_)
            else:
                pe.stage_unitigs_1(params, devices=_mesh_devices() * np_)
        finally:
            launches = dict(kernels.launches)
            patches.restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(params.path("1.fa")) as f:
            fastas[np_] = f.read()
        stats = _contig_stats(fastas[np_], genome, f"mesh_bloom np={np_}",
                              params.k)
        filt = filters[np_] = built["filter"]
        sharded = isinstance(filt, tdist.ShardedCountingFilter)
        check(sharded == (np_ == 4), f"mesh_bloom np={np_}: the filter is "
                                     f"{type(filt).__name__}")
        variant = "_sharded" if sharded else "_bloom"
        for name in ("nthash", "scatter_max", "walk" + variant,
                     "branch" + variant):
            check(launches[name] > 0, f"mesh_bloom np={np_}: kernel {name} "
                                      "was not launched")
        run = dict(mesh=f"{np_ // 2 if np_ >= 4 else np_} data x "
                        f"{2 if np_ >= 4 else 1} shard of cuda:0",
                   wall_s=wall, pass1_s=built["pass1_s"],
                   pass2_s=wall - built["pass1_s"],
                   counters=filt.size, **stats,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   launches=launches)
        row["runs"][f"np{np_}"] = run
        _check_contigs(dict(run, phase=f"mesh_bloom np={np_}"))
    flat = torch.cat(filters[4].shards)
    row["sharded_counters_equal"] = bool(torch.equal(
        flat, filters[2].counters[:filters[2].size]))
    seqs = {n: sorted(l for l in fa.splitlines() if not l.startswith(">"))
            for n, fa in fastas.items()}
    row["same_sequences"] = seqs[2] == seqs[4]
    row["fasta_byte_equal"] = fastas[2] == fastas[4]
    emit(row)
    check(row["sharded_counters_equal"], "mesh_bloom: the sharded counters "
                                         "differ from the replicated ones")
    check(row["same_sequences"], "mesh_bloom: np=2 and np=4 assemble "
                                 "different sequences")
    check("after" in capture, f"mesh_bloom: fewer than "
                              f"{MESH_LOAD_CAPTURE + 1} load-step scatters")
    return row, rec, capture, filters[2]


def sharded_vs_bloom(rec: WalkCalls, cbf, walk: dict, branch: dict) -> None:
    """The replayed walk_sharded and branch_sharded launches timed again
    through walk_bloom and branch_bloom on the replicated filter of the
    same counters (mesh_bloom checks they are equal): the cost of
    reading the counters through their shards, on the same inputs.
    Adds `bloom_ms` (the mean over the launches) to each row."""
    import torch
    from abyss_tpu_torch.ops import kernels
    walks = []
    for _, st0, k, steps in rec.walks:
        work = st0._replace(**{n: getattr(st0, n).clone()
                               for n in WALK_FIELDS})

        def reset(work=work, st0=st0):
            for n in WALK_FIELDS:
                getattr(work, n).copy_(getattr(st0, n))

        walks.append(median_ms(lambda work=work, k=k, steps=steps:
                               kernels.walk(cbf, work.buf, work.length,
                                            work.f, work.r, work.status,
                                            work.seed_canon, work.has_prev,
                                            k, steps), 5, flush=reset))
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=cbf.device)
    branches = [median_ms(lambda a=a: kernels.branch(cbf, *a[1:]), 5,
                          flush=lambda: flush_buf.fill_(1))
                for a in rec.branches]
    walk["bloom_ms"] = sum(walks) / len(walks)
    branch["bloom_ms"] = sum(branches) / len(branches)


# the phases `python3 chip_smoke.py NAME ...` runs alone, each with the
# phases it needs run first ("main" includes the ntHash shape timings;
# "walk" the walk and look-ahead rows of the main path; "bloom" the
# scatter-max replay, the bloom walk rows and the bloom tool;
# "konnector_cascade" the replay of its walks)
PHASES = {"kernel": (), "parity": (), "main": ("kernel",),
          "walk": ("main",), "bloom": ("main",), "pe_parity": ("parity",),
          "pe": (), "exact_parity": ("parity",), "exact_pe": (), "wide": (),
          "paired": (), "konnector": (), "konnector_cascade": (),
          "sealer": ("pe",), "paired_parity": ("pe_parity",),
          "tools_parity": ("parity",), "tools": (),
          "mesh_parity": ("parity",), "mesh_exact": ("exact_pe",),
          "mesh_bloom": ()}
# the phases that read the 4.6 Mbp fixture (make_fixture)
FIXTURE_PHASES = {"main", "bloom", "pe", "exact_pe", "wide", "paired",
                  "konnector", "konnector_cascade", "sealer", "tools",
                  "mesh_exact", "mesh_bloom"}


def phases_to_run(names) -> list:
    """The named phases and, before them, those they need, in the order
    of a whole run; all of them when none is named."""
    want = set()

    def add(name):
        if name not in want:
            want.add(name)
            for pre in PHASES[name]:
                add(pre)

    for name in names or PHASES:
        add(name)
    return [name for name in PHASES if name in want]


def main(argv=None) -> int:
    names = sys.argv[1:] if argv is None else list(argv)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        log(f"unknown phases {unknown}: name some of {' '.join(PHASES)}, "
            f"or none for the whole run")
        return 2
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
    run = set(phases_to_run(names))

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_", dir=REPO)
    try:
        emit(phase_header())
        emit(phase_build())
        if "kernel" in run:
            row, kern = phase_kernel()
            emit(row)
        if "parity" in run:
            emit(phase_parity(tmp))
        if run & FIXTURE_PHASES:
            fx = make_fixture(tmp)
            genome, paths = fx["genome"], fx["paths"]
        if "main" in run:
            main_row, (wf, _, params), launched = phase_main(fx)
            row, nthash_shapes, nthash_gap = phase_nthash_shapes(launched,
                                                                 kern)
            emit(row)
            launched = None
        if "walk" in run:
            walk, walked = phase_walk(wf, paths, params)
            emit(walk)
            branch = phase_branch(*walked)
            emit(branch)
        wf = walked = None
        torch.cuda.empty_cache()
        if "bloom" in run:
            bloom_row, cbf, bparams, capture = phase_bloom(paths, genome,
                                                           main_row)
            scatter = phase_scatter(capture)
            emit(scatter)
            capture = None
            walk_bloom, walked = phase_walk(cbf, paths, bparams)
            emit(walk_bloom)
            branch_bloom = phase_branch(*walked)
            emit(branch_bloom)
            walked = None
            emit(phase_bloom_tool(tmp, paths, cbf))
            cbf = None
            torch.cuda.empty_cache()
        if "pe_parity" in run:
            emit(phase_pe_parity(tmp))
        if "pe" in run:
            pe_row, pe_recorded = phase_pe(tmp, paths, genome)
            pe_shapes = phase_shapes(pe_recorded, "nthash_pe_shapes")
            emit(pe_shapes)
            pe_recorded = None
        if "exact_parity" in run:
            emit(phase_exact_parity(tmp))
        if "exact_pe" in run:
            exact_row = phase_exact_pe(tmp, paths, genome)
        if "wide" in run:
            wide_row, wide_recorded = phase_wide(tmp, paths, genome)
            wide_shapes = phase_wide_shapes(wide_recorded)
            emit(wide_shapes)
            wide_recorded = None
        if "paired" in run:
            paired_row, paired_recorded = phase_paired(tmp, paths, genome)
            paired_shapes = phase_shapes(paired_recorded,
                                         "nthash_paired_shapes")
            emit(paired_shapes)
            paired_recorded = None
            torch.cuda.empty_cache()
        if run & {"konnector", "sealer"}:
            gidx = GenomeIndex(genome)
        if "konnector" in run:
            konn_row, konn_recorded = phase_konnector(tmp, genome, gidx)
            konn_shapes = phase_shapes(konn_recorded,
                                       "nthash_konnector_shapes")
            emit(konn_shapes)
            konn_recorded = None
        if "konnector_cascade" in run:
            casc_row, casc_calls = phase_konnector_cascade(tmp, genome)
            walk_cascade, branch_cascade = phase_replay_walks(
                casc_calls, casc_row["launches"])
            emit(walk_cascade)
            emit(branch_cascade)
            casc_calls = None
            torch.cuda.empty_cache()
        if "sealer" in run:
            phase_sealer(tmp, paths, gidx)
        if "paired_parity" in run:
            emit(phase_paired_parity(tmp))
        if "tools_parity" in run:
            emit(phase_tools_parity(tmp))
        if "tools" in run:
            tools_row, plc_replay = phase_tools(tmp, paths, genome)
            emit(plc_replay)
            torch.cuda.empty_cache()
        if "mesh_parity" in run:
            emit(phase_mesh_parity(tmp))
        if "mesh_exact" in run:
            mesh_exact = phase_mesh_exact(tmp, paths, genome)
            torch.cuda.empty_cache()
        if "mesh_bloom" in run:
            mesh_row, mesh_calls, load_capture, mesh_cbf = phase_mesh_bloom(
                tmp, paths, genome)
            walk_sharded, branch_sharded = phase_replay_walks(
                mesh_calls, mesh_row["runs"]["np4"]["launches"], "_sharded")
            sharded_vs_bloom(mesh_calls, mesh_cbf, walk_sharded,
                             branch_sharded)
            emit(walk_sharded)
            emit(branch_sharded)
            load_scatter = scatter_replay(load_capture)
            emit(dict(phase="kernel", kernel="scatter_max_mesh_load",
                      **load_scatter, call=MESH_LOAD_CAPTURE))
            mesh_calls = load_capture = mesh_cbf = None
            torch.cuda.empty_cache()
    except SmokeError as e:
        log(f"FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if run != set(PHASES):
        emit({"phase": "total", "wall_s": time.perf_counter() - START})
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    # launches: each kernel's count on the path that runs it (main for the
    # sorted filter's kernels, bloom for the counting filter's, the
    # konnector cascade run for the cascading filter's).  No single
    # PyTorch call computes ntHash, the walks or the look-aheads
    # (library_ms null); walk and branch replace jnp loops of
    # abyss_tpu/dbg/extend.py, not Pallas kernels
    fast_extend = "abyss_tpu/dbg/extend.py:164"
    branch_depths = "abyss_tpu/dbg/extend.py:243"
    walk_cu = "abyss_tpu_torch/csrc/walk.cu"
    # ntHash also lists its flush timing (its earlier `ms`), its times at
    # three shapes (phase_nthash_shapes) and launches x (ms - bound_ms)
    # over every shape of the main run
    kern.update(shapes=nthash_shapes, gap_ms_main_run=nthash_gap,
                gap_ms_pe_run=pe_shapes["gap_ms"],
                gap_ms_wide_run=wide_shapes["gap_ms"],
                gap_ms_paired_run=paired_shapes["gap_ms"],
                launches_exact_pe=exact_row["launches"]["nthash"],
                launches_wide=wide_row["launches"]["nthash"],
                launches_paired=paired_row["launches"]["nthash"],
                launches_konnector=konn_row["launches"]["nthash"])
    scatter.update(launches_konnector=casc_row["launches"]["scatter_max"])
    # both kernels on the mesh bloom path (np = 4: the load step's ntHash
    # and scatter-max once per shard and batch); the scatter-max also at
    # the load step's shape (one call replayed)
    mesh_launches = mesh_row["runs"]["np4"]["launches"]
    kern.update(launches_mesh_bloom=mesh_launches["nthash"],
                launches_mesh_exact=mesh_exact["launches"]["nthash"])
    scatter.update(launches_mesh_bloom=mesh_launches["scatter_max"],
                   mesh_load={n: load_scatter[n] for n in (
                       "counters", "updates", "max_abs_err", "ms",
                       "plain_ms", "library_ms", "bytes", "bound_ms",
                       "bound_by")})
    # both kernels on the logcounter path; the scatter-max also at its PLC
    # shape (one logcounter batch replayed)
    logcounter_launches = tools_row["logcounter"]["launches"]
    kern.update(launches_logcounter=logcounter_launches["nthash"])
    scatter.update(launches_logcounter=logcounter_launches["scatter_max"],
                   plc={n: plc_replay[n] for n in (
                       "updates", "max_abs_err", "ms", "plain_ms",
                       "library_ms", "bytes", "bound_ms", "bound_by")})
    emit({"kernels": [dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=path["launches"][name],
        max_abs_err=rec["max_abs_err"], ms=rec["ms"],
        plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], library_ms=rec.get("library_ms"),
        **{n: rec[n] for n in ("flush_ms", "shapes", "gap_ms_main_run",
                               "gap_ms_pe_run", "gap_ms_wide_run",
                               "gap_ms_paired_run", "launches_exact_pe",
                               "launches_wide", "launches_paired",
                               "launches_konnector", "launches_logcounter",
                               "launches_mesh_bloom", "launches_mesh_exact",
                               "plc", "mesh_load", "path_launches",
                               "bloom_ms")
           if n in rec},
        **({"launches_pe": pe_row["launches"][name]}
           if name in ("nthash", "walk", "branch") else {}))
        for name, source, replaces, path, rec in (
            ("nthash", "abyss_tpu_torch/csrc/nthash.cu",
             "abyss_tpu/ops/pallas_kernels.py:192", main_row, kern),
            ("walk", walk_cu, fast_extend, main_row, walk),
            ("branch", walk_cu, branch_depths, main_row, branch),
            ("scatter_max", "abyss_tpu_torch/csrc/scatter_max.cu",
             "abyss_tpu/ops/pallas_scatter.py:187", bloom_row, scatter),
            ("walk_bloom", walk_cu, fast_extend, bloom_row, walk_bloom),
            ("branch_bloom", walk_cu, branch_depths, bloom_row,
             branch_bloom),
            ("walk_cascade", walk_cu, fast_extend, casc_row, walk_cascade),
            ("branch_cascade", walk_cu, branch_depths, casc_row,
             branch_cascade),
            ("walk_sharded", walk_cu, fast_extend, mesh_row["runs"]["np4"],
             walk_sharded),
            ("branch_sharded", walk_cu, branch_depths,
             mesh_row["runs"]["np4"], branch_sharded))]})
    emit({"phase": "total", "wall_s": time.perf_counter() - START})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
