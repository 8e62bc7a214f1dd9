"""CLI entry points of the port (mirrors abyss_tpu/cli/tools.py).

Ported so far: abyss-bloom-dbg and ABYSS (the exact hash-DBG
assembler, `assemble`); abyss-bloom is cli/bloom_tool.py.
"""

from __future__ import annotations

import argparse
import sys


def bloom_dbg_main(argv=None):
    """abyss-bloom-dbg equivalent (BloomDBG/bloom-dbg.cc), on the GPU by
    default (--device cuda|cpu)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch bloom-dbg")
    ap.add_argument("reads", nargs="+", help="FASTA/FASTQ input files")
    ap.add_argument("-k", "--kmer", type=int, required=True)
    ap.add_argument("-b", "--bloom-size", default="64M",
                    help="total Bloom memory budget (e.g. 500M, 2G)")
    ap.add_argument("--kc", type=int, default=2,
                    help="k-mer coverage threshold [2]")
    ap.add_argument("-H", "--num-hashes", type=int, default=4)
    ap.add_argument("-t", "--trim-length", type=int, default=None)
    ap.add_argument("-q", "--trim-quality", type=int, default=0)
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("-T", "--read-log", default=None,
                    help="per-read outcome trace TSV (-T/--read-log)")
    ap.add_argument("--db", default=None, help="SQLite telemetry file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    ap.add_argument("-v", "--verbose", action="count", default=0)
    args = ap.parse_args(argv)

    from ..utils.db import open_db
    from ..dbg import bloom_dbg
    from ..dbg.params import AssemblyParams
    params = AssemblyParams(
        k=args.kmer, num_hashes=args.num_hashes, min_cov=args.kc,
        trim=args.trim_length, bloom_bytes=parse_size(args.bloom_size),
        q=args.trim_quality, verbose=args.verbose,
        read_log=args.read_log)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        counters = bloom_dbg.assemble(args.reads, params, out=out,
                                      device=args.device)
    finally:
        if out is not sys.stdout:
            out.close()
    with open_db(args.db, "bloom-dbg", argv) as db:
        for key, val in bloom_dbg.dataclasses_dict(counters).items():
            db.add(key, val)


def assemble_main(argv=None):
    """ABYSS (exact hash-DBG) equivalent (ABYSS/abyss.cc), on the GPU by
    default (--device cuda|cpu)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch assemble")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-k", "--kmer", required=True,
                    help="k-mer size, or a sweep kmin-kmax[:step] "
                         "(ABYSS/abyss.cc:166-194 multi-k mode)")
    ap.add_argument("--kc", type=int, default=2)
    ap.add_argument("-e", "--erode", type=int, default=2)
    ap.add_argument("-t", "--trim-length", type=int, default=None)
    ap.add_argument("-c", "--coverage", action="store_true",
                    help="set kc from the coverage model "
                         "(CoverageAlgorithm fixpoint)")
    ap.add_argument("--mean-coverage", type=float, default=None,
                    help="remove contigs with mean k-mer coverage below "
                         "this (the reference's c parameter)")
    ap.add_argument("-b", "--bubble-len", type=int, default=None,
                    help="maximum bubble branch length in k-mers [3k]")
    ap.add_argument("--bubbles", default=None,
                    help="write popped bubble branches here (FASTA)")
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("--coverage-hist", default=None)
    ap.add_argument("--snapshot", default=None,
                    help="write a binary .kmer DBG snapshot here "
                         "(Assembly/DBG.h:354-401 store/load)")
    ap.add_argument("--db", default=None, help="SQLite telemetry file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)

    import numpy as np
    from .. import resolve_device
    from ..dbg import hash_dbg
    from ..io import read_batches as io_read_batches
    from ..utils.db import open_db
    resolve_device(args.device)
    bubbles: list = []
    kw = dict(kc=args.kc, erode_cov=args.erode, tip_len=args.trim_length,
              auto_coverage=args.coverage, min_mean_cov=args.mean_coverage,
              bubble_len=args.bubble_len)
    if len(args.reads) == 1 and args.reads[0].endswith(
            (".kmer", ".kmer.npz")):
        # resume from a snapshot instead of re-counting reads
        table = hash_dbg.load_snapshot(args.reads[0], device=args.device)
        contigs = hash_dbg.assemble_table(table, bubbles_out=bubbles, **kw)
    elif "-" in str(args.kmer):
        # multi-k sweep: k=kmin-kmax[:step]; each round's contigs feed
        # the next k as extra input (ABYSS/abyss.cc:166-194)
        rng_part, _, step_part = str(args.kmer).partition(":")
        kmin, _, kmax = rng_part.partition("-")
        step = int(step_part) if step_part else 1
        ks = list(range(int(kmin), int(kmax) + 1, step))

        for flag, val in (("--snapshot", args.snapshot),
                          ("--coverage-hist", args.coverage_hist),
                          ("--bubbles", args.bubbles)):
            if val:
                print(f"warning: {flag} is ignored in a multi-k sweep "
                      "(per-k artifacts are not defined for k ranges)",
                      file=sys.stderr)

        def batches_fn():
            return (b.codes[:b.num_reads] for b in
                    io_read_batches(args.reads, 4096, 512))
        contigs = hash_dbg.multi_k_sweep(batches_fn, ks, device=args.device,
                                         **kw)
        table = None
    else:
        batches = [b.codes[:b.num_reads] for b in
                   io_read_batches(args.reads, 4096, 512)]
        contigs, table = hash_dbg.assemble_reads(
            batches, int(args.kmer), bubbles_out=bubbles,
            device=args.device, **kw)
    if args.snapshot and table is not None:
        hash_dbg.save_snapshot(table, args.snapshot)
    if args.bubbles:
        with open(args.bubbles, "w") as f:
            for i, s in enumerate(bubbles):
                f.write(f">bubble{i} {len(s)}\n{s}\n")
    if args.coverage_hist and table is not None:
        with open(args.coverage_hist, "w") as f:
            f.write(hash_dbg.coverage_histogram(table).to_text())
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        for i, (seq, cov) in enumerate(contigs):
            out.write(f">{i} {len(seq)} {cov}\n{seq}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    # SNR report (ABYSS/abyss.cc:128-132): assembled vs removed k-mers
    n_total = int(getattr(table, "n", 0))
    n_assembled = int(np.asarray(table.alive).sum()) if n_total else 0
    n_removed = n_total - n_assembled
    if n_removed > 0 and n_assembled > 0:
        snr = 10 * np.log10(n_assembled / n_removed)
        print(f"Removed {n_removed} k-mer.\n"
              f"The signal-to-noise ratio (SNR) is {snr:.6g} dB.",
              file=sys.stderr)
    with open_db(args.db, "assemble", argv) as db:
        db.add("contigs", len(contigs))
        db.add("kmers", n_total)
        db.add("kmers_assembled", n_assembled)


def parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    if s and s[-1] in "KMGT":
        mult = 1 << (10 * ("KMGT".index(s[-1]) + 1))
        s = s[:-1]
    return int(float(s) * mult)
