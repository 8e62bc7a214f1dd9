"""CLI entry points of the port (mirrors abyss_tpu/cli/tools.py).

Reference binaries covered here: abyss-bloom-dbg, ABYSS (the exact
hash-DBG assembler, `assemble`), AdjList, abyss-tofastq, abyss-todot,
abyss-gc, konnector, abyss-sealer, abyss-db-txt and abyss-db-csv;
abyss-bloom is cli/bloom_tool.py, the other tools cli/tools2.py.
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


def adjlist_main(argv=None):
    """AdjList equivalent (AdjList/AdjList.cpp)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch adjlist")
    ap.add_argument("contigs")
    ap.add_argument("-k", "--kmer", type=int, required=True)
    ap.add_argument("-m", "--min-overlap", type=int, default=None,
                    help="also find overlaps down to this length "
                         "(< k-1; AdjList's suffix-array path)")
    ap.add_argument("--adj", action="store_true", help="output .adj format")
    ap.add_argument("--gfa2", action="store_true", help="output GFA2")
    args = ap.parse_args(argv)

    from ..graph import adjlist, graphio
    from ..io import fastx
    recs = list(fastx.read_fastx(args.contigs))
    contigs = [(r.id, r.seq) for r in recs]
    covs = []
    for r in recs:
        parts = r.comment.split()
        covs.append(int(parts[1]) if len(parts) > 1 and
                    parts[1].isdigit() else 0)
    g = adjlist.build_overlap_graph(contigs, args.kmer, covs,
                                    min_overlap=args.min_overlap)
    if args.adj:
        graphio.write_adj(g, sys.stdout)
    elif args.gfa2:
        graphio.write_gfa2(g, sys.stdout, k=args.kmer,
                           seqs=dict(contigs))
    else:
        graphio.write_dot(g, sys.stdout, k=args.kmer)


def tofastq_main(argv=None):
    """abyss-tofastq equivalent (DataLayer/abyss-tofastq.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch tofastq")
    ap.add_argument("files", nargs="*", default=["-"])
    ap.add_argument("--fasta", action="store_true",
                    help="convert to FASTA instead")
    args = ap.parse_args(argv)
    from ..io import fastx
    for path in args.files or ["-"]:
        for rec in fastx.read_fastx(path):
            if args.fasta:
                sys.stdout.write(f">{rec.id}\n{rec.seq}\n")
            else:
                q = rec.qual or ("I" * len(rec.seq))
                sys.stdout.write(f"@{rec.id}\n{rec.seq}\n+\n{q}\n")


def todot_main(argv=None):
    """abyss-todot equivalent (Graph/todot.cc): graph format conversion."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch todot")
    ap.add_argument("graphs", nargs="+")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("--adj", action="store_true")
    ap.add_argument("--gfa2", action="store_true")
    args = ap.parse_args(argv)
    from ..graph import graphio
    g = None
    k = args.kmer
    for path in args.graphs:
        g2, k2 = graphio.read_graph(path)
        k = k or k2
        if g is None:
            g = g2
        else:
            # merge: union of vertices/edges
            for cid in g2.contigs():
                name = g2.names[cid]
                if name not in g._index:
                    g.add_contig(name, g2.lengths[cid], g2.coverages[cid])
            for u in g2.vertices():
                for v, prop in g2.out_edges(u):
                    nu = graphio.parse_vertex_name(
                        g2.name(u), g._index)
                    nv = graphio.parse_vertex_name(
                        g2.name(v), g._index)
                    if not g.has_edge(nu, nv):
                        g.add_edge(nu, nv, prop)
    if args.adj:
        graphio.write_adj(g, sys.stdout)
    elif args.gfa2:
        graphio.write_gfa2(g, sys.stdout, k=k)
    else:
        graphio.write_dot(g, sys.stdout, k=k)


def gc_main(argv=None):
    """abyss-gc equivalent (Graph/gc.cc): vertex/edge counts."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch gc")
    ap.add_argument("graphs", nargs="+")
    args = ap.parse_args(argv)
    from ..graph import graphio
    for path in args.graphs:
        g, _ = graphio.read_graph(path)
        v = sum(1 for _ in g.vertices())
        e = g.num_edges()
        sys.stdout.write(f"{path}: V={v} E={e}\n")


def konnector_main(argv=None):
    """konnector equivalent (Konnector/konnector.cc): merge read pairs
    through the DBG into pseudo-long reads with the bidirectional engine
    (gap/konnector.connect_pairs_full), the reference's option surface
    and per-outcome stats block; on the GPU by default (--device
    cuda|cpu)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch konnector")
    ap.add_argument("reads1")
    ap.add_argument("reads2")
    ap.add_argument("-k", "--kmer", type=int, required=True)
    ap.add_argument("-b", "--bloom-size", default="64M")
    ap.add_argument("-f", "--min-frag", type=int, default=0)
    ap.add_argument("-F", "--max-frag", type=int, default=1000)
    ap.add_argument("-P", "--max-paths", type=int, default=2)
    ap.add_argument("-B", "--max-branches", type=int, default=0,
                    help="frontier cap; 0 = nolimit (deprecated)")
    ap.add_argument("-C", "--max-cost", type=int, default=25000)
    ap.add_argument("-M", "--max-mismatches", type=int, default=2)
    ap.add_argument("-m", "--read-mismatches", type=int, default=0,
                    help="max read/path mismatches; 0 = nolimit")
    ap.add_argument("-x", "--read-identity", type=float, default=0.0)
    ap.add_argument("-X", "--path-identity", type=float, default=0.0)
    ap.add_argument("--mask", action="store_true",
                    help="lowercase new/changed bases")
    ap.add_argument("--preserve-reads", action="store_true")
    ap.add_argument("-D", "--dup-bloom-size", default="0",
                    help="dup-avoidance Bloom size (with --extend)")
    ap.add_argument("-q", "--trim-quality", type=int, default=0)
    ap.add_argument("-t", "--trace-file", default=None)
    ap.add_argument("--extend", action="store_true",
                    help="extend connected reads outward through the DBG")
    ap.add_argument("--cascade", type=int, default=0, metavar="L",
                    help="use an L-level cascading Bloom filter for "
                         "solidity (the reference konnector's "
                         "CascadingBloomFilter, Konnector/konnector.cc; "
                         "solid = seen >= L times)")
    ap.add_argument("-o", "--output-prefix", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)

    import os

    import torch

    from .. import resolve_device
    from ..dbg import bloom_dbg
    from ..dbg.params import AssemblyParams
    from ..gap import konnector
    from ..io import fastx
    from ..io import read_batches as io_read_batches
    params = AssemblyParams(k=args.kmer,
                            bloom_bytes=parse_size(args.bloom_size),
                            min_cov=1)
    dev = resolve_device(args.device)
    if args.cascade >= 2:
        # solid = seen >= L times.  The reference implements this with
        # an L-level CascadingBloomFilter (Konnector/konnector.cc); the
        # default here is the exact sorted counter at threshold L
        # (the cascade's decisions minus its false positives, and it
        # feeds the device BFS of gap/konnector_dev; the cascade takes
        # the host engine).  ABYSS_TPU_KONN_FILTER=cascade restores the
        # Bloom cascade.
        from ..ops import nthash
        if os.environ.get("ABYSS_TPU_KONN_FILTER") == "cascade":
            from ..ops.bloom import CascadingBloomFilter
            size = 1 << (max(parse_size(args.bloom_size) // args.cascade,
                             2).bit_length() - 1)
            cbf = CascadingBloomFilter.create(size, args.kmer,
                                              depth=args.cascade, device=dev)
            for batch in io_read_batches([args.reads1, args.reads2],
                                         4096, 512):
                _, _, canon, valid = nthash.kmer_hashes(
                    torch.from_numpy(batch.codes).to(dev), args.kmer)
                cbf = cbf.insert(canon, valid)
        else:
            from ..ops.sorted_filter import SortedKmerCounter
            ctr = SortedKmerCounter(args.kmer, threshold=args.cascade)
            for batch in io_read_batches([args.reads1, args.reads2],
                                         4096, 512):
                _, _, canon, valid = nthash.kmer_hashes(
                    torch.from_numpy(batch.codes).to(dev), args.kmer)
                ctr.add(canon, valid)
            cbf = ctr.finalize(dev)
    else:
        cbf = bloom_dbg.load_filter(
            io_read_batches([args.reads1, args.reads2], 4096, 512), params,
            device=dev)
    r1 = list(fastx.read_fastx(args.reads1))
    r2 = list(fastx.read_fastx(args.reads2))
    if args.trim_quality > 0:
        for rec in list(r1) + list(r2):
            if rec.qual:
                s, q = fastx.trim_quality(rec.seq, rec.qual,
                                          args.trim_quality)
                rec.seq, rec.qual = s, q
    pairs = [(a.seq, b.seq) for a, b in zip(r1, r2)]
    NL = konnector.NO_LIMIT
    kp = konnector.ConnectPairsParams(
        max_paths=args.max_paths, min_frag=args.min_frag,
        max_frag=args.max_frag,
        max_branches=args.max_branches or NL,
        max_cost=args.max_cost,
        max_path_mismatches=args.max_mismatches,
        min_path_identity=args.path_identity,
        max_read_mismatches=args.read_mismatches or NL,
        min_read_identity=args.read_identity,
        mask=args.mask, preserve_reads=args.preserve_reads)
    stats = konnector.ConnectStats()
    results = konnector.connect_pairs_full(cbf, pairs, args.kmer, kp,
                                           stats=stats)
    if args.trace_file:
        # per-pair search stats (ConnectPairsResult::printHeaders)
        with open(args.trace_file, "w") as tf:
            tf.write("k\tread_id\tsearch_result\tnum_paths\t"
                     "start_kmer_pos\tend_kmer_pos\n")
            for a, res in zip(r1, results):
                label = {"NO_KMER": "NO_PATH",
                         "MISMATCH": "FOUND_PATH",
                         "READ_MISMATCH": "FOUND_PATH"}.get(
                             res.reason, res.reason)
                prefix = a.id.rsplit("/", 1)[0]
                tf.write(f"{args.kmer}\t{prefix}\t{label}\t"
                         f"{res.num_paths}\t{res.start_pos}\t"
                         f"{res.goal_pos}\n")
    merged_ok = [res.reason == "FOUND_PATH" for res in results]
    if args.extend:
        dup = None
        if parse_size(args.dup_bloom_size):
            dup = konnector.DupFilter(parse_size(args.dup_bloom_size) * 8,
                                      args.kmer, device=dev)
        merged_seqs = [res.seq if ok else None
                       for ok, res in zip(merged_ok, results)]
        extended = konnector.extend_outward(cbf, merged_seqs, args.kmer)
        for j, (res, seq) in enumerate(zip(results, extended)):
            if merged_ok[j]:
                if dup is not None and dup.redundant_or_add(cbf, seq):
                    merged_ok[j] = False   # assembled already; skip
                else:
                    res.seq = seq
    n_merged = 0
    with open(args.output_prefix + "_merged.fa", "w") as fm, \
            open(args.output_prefix + "_reads_1.fq", "w") as f1, \
            open(args.output_prefix + "_reads_2.fq", "w") as f2:
        for a, b, res, ok in zip(r1, r2, results, merged_ok):
            if ok:
                fm.write(f">{a.id.rsplit('/', 1)[0]}\n{res.seq}\n")
                n_merged += 1
            else:
                q1 = a.qual or "I" * len(a.seq)
                q2 = b.qual or "I" * len(b.seq)
                f1.write(f"@{a.id}\n{a.seq}\n+\n{q1}\n")
                f2.write(f"@{b.id}\n{b.seq}\n+\n{q2}\n")
    print(stats.summary(), file=sys.stderr)


def sealer_main(argv=None):
    """abyss-sealer equivalent (Sealer/sealer.cc), on the GPU by default
    (--device cuda|cpu)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch sealer")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-S", "--input-scaffold", required=True)
    ap.add_argument("-k", "--kmer", type=int, action="append",
                    required=True, help="k value(s), may repeat")
    ap.add_argument("-b", "--bloom-size", default="64M")
    ap.add_argument("-F", "--flank", type=int, default=100)
    ap.add_argument("-G", "--max-gap", type=int, default=800)
    ap.add_argument("-o", "--output-prefix", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..gap import sealer
    from ..io import fastx
    scaffolds = [(r.id, r.seq)
                 for r in fastx.read_fastx(args.input_scaffold)]
    sealed, stats = sealer.seal(
        scaffolds, args.reads, ks=args.kmer,
        bloom_bytes=parse_size(args.bloom_size), flank=args.flank,
        max_gap=args.max_gap, device=resolve_device(args.device))
    fastx.write_fasta(args.output_prefix + "_scaffold.fa", sealed)
    print(f"closed {stats.closed} of {stats.gaps} gaps", file=sys.stderr)


def db_txt_main(argv=None):
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch db-txt")
    ap.add_argument("db")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    from ..utils import db as dbmod
    sys.stdout.write(dbmod.export_csv(args.db) if args.csv
                     else dbmod.export_text(args.db))


def db_csv_main(argv=None):
    """abyss-db-csv equivalent (DataBase/db-csv.cc)."""
    return db_txt_main((argv or []) + ["--csv"])


def parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    if s and s[-1] in "KMGT":
        mult = 1 << (10 * ("KMGT".index(s[-1]) + 1))
        s = s[:-1]
    return int(float(s) * mult)
