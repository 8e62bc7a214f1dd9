"""CLI entry points of the port (mirrors abyss_tpu/cli/tools.py).

Ported so far: abyss-bloom-dbg; abyss-bloom is cli/bloom_tool.py.
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


def parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    if s and s[-1] in "KMGT":
        mult = 1 << (10 * ("KMGT".index(s[-1]) + 1))
        s = s[:-1]
    return int(float(s) * mult)
