"""abyss-fac equivalent: contiguity statistics of FASTA files
(reference: DataLayer/fac.cc)."""

from __future__ import annotations

import argparse
import sys

from ..core.histogram import contiguity_stats, format_stats_table
from ..io import fastx


def fac(paths, min_length: int = 500, genome_size: int = 0,
        count_ambig: bool = False):
    rows = []
    for path in paths:
        lengths = []
        for rec in fastx.read_fastx(path):
            s = rec.seq
            n = len(s) if count_ambig else \
                sum(1 for c in s if c in "ACGTacgt")
            lengths.append(n)
        rows.append(contiguity_stats(lengths, min_length, genome_size, path))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="abyss-tpu-fac",
        description="Calculate assembly contiguity statistics")
    ap.add_argument("files", nargs="+")
    ap.add_argument("-s", "--min-length", type=int, default=500,
                    help="ignore sequences shorter than N [500]")
    ap.add_argument("-G", "--genome-size", type=int, default=0,
                    help="expected genome size for NG50")
    ap.add_argument("--count-ambig", action="store_true",
                    help="count ambiguity codes in sequence length")
    args = ap.parse_args(argv)
    rows = fac(args.files, args.min_length, args.genome_size,
               args.count_ambig)
    sys.stdout.write(format_stats_table(rows))


if __name__ == "__main__":
    main()
