"""More CLI entry points of the port (mirrors abyss_tpu/cli/tools2.py).

Ported so far: abyss-paired-dbg (`paired-dbg`).
"""

from __future__ import annotations

import argparse
import sys


def paireddbg_main(argv=None):
    """abyss-paired-dbg: assemble with KmerPair vertices (PairedDBG/), on
    the GPU by default (--device cuda|cpu)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch paired-dbg")
    ap.add_argument("reads", nargs="+")
    # reference flag convention (bin/abyss-pe:556-564, abyss-paired-dbg):
    # -k is the SPAN of the k-mer pair, -K the SINGLE k-mer size
    ap.add_argument("-k", "--span", type=int, required=True,
                    help="k-mer pair span (reference -k)")
    ap.add_argument("-K", "--single", type=int, required=True,
                    help="single k-mer size (reference -K)")
    ap.add_argument("--kc", type=int, default=2)
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    if args.span < 2 * args.single:
        ap.error(f"k-mer pair span -k{args.span} must be >= twice the "
                 f"single k-mer size -K{args.single}")
    from .. import resolve_device
    from ..dbg import paired_dbg
    from ..io import read_batches
    resolve_device(args.device)
    batches = [b.codes[:b.num_reads]
               for b in read_batches(args.reads, 4096, 512)]
    contigs = paired_dbg.assemble_pairs(batches, args.single, args.span,
                                        kc=args.kc, device=args.device)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        for i, (seq, _) in enumerate(contigs):
            out.write(f">{i} {len(seq)}\n{seq}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0
