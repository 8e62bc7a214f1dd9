"""External-aligner wrappers with native fallback.

The reference ships shell wrappers (bin/abyss-bwa, abyss-bwamem,
abyss-bowtie2, abyss-kaligner, abyss-dida ...) that all conform to one
contract: index the target, stream reads, emit SAM on stdout
(bin/abyss-pe:276-302 picks one via `aligner=`).  Here the same
contract is met by shelling out when the external binary exists and
falling back to the built-in k-mer seed mapper otherwise, so the
pipeline runs with zero external dependencies but can use bwa/bowtie2
when available.

Port of abyss_tpu/align/wrappers.py: the same code, with the native
mapper's device passed in.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys


ALIGNERS = ("map", "bwa", "bwamem", "bwasw", "bowtie", "bowtie2",
            "kaligner", "dida")


def available(name: str) -> bool:
    binary = {"bwa": "bwa", "bwamem": "bwa", "bwasw": "bwa",
              "bowtie": "bowtie", "bowtie2": "bowtie2",
              "dida": "dida-wrapper"}.get(name)
    if name in ("map", "kaligner"):
        return True
    return binary is not None and shutil.which(binary) is not None


def _run(cmd, **kw):
    return subprocess.run(cmd, check=True, **kw)


def align_sam(name: str, target_fa: str, read_files, out,
              seed_len: int = 32, threads: int = 1,
              device="cuda") -> None:
    """Index target_fa (if needed), align read_files, write SAM to the
    `out` stream — the abyss-pe stage contract.  The native mapper runs
    on `device`."""
    if name in ("bwa", "bwasw") and available(name):
        if not os.path.exists(target_fa + ".bwt"):
            _run(["bwa", "index", target_fa], capture_output=True)
        algo = ["aln"] if name == "bwa" else ["bwasw"]
        for rf in read_files:
            p = subprocess.Popen(["bwa", "mem", "-t", str(threads),
                                  target_fa, rf], stdout=subprocess.PIPE,
                                 text=True)
            for line in p.stdout:
                out.write(line)
            p.wait()
        return
    if name == "bwamem" and available(name):
        if not os.path.exists(target_fa + ".bwt"):
            _run(["bwa", "index", target_fa], capture_output=True)
        for rf in read_files:
            p = subprocess.Popen(["bwa", "mem", "-t", str(threads),
                                  target_fa, rf], stdout=subprocess.PIPE,
                                 text=True)
            for line in p.stdout:
                out.write(line)
            p.wait()
        return
    if name == "bowtie2" and available(name):
        idx = target_fa + ".bt2idx"
        if not os.path.exists(idx + ".1.bt2"):
            _run(["bowtie2-build", target_fa, idx], capture_output=True)
        for rf in read_files:
            p = subprocess.Popen(
                ["bowtie2", "-x", idx, "-U", rf, "-p", str(threads)],
                stdout=subprocess.PIPE, text=True)
            for line in p.stdout:
                out.write(line)
            p.wait()
        return
    # native fallback (abyss-map / KAligner semantics)
    from .. import resolve_device
    from ..io import fastx, read_batches
    from . import sam
    from .mapper import KmerAligner
    resolve_device(device)
    contigs = [(r.id, r.seq) for r in fastx.read_fastx(target_fa)]
    out.write(sam.header({n: len(s) for n, s in contigs}))
    al = KmerAligner(contigs, k=seed_len, device=device)
    for batch in read_batches(read_files, 4096, 512):
        for a in al.align_batch(batch.codes[:batch.num_reads],
                                batch.lengths[:batch.num_reads],
                                batch.ids):
            if a is not None:
                out.write(sam.emit(a))


def wrapper_main(name: str, argv=None) -> int:
    """CLI for one wrapper: `<tool> target.fa reads... > out.sam`."""
    import argparse
    ap = argparse.ArgumentParser(prog=f"abyss-tpu-torch {name}")
    ap.add_argument("target")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-l", "--seed-length", type=int, default=32)
    ap.add_argument("-j", "--threads", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the native mapper [cuda]")
    args = ap.parse_args(argv)
    if not available(name):
        print(f"warning: external {name} not found; "
              "using the native mapper", file=sys.stderr)
    align_sam(name, args.target, args.reads, sys.stdout,
              seed_len=args.seed_length, threads=args.threads,
              device=args.device)
    return 0


def bwa_main(argv=None):
    return wrapper_main("bwa", argv)


def bwamem_main(argv=None):
    return wrapper_main("bwamem", argv)


def bowtie2_main(argv=None):
    return wrapper_main("bowtie2", argv)


def kaligner_main(argv=None):
    return wrapper_main("kaligner", argv)


def dida_main(argv=None):
    return wrapper_main("dida", argv)
