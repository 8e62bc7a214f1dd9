"""Minimal SAM record emit/parse.

The reference's pipeline stages communicate alignments as SAM over
pipes (Common/SAM.h, bin/abyss-pe:620-624).  This module provides the
same interchange: the mapper can emit SAM, fixmate can consume it.
"""

from __future__ import annotations

from dataclasses import dataclass

from .mapper import Alignment

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80


def header(ref_lengths: dict[str, int]) -> str:
    lines = ["@HD\tVN:1.4\tSO:unsorted"]
    for name, length in ref_lengths.items():
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    return "\n".join(lines) + "\n"


def emit(a: Alignment | None, qname: str | None = None,
         seq: str = "*", qual: str = "*") -> str:
    """One SAM line for an alignment (or an unmapped record)."""
    if a is None:
        return (f"{qname}\t{FLAG_UNMAPPED}\t*\t0\t0\t*\t*\t0\t0\t"
                f"{seq}\t{qual}\n")
    flag = FLAG_REVERSE if a.rev else 0
    alen = a.qend - a.qstart
    cigar = getattr(a, "cigar", None) or ""
    if not cigar:
        # soft-clip the unseeded head/tail (KAligner-style local
        # alignment); gapped alignments carry an explicit CIGAR
        if a.rev:
            lead, tail = a.read_len - a.qend, a.qstart
        else:
            lead, tail = a.qstart, a.read_len - a.qend
        if lead:
            cigar += f"{lead}S"
        cigar += f"{alen}M"
        if tail:
            cigar += f"{tail}S"
    return (f"{a.qname}\t{flag}\t{a.rname}\t{a.pos + 1}\t{a.mapq}\t{cigar}"
            f"\t*\t0\t0\t{seq}\t{qual}\n")


def parse(line: str, rlen_of: dict[str, int] | None = None,
          ) -> Alignment | None:
    """Parse one SAM line back into an Alignment (None for unmapped or
    header lines)."""
    if line.startswith("@"):
        return None
    f = line.rstrip("\n").split("\t")
    flag = int(f[1])
    if flag & FLAG_UNMAPPED or f[2] == "*":
        return None
    rev = bool(flag & FLAG_REVERSE)
    pos = int(f[3]) - 1
    cigar = f[5]
    lead = alen = tail = 0
    num = ""
    parts = []
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            parts.append((int(num), ch))
            num = ""
    for n, op in parts:
        if op == "M":
            alen += n
        elif op == "S" and alen == 0:
            lead = n
        elif op == "S":
            tail = n
    read_len = lead + alen + tail
    if rev:
        qstart, qend = tail, tail + alen
    else:
        qstart, qend = lead, lead + alen
    return Alignment(
        qname=f[0], rname=f[2], rev=rev, pos=pos, qstart=qstart, qend=qend,
        read_len=read_len, score=alen, mapq=int(f[4]),
        rlen=(rlen_of or {}).get(f[2], 0))
