"""Assembly correctness metrics vs a known reference genome.

Port of abyss_tpu/stats/samtobreak.py.  The role of Misc/samtobreak.hs
(abyss-samtobreak):
count contig breakpoints — places where a contig's alignment to the
reference jumps — plus aligned fraction and mismatch counts.  Instead
of parsing external SAM, contigs are aligned here with the k-mer seed
index: per contig, seed matches are grouped into (contig, strand,
diagonal) blocks; every extra block beyond the first is a breakpoint.
The index is built and the contigs are hashed on the device; the
grouping runs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import resolve_device, u64
from ..align.mapper import KmerIndex
from ..core import alphabet
from ..ops import nthash


@dataclass
class BreakStats:
    contigs: int = 0
    aligned_contigs: int = 0
    breakpoints: int = 0
    aligned_bases: int = 0
    total_bases: int = 0
    per_contig: dict = field(default_factory=dict)

    @property
    def aligned_fraction(self) -> float:
        return self.aligned_bases / max(self.total_bases, 1)


def contig_breakpoints(genome: str | list[tuple[str, str]],
                       contigs: list[tuple[str, str]], k: int = 32,
                       min_block: int = 100, device="cuda") -> BreakStats:
    """Align contigs to the reference on `device`; count alignment
    blocks."""
    dev = resolve_device(device)
    refs = [("ref", genome)] if isinstance(genome, str) else genome
    index = KmerIndex.build(refs, k, dev)
    # one bulk pull of the index to the host
    idx_h = u64.to_numpy(index.hashes)
    idx_fwd = index.is_fwd.cpu().numpy()
    idx_pos = index.pos.cpu().numpy()
    idx_contig = index.contig.cpu().numpy()
    N = len(idx_h)
    stats = BreakStats()
    for name, seq in contigs:
        stats.contigs += 1
        stats.total_bases += len(seq)
        if len(seq) < k:
            continue
        codes = alphabet.encode(seq)
        # hashed at a power-of-two padded length, as in the JAX package
        f, r, canon, valid = nthash.kmer_hashes_padded(codes, k, dev)
        W = len(seq) - k + 1
        canon_np = u64.to_numpy(canon[:W])
        read_fwd = (f == canon)[:W].cpu().numpy()
        valid_np = valid[:W].cpu().numpy()
        base = np.searchsorted(idx_h, canon_np)
        bc = np.minimum(base, max(N - 1, 0))
        hit = valid_np & (base < N) & (idx_h[bc] == canon_np) if N \
            else np.zeros(W, bool)
        strand = (idx_fwd[bc].astype(bool) != read_fwd)
        wv = np.arange(W)
        diag = np.where(strand, idx_pos[bc] + wv, idx_pos[bc] - wv)
        keys = np.where(
            hit,
            ((idx_contig[bc].astype(np.int64) * 2 +
              strand.astype(np.int64)) << 24) + diag + (1 << 22),
            -1)
        # group consecutive matching windows into blocks (allow small
        # diagonal jitter from indels: treat keys within +-2 as same)
        blocks = []
        cur_key, cur_start, cur_len = None, 0, 0
        for w in np.nonzero(keys >= 0)[0]:
            key = int(keys[w])
            if cur_key is not None and abs(key - cur_key) <= 2:
                cur_len = w - cur_start + k
            else:
                if cur_key is not None and cur_len >= min_block:
                    blocks.append((cur_start, cur_len))
                cur_key, cur_start, cur_len = key, w, k
        if cur_key is not None and cur_len >= min_block:
            blocks.append((cur_start, cur_len))
        if blocks:
            stats.aligned_contigs += 1
            stats.breakpoints += len(blocks) - 1
            stats.aligned_bases += sum(b[1] for b in blocks)
        stats.per_contig[name] = len(blocks)
    return stats


def sam_breakpoints(sam, min_align: int = 100) -> BreakStats:
    """Breakpoint metrics from an EXTERNAL SAM of contig-to-reference
    alignments (the Misc/samtobreak.hs input contract: alignments from
    any mapper; records shorter than min_align are ignored; each extra
    alignment block of a contig beyond the first is a breakpoint).

    `sam` is an iterable of SAM lines or a path."""
    import os
    import re
    own = isinstance(sam, (str, os.PathLike))
    f = open(sam) if own else sam
    per: dict[str, list] = {}
    lengths: dict[str, int] = {}
    try:
        for line in f:
            if not line or line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 11:
                continue
            qname, flag, rname, pos, _, cigar = fields[:6]
            flag = int(flag)
            if flag & 0x100 or flag & 0x800 or rname == "*":
                continue  # secondary/supplementary like the Haskell tool
            qlen = 0
            aligned = 0
            for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
                n = int(n)
                if op in "M=X":
                    aligned += n
                    qlen += n
                elif op in "IS":
                    qlen += n
            lengths[qname] = max(lengths.get(qname, 0), qlen)
            if aligned >= min_align:
                per.setdefault(qname, []).append(
                    (rname, int(pos), aligned))
    finally:
        if own:
            f.close()
    stats = BreakStats()
    stats.contigs = len(lengths)
    stats.total_bases = sum(lengths.values())
    for name, blocks in per.items():
        stats.aligned_contigs += 1
        stats.aligned_bases += sum(b[2] for b in blocks)
        stats.breakpoints += len(blocks) - 1
        stats.per_contig[name] = len(blocks) - 1
    return stats
