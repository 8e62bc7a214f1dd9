"""Consensus: per-position base calling from read alignments (pileup).

The role of the reference's Consensus/Consensus.cpp:40-55 (used for
finishing): align reads to contigs, then call the majority base at each
position.  Batched: votes accumulate with one scatter-add per read
batch.

Port of abyss_tpu/align/consensus.py (no jax there): a copy.
"""

from __future__ import annotations

import numpy as np

from ..core import alphabet
from .mapper import Alignment


class Pileup:
    def __init__(self, contigs: list[tuple[str, str]]):
        self.names = [n for n, _ in contigs]
        self.seqs = dict(contigs)
        self.votes = {n: np.zeros((len(s), 4), np.int32)
                      for n, s in contigs}

    def add(self, a: Alignment | None, seq: str):
        if a is None or a.rname not in self.votes:
            return
        codes = alphabet.encode(seq)
        if a.rev:
            codes = alphabet.revcomp_codes(codes)
            qs = a.read_len - a.qend
        else:
            qs = a.qstart
        seg = codes[qs:qs + (a.qend - a.qstart)]
        v = self.votes[a.rname]
        end = min(a.pos + len(seg), v.shape[0])
        seg = seg[:max(end - a.pos, 0)]
        ok = seg < 4
        idx = np.arange(a.pos, a.pos + len(seg))[ok]
        np.add.at(v, (idx, seg[ok]), 1)

    def call(self, min_cov: int = 1) -> list[tuple[str, str]]:
        """Majority-vote consensus; positions below min_cov keep the
        original contig base."""
        out = []
        for n in self.names:
            v = self.votes[n]
            orig = alphabet.encode(self.seqs[n])
            cov = v.sum(axis=1)
            best = v.argmax(axis=1).astype(np.uint8)
            called = np.where(cov >= min_cov, best, orig)
            out.append((n, alphabet.decode(called.astype(np.uint8))))
        return out
