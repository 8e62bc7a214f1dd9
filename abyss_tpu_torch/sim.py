"""Deterministic genome / short-read simulator for tests and benchmarks.

The reference's integration tests download a genome and simulate reads
with wgsim at a fixed seed (IntegrationTest/Konnector/integration-tests.mk:83-89).
This environment has no network egress, so we carry our own simulator:
random genome + paired-end sampler with substitution errors, fully
seeded for reproducibility.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .core import alphabet
from .io import fastx


def random_genome(length: int, seed: int = 0, gc: float = 0.5) -> str:
    rng = np.random.default_rng(seed)
    p_at = (1 - gc) / 2
    p_gc = gc / 2
    codes = rng.choice(4, size=length, p=[p_at, p_gc, p_gc, p_at])
    return alphabet.decode(codes.astype(np.uint8))


def genome_with_repeats(length: int, seed: int = 0, n_repeats: int = 4,
                        repeat_len: int = 500) -> str:
    """Random genome with a few exact repeated segments (scaffolding
    stress-case: repeats break unitigs)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length, dtype=np.uint8).copy()
    if n_repeats > 1 and length > repeat_len * (n_repeats + 1):
        src = rng.integers(0, length - repeat_len)
        unit = codes[src:src + repeat_len].copy()
        for _ in range(n_repeats):
            dst = rng.integers(0, length - repeat_len)
            codes[dst:dst + repeat_len] = unit
    return alphabet.decode(codes)


@dataclass
class PairedReads:
    reads1: list  # (id, seq, qual)
    reads2: list

    def write_fastq(self, path1: str, path2: str):
        for path, reads in ((path1, self.reads1), (path2, self.reads2)):
            with open(path, "w") as f:
                for rid, seq, qual in reads:
                    f.write(f"@{rid}\n{seq}\n+\n{qual}\n")

    def write_interleaved_fasta(self, path: str):
        with open(path, "w") as f:
            for (r1, r2) in zip(self.reads1, self.reads2):
                f.write(f">{r1[0]}\n{r1[1]}\n>{r2[0]}\n{r2[1]}\n")


def simulate_paired_reads(genome: str, coverage: float = 50.0,
                          read_len: int = 100, fragment_mean: int = 400,
                          fragment_sd: int = 40, error_rate: float = 0.0,
                          seed: int = 1) -> PairedReads:
    """wgsim-style paired-end sampler (fixed seed, substitution errors only).

    Pairs are FR-oriented: read1 from the forward strand at the fragment
    start, read2 reverse-complemented from the fragment end.
    """
    rng = np.random.default_rng(seed)
    G = len(genome)
    codes = alphabet.encode(genome)
    n_pairs = int(G * coverage / (2 * read_len))
    r1, r2 = [], []
    qual = "I" * read_len
    for i in range(n_pairs):
        frag = int(np.clip(rng.normal(fragment_mean, fragment_sd),
                           read_len + 2, G))
        start = int(rng.integers(0, G - frag + 1))
        c1 = codes[start:start + read_len].copy()
        c2 = alphabet.revcomp_codes(
            codes[start + frag - read_len:start + frag]).copy()
        for c in (c1, c2):
            if error_rate > 0:
                errs = rng.random(read_len) < error_rate
                if errs.any():
                    idx = np.nonzero(errs)[0]
                    c[idx] = (c[idx] + rng.integers(1, 4, len(idx))) % 4
        r1.append((f"sim_{i}/1", alphabet.decode(c1), qual))
        r2.append((f"sim_{i}/2", alphabet.decode(c2), qual))
    return PairedReads(r1, r2)
