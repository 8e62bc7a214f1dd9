"""The packed paired de Bruijn graph (`pe k=<span> K=16`) against the
plain reference of the pair graph (asmbench/reference_paired.py), which
is written from the definitions and shares no code with the port: on
seeded random genomes with 2 x 150 bp reads, stage 1 writes the
reference's sequences and the engine's coverages are its sums."""

import numpy as np
import pytest
import torch

from abyss_tpu_torch.dbg import paired_dbg
from abyss_tpu_torch.pipeline import pe
from asmbench import gen, reference_paired

torch.set_num_threads(1)

K = 16


def _reads(genome_bp: int, seed: int, coverage: int = 40):
    genome = gen.genome_with_repeats(genome_bp, seed, 4, 300)
    n_pairs = genome_bp * coverage // 300
    return gen.simulate_pairs(genome, n_pairs, 150, 400, 40, 0.005,
                              seed + 1)


def _stage_1(tmp_path, reads, span: int, kc: int, monkeypatch):
    """name-1.fa's sequences and what assemble_pairs returned."""
    paths = [str(tmp_path / f"r{m}.fq") for m in (1, 2)]
    for mate, (path, rows) in enumerate(zip(paths, reads), 1):
        gen.write_fastq(path, rows, mate)
    got = []
    engine = paired_dbg.assemble_pairs

    def spy(*args, **kwargs):
        got.extend(engine(*args, **kwargs))
        return got
    monkeypatch.setattr(paired_dbg, "assemble_pairs", spy)
    p = pe.PipelineParams(in_files=paths, outdir=str(tmp_path), name="p",
                          k=span, K=K, kc=kc, device="cpu", verbose=0)
    with open(pe.stage_unitigs_1(p), "rb") as f:
        records = gen.parse_fasta(f.read())
    return [s.decode() for _, s in records], got


@pytest.mark.parametrize("span,kc,seed", [(96, 2, 3), (96, 3, 4),
                                          (32, 2, 5)],
                         ids=["k96_kc2", "k96_kc3", "zero_gap_k32"])
def test_stage_1_matches_the_plain_pair_graph(tmp_path, monkeypatch, span,
                                              kc, seed):
    reads = _reads(15000, seed)
    written, engine = _stage_1(tmp_path, reads, span, kc, monkeypatch)
    ref = reference_paired.assemble(list(reads), K, span, kc=kc)
    assert len(ref) > 5
    assert set(written) == {s for s, _ in ref}
    assert len(written) == len(ref)
    assert sorted(engine) == sorted(ref)


def test_reference_spells_an_error_free_genome():
    """Error-free reads tiling a random genome, every pair kept (kc 1):
    one unitig, the genome in canonical form, with every pair window
    of every read counted."""
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 3000, dtype=np.uint8)
    starts = np.arange(0, len(genome) - 150 + 1, 7)
    reads = genome[starts[:, None] + np.arange(150)[None, :]]
    (seq, cov), = reference_paired.assemble([reads], K, 96, kc=1)
    text = gen.decode(genome[:starts[-1] + 150])
    assert seq == min(text, reference_paired.revcomp(text))
    windows = 150 - 96 + 1
    assert cov == len(starts) * windows


def test_reference_leaves_n_between_the_windows_of_a_short_chain():
    """A chain of L < span - 2k + 1 pairs covers its a and b windows
    and leaves N between them."""
    rng = np.random.default_rng(10)
    genome = rng.integers(0, 4, 110, dtype=np.uint8)
    reads = np.stack([genome[:100]] * 2)          # 5 pair windows, twice
    (seq, cov), = reference_paired.assemble([reads], K, 96, tip_len=0)
    L = 100 - 96 + 1
    text = gen.decode(genome[:L - 1 + K]) + "N" * (96 - 2 * K - L + 1) + \
        gen.decode(genome[96 - K:100])
    assert len(text) == L - 1 + 96
    assert seq == min(text, reference_paired.revcomp(text))
    assert cov == 2 * L


def test_reference_trims_a_tip():
    """A branch of a few pairs off the genome's path, seen twice, is a
    tip: gone at t = span, kept at t = 0."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 1200, dtype=np.uint8)
    starts = np.arange(0, len(genome) - 150 + 1, 5)
    reads = genome[starts[:, None] + np.arange(150)[None, :]]
    tip = genome[500:600].copy()
    tip[-1] = (tip[-1] + 1) % 4                  # the last pair branches
    sample = [reads, np.stack([tip, tip])]
    trimmed = reference_paired.assemble(sample, K, 96)
    kept = reference_paired.assemble(sample, K, 96, tip_len=0)
    assert len(trimmed) == 1 and len(kept) > 1
