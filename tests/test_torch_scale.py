"""The JAX package's stage 1 on the reads of chip_smoke.py's main phase
(its sampler and parameters: 150 bp pairs, 40x, substitution error
0.005, k=31, the CLI defaults), on the CPU.

It prints the reference's contig statistics and FASTA sha256, which the
card's run of the port (chip_smoke.py prints the same fields) must
match, and holds the reference to the smoke run's cover check: stage 1
alone covers well under 0.9 of the genome with contigs >= 500 bp,
which is why chip_smoke.py checks 0.8 (MIN_COVER_500).  At 200 kbp the port on the CPU
must write the same bytes.  Slow: minutes at 200 kbp, an hour or more
at 4.6 Mbp.

    python -m pytest tests/test_torch_scale.py -m slow -s -k 200000

test_pe_at_smoke_parameters runs the whole `pe` pipeline of both
packages on those reads (pe's own defaults at k=31, as chip_smoke.py's
pe phase): every artifact must be byte-identical, and it prints how
many of PathConsensus's consensus contigs (name-5.fa) are genome
substrings and how the scaffolds' N-free blocks place on the genome.
"""

import hashlib
import io
import json
import os
import time

import pytest
import torch

import chip_smoke
from abyss_tpu import sim
from abyss_tpu.core import alphabet
from abyss_tpu.dbg import bloom_dbg as jbd
from abyss_tpu.dbg.params import AssemblyParams as JParams
from abyss_tpu_torch.dbg import bloom_dbg as tbd
from abyss_tpu_torch.dbg.params import AssemblyParams as TParams

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)


@pytest.mark.slow
@pytest.mark.parametrize("genome_bp", [200_000, 1_000_000, 4_600_000])
def test_reference_at_smoke_parameters(tmp_path, genome_bp):
    genome = sim.genome_with_repeats(genome_bp, seed=7, n_repeats=12,
                                     repeat_len=700)
    n_pairs = int(genome_bp * 40.0 / 300)
    paths = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    chip_smoke.simulate_reads(alphabet.encode(genome), n_pairs, 150, 500,
                              50, 0.005, 11, *paths)
    out = io.StringIO()
    jbd.assemble(paths, JParams(k=31), out=out)
    fasta = out.getvalue()
    seqs = [ln for ln in fasta.splitlines() if not ln.startswith(">")]
    long_ = [s for s in seqs if len(s) >= 500]
    cover = sum(map(len, long_)) / genome_bp
    print(json.dumps(dict(
        genome_bp=genome_bp, contigs=len(seqs),
        total_bases=sum(map(len, seqs)), contigs_500=len(long_),
        cover_500=cover,
        fasta_sha256=hashlib.sha256(fasta.encode()).hexdigest())))
    assert chip_smoke.MIN_COVER_500 <= cover < 0.9
    if genome_bp <= 200_000:
        port = io.StringIO()
        tbd.assemble(paths, TParams(k=31), out=port, device="cpu")
        assert port.getvalue() == fasta


@pytest.mark.slow
@pytest.mark.parametrize("genome_bp", [200_000])
def test_pe_at_smoke_parameters(tmp_path, genome_bp):
    from abyss_tpu.pipeline import pe as jpe
    from abyss_tpu_torch.io import fastx
    from abyss_tpu_torch.pipeline import pe as tpe
    genome = sim.genome_with_repeats(genome_bp, seed=7, n_repeats=12,
                                     repeat_len=700)
    n_pairs = int(genome_bp * 40.0 / 300)
    paths = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    chip_smoke.simulate_reads(alphabet.encode(genome), n_pairs, 150, 500,
                              50, 0.005, 11, *paths)
    wall = {}
    for name, mod, kw in (("jax", jpe, {}), ("port", tpe, {"device": "cpu"})):
        t0 = time.perf_counter()
        mod.run(mod.PipelineParams(name="pe", k=31, in_files=paths,
                                   outdir=str(tmp_path / name), verbose=0,
                                   **kw))
        wall[name] = time.perf_counter() - t0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if os.path.islink(a):
            assert os.readlink(a) == os.readlink(b), name
        else:
            assert a.read_bytes() == b.read_bytes(), name
    rc = alphabet.revcomp(genome)
    consensus = [r.seq for r in fastx.read_fastx(str(tmp_path / "port" /
                                                     "pe-5.fa"))]
    strands = ((genome, alphabet.encode(genome)), (rc, alphabet.encode(rc)))
    blocks = [b for r in fastx.read_fastx(str(tmp_path / "port" / "pe-8.fa"))
              for b in r.seq.split("N") if len(b) >= 500]
    placed = [chip_smoke.ungapped_mismatches(b, strands) for b in blocks]
    print(json.dumps(dict(
        genome_bp=genome_bp, artifacts=len(names), wall_s=wall,
        consensus_contigs=len(consensus),
        consensus_not_substring=sum(1 for c in consensus
                                    if c not in genome and c not in rc),
        blocks_500=len(blocks), blocks_500_exact=sum(p == [] for p in placed),
        blocks_500_unplaced=sum(p is None for p in placed),
        substitutions_500=sum(len(p) for p in placed if p))))
    assert not any(p is None for p in placed)
