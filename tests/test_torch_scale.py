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
"""

import hashlib
import io
import json

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
