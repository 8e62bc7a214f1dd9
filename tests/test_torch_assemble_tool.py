"""The `assemble` tool (the exact hash-DBG assembler, ABYSS) of the
port against abyss_tpu's on the CPU: contigs, popped bubbles and the
coverage histogram byte for byte at packed k and wide k, `.kmer`
snapshots with equal arrays that resume across packages both ways, a
-k 21-25:2 sweep, and the default device.
"""

import os

import numpy as np
import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.cli import tools as jtools
from abyss_tpu_torch.cli import tools as ttools

# one intra-op thread a worker process (see test_torch_hash_dbg.py)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def asm_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("asm")
    genome = sim.genome_with_repeats(6000, seed=61, n_repeats=2,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=30, read_len=100,
                                   error_rate=0.004, seed=62)
    paths = [str(d / "a1.fq"), str(d / "a2.fq")]
    pr.write_fastq(*paths)
    return paths


def assemble_both(tmp_path, args, outputs=("out.fa",)) -> tuple[dict, dict]:
    """Run both packages' assemble CLI with `args` (OUT/ in them names
    the package's own output directory); returns {output: bytes} of
    each."""
    got = []
    for tag, fn, extra in (("jax", jtools.abyss_main, []),
                           ("port", ttools.assemble_main,
                            ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        fn([a.replace("OUT/", f"{d}/") for a in args] + extra)
        got.append({name: (d / name).read_bytes() for name in outputs})
    return got[0], got[1]


@pytest.mark.parametrize("k", [25, 32, 64])
def test_assemble_cli(asm_reads, tmp_path, k):
    """Contigs, popped bubbles and the coverage histogram byte for byte;
    the `.kmer` snapshots hold equal arrays."""
    outs = ("out.fa", "bubbles.fa", "cov.hist")
    want, got = assemble_both(
        tmp_path, [*asm_reads, "-k", str(k), "-o", "OUT/out.fa",
                   "--bubbles", "OUT/bubbles.fa", "--coverage-hist",
                   "OUT/cov.hist", "--snapshot", "OUT/snap.kmer"], outs)
    assert got == want
    assert want["out.fa"].count(b">") > 1
    with np.load(tmp_path / "jax" / "snap.kmer") as j, \
            np.load(tmp_path / "port" / "snap.kmer") as t:
        assert sorted(j.files) == sorted(t.files)
        for name in j.files:
            np.testing.assert_array_equal(t[name], j[name])
            assert t[name].dtype == j[name].dtype


@pytest.mark.parametrize("k", [25, 64])
def test_assemble_snapshot_resumes_across_packages(asm_reads, tmp_path, k):
    """A snapshot written by one package assembles in the other to the
    same contigs as in its own."""
    snaps = {}
    for tag, fn, extra in (("jax", jtools.abyss_main, []),
                           ("port", ttools.assemble_main,
                            ["--device", "cpu"])):
        snaps[tag] = str(tmp_path / f"{tag}.kmer")
        fn([*asm_reads, "-k", str(k), "--kc", "1", "-e", "0", "-b", "0",
            "-o", str(tmp_path / f"{tag}.fa"), "--snapshot", snaps[tag]]
           + extra)
    outs = {}
    for snap in ("jax", "port"):
        for tag, fn, extra in (("jax", jtools.abyss_main, []),
                               ("port", ttools.assemble_main,
                                ["--device", "cpu"])):
            out = str(tmp_path / f"{snap}-in-{tag}.fa")
            fn([snaps[snap], "-k", str(k), "--kc", "2", "-o", out] + extra)
            outs[snap, tag] = open(out, "rb").read()
    assert len(set(outs.values())) == 1
    assert outs["jax", "jax"].count(b">") > 1


def test_assemble_sweep(asm_reads, tmp_path):
    want, got = assemble_both(
        tmp_path, [*asm_reads, "-k", "21-25:2", "-o", "OUT/out.fa"])
    assert got == want
    assert want["out.fa"].count(b">") > 1


def test_assemble_cli_defaults_to_the_card(asm_reads, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttools.assemble_main([*asm_reads, "-k", "25", "-o",
                              str(tmp_path / "x.fa")])
    assert not os.path.exists(tmp_path / "x.fa")
