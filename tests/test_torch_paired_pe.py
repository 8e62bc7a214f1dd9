"""The port's `pe K=` (stage 1 through the paired DBG) and `paired-dbg`
tool against abyss_tpu's, on the CPU, byte for byte.

pe k=50 K=25 is tests/test_pe_libraries.py::test_pe_paired_dbg_K50_k25
(span 50 of two 25-mers, the wide pair mode) run by both packages:
every artifact must be identical.  The tool runs packed (-k 40 -K 14)
and wide (-k 80 -K 40); both packages refuse k < 2K.
"""

import os

import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.cli import tools2 as jtools2
from abyss_tpu.pipeline import pe as jpe
from abyss_tpu_torch.cli import tools2 as ttools2
from abyss_tpu_torch.pipeline import pe as tpe

torch.set_num_threads(1)


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    base = tmp_path_factory.mktemp("paired")
    genome = sim.random_genome(6000, seed=61)
    pr = sim.simulate_paired_reads(genome, coverage=35, read_len=100,
                                   seed=62)
    p1, p2 = str(base / "k1.fq"), str(base / "k2.fq")
    pr.write_fastq(p1, p2)
    return base, [p1, p2], genome


def pe_params(mod, outdir, files, **kw):
    extra = {"device": "cpu"} if mod is tpe else {}
    return mod.PipelineParams(
        name="kp", k=50, K=25, in_files=list(files), outdir=str(outdir),
        min_pairs=5, verbose=0, batch_size=2048, max_read_len=128,
        **extra, **kw)


@pytest.fixture(scope="module")
def pe_runs(reads):
    base, files, _ = reads
    jdir, tdir = base / "jax", base / "port"
    jpe.run(pe_params(jpe, jdir, files))
    tpe.run(pe_params(tpe, tdir, files))
    return jdir, tdir


def test_pe_paired_lists_the_same_artifacts(pe_runs):
    jdir, tdir = pe_runs
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert "kp-8.fa" in os.listdir(tdir)


PE_FILES = ["kp-" + s for s in (
    "1.fa", "1.dot", "2.fa", "2.dot", "3.fa", "3.dot", "3.dist", "3.hist",
    "4.fa", "4.dot", "4.path1", "4.path2", "4.path3", "5.fa", "5.dot",
    "5.path", "6.fa", "6.dot", "6.path", "6.dist.dot", "6.hist", "7.fa",
    "7.dot", "7.path", "8.fa", "8.dot", "stats.tab", "stats.csv",
    "stats.md")]


@pytest.mark.parametrize("name", PE_FILES)
def test_pe_paired_artifact_matches_jax(pe_runs, name):
    jdir, tdir = pe_runs
    if os.path.islink(jdir / name):
        assert os.readlink(tdir / name) == os.readlink(jdir / name)
    else:
        assert read(tdir / name) == read(jdir / name)


def test_pe_paired_assembles_the_genome(pe_runs, reads):
    """As test_pe_paired_dbg_K50_k25: the scaffolds sum to > 0.8 of the
    genome."""
    _, tdir = pe_runs
    seqs = read(tdir / "kp-8.fa").decode().split("\n")[1::2]
    assert sum(len(s) for s in seqs) > 0.8 * len(reads[2])


@pytest.mark.parametrize("mod", [jpe, tpe], ids=["jax", "port"])
def test_pe_paired_refuses_k_below_2K(tmp_path, reads, mod):
    p = pe_params(mod, tmp_path / "o", reads[1])
    p.k = 49
    with pytest.raises(ValueError, match="PAIR SPAN"):
        mod.run(p)


@pytest.mark.parametrize("span,single,kc", [(40, 14, 2), (80, 40, 2),
                                            (50, 25, 3)])
def test_paired_dbg_cli_matches_jax(tmp_path, reads, span, single, kc):
    _, files, _ = reads
    outs = {}
    for tag, main, extra in (("jax", jtools2.paireddbg_main, []),
                             ("port", ttools2.paireddbg_main,
                              ["--device", "cpu"])):
        out = str(tmp_path / f"{tag}.fa")
        assert main(files + ["-k", str(span), "-K", str(single), "--kc",
                             str(kc), "-o", out] + extra) == 0
        outs[tag] = read(out)
    assert outs["port"] == outs["jax"]
    assert outs["port"].count(b">") > 0


@pytest.mark.parametrize("main", [jtools2.paireddbg_main,
                                  ttools2.paireddbg_main],
                         ids=["jax", "port"])
def test_paired_dbg_cli_refuses_k_below_2K(tmp_path, reads, main):
    with pytest.raises(SystemExit):
        main(reads[1] + ["-k", "40", "-K", "25", "-o",
                         str(tmp_path / "o.fa")])


def test_paired_dbg_cli_needs_a_card(tmp_path, reads):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        ttools2.paireddbg_main(reads[1] + ["-k", "40", "-K", "14", "-o",
                                           str(tmp_path / "o.fa")])
