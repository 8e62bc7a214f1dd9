"""`pe np=`/`nh=` of the port against abyss_tpu's, through `pe.run`
(`python -m abyss_tpu_torch pe ... device=cpu` parses to the same
parameters), on the 8-device CPU mesh (tests/conftest.py).

Each configuration runs the whole pipeline once in each package on the
same reads, in batches of 1,024 reads (pe's default of 16,384 pads
these reads to 16 times their size and takes four times as long here);
every artifact must be byte-identical.  The reads: a 4 kbp
genome from two haplotypes that differ by one SNP (so stage 1 of the
exact engine pops a bubble on the mesh), 20x of 100 bp pairs with
substitution errors.  Configurations: the bloom engine at np=8 (a
4 x 2 mesh, the filter sharded, pass 2 probing the shards) and the
exact engine at np=6 (not a power of two: mesh count, single-device
phases); tests/test_torch_parallel_pe_sharded.py runs the sharded exact
engine (np=8, and np=4 nh=2 on the host mesh)."""

import os

import jax
import pytest
import torch

from abyss_tpu.pipeline import pe as jpe
from abyss_tpu_torch import sim
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.pipeline import pe as tpe

torch.set_num_threads(1)

NAME = "npt"
ARTIFACTS_EXACT = [f"{NAME}-{s}" for s in (
    "1.fa", "1.dot", "2.fa", "2.dot", "3.fa", "3.dot", "3.dist", "4.fa",
    "4.dot", "6.fa", "6.dot", "8.fa", "8.dot", "stats.tab", "stats.csv")]
ARTIFACTS_BLOOM = ARTIFACTS_EXACT + [f"{NAME}-1-rr.fa", f"{NAME}-1-rr.dot"]


def write_reads(d, seed=88):
    g = alphabet.encode(sim.random_genome(4000, seed=seed))
    alt = g.copy()
    alt[2000] = (alt[2000] + 1) % 4
    r1, r2 = [], []
    for i, h in enumerate((g, alt)):
        pr = sim.simulate_paired_reads(alphabet.decode(h), coverage=10,
                                       read_len=100, error_rate=0.003,
                                       seed=seed + 1 + i)
        r1 += [(f"h{i}" + a, b, c) for a, b, c in pr.reads1]
        r2 += [(f"h{i}" + a, b, c) for a, b, c in pr.reads2]
    paths = [os.path.join(d, "n1.fq"), os.path.join(d, "n2.fq")]
    sim.PairedReads(r1, r2).write_fastq(*paths)
    return paths


def params(mod, reads, outdir, **kw):
    """pe parameters of both packages (k = 25, mate pairs from 3, a
    1 MiB filter, batches of 1,024 reads of up to 128 bases)."""
    if mod is tpe:
        kw["device"] = "cpu"
    return mod.PipelineParams(name=NAME, k=25, in_files=list(reads),
                              outdir=str(outdir), min_pairs=3,
                              bloom_bytes=1 << 20, verbose=0,
                              batch_size=1024, max_read_len=128, **kw)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return write_reads(str(tmp_path_factory.mktemp("npreads")))


def run_both(reads, base, **kw):
    """(JAX outdir, port outdir) of one pe run of each package with the
    parameters kw."""
    jdir, tdir = base / "jax", base / "port"
    jpe.run(params(jpe, reads, jdir, **kw))
    tpe.run(params(tpe, reads, tdir, **kw))
    return jdir, tdir


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_artifacts(jdir, tdir, names):
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in names:
        assert read(tdir / name) == read(jdir / name), name


@pytest.fixture(scope="module")
def bloom8(reads, tmp_path_factory):
    return run_both(reads, tmp_path_factory.mktemp("bloom8"), np_devices=8)


@pytest.fixture(scope="module")
def exact6(reads, tmp_path_factory):
    return run_both(reads, tmp_path_factory.mktemp("exact6"), np_devices=6,
                    engine="exact")


@pytest.mark.parametrize("name", ARTIFACTS_BLOOM)
def test_bloom_np8_matches_jax(bloom8, name):
    jdir, tdir = bloom8
    assert read(tdir / name) == read(jdir / name)


def test_bloom_np8_runs_on_the_mesh(bloom8):
    """np=8 writes every artifact abyss_tpu's run writes, and a real
    assembly."""
    jdir, tdir = bloom8
    assert_same_artifacts(jdir, tdir, ARTIFACTS_BLOOM)
    seqs = [l for l in read(tdir / f"{NAME}-8.fa").decode().splitlines()
            if not l.startswith(">")]
    assert sum(map(len, seqs)) > 3500


@pytest.mark.parametrize("name", ARTIFACTS_EXACT)
def test_exact_np6_matches_jax(exact6, name):
    jdir, tdir = exact6
    assert read(tdir / name) == read(jdir / name)


def test_parse_and_branch_logs(reads, tmp_path, capfd):
    """np= and nh= parse as abyss_tpu's; the mesh branches log
    abyss_tpu's lines, and np above the devices there are logs the
    single-device build."""
    p = tpe.parse_params(["np=4", "nh=2", "k=25", "device=cpu"])
    assert (p.np_devices, p.n_hosts) == (4, 2)
    p = params(tpe, reads, tmp_path, np_devices=16)
    p.verbose = 1
    tpe.stage_unitigs_1(p)
    err = capfd.readouterr().err
    assert "np=16 requested but only 8 devices; single-device build" in err
    p.np_devices, p.engine = 8, "exact"
    os.remove(p.path("1.fa"))
    tpe.stage_unitigs_1(p)
    assert "stage 1: mesh-sharded table over 8 devices (np=)" in \
        capfd.readouterr().err
