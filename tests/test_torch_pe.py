"""The whole `pe` pipeline of the port against abyss_tpu's, on the CPU.

One module-scoped fixture runs abyss_tpu's pe and the port's pe
(device="cpu") once each on the same reads and parameters; every
artifact (stage FASTA, graphs, paths, histograms, distance estimates,
stats tables and the unitigs/contigs/scaffolds links) must be
byte-identical.  The port then resumes from the JAX run's artifacts
after stage 3 and after stage 6 and must write the same scaffolds.

The genome: 12 kbp of random sequence (seed 3) holding a 300-base
repeat in four copies and a 50-base repeat twice, sequenced from three
haplotypes mixed in equal parts (the reference, one with a SNP at 5500,
one with a SNP at 5515), 40x of 100 bp FR pairs with fragments of
500 +- 50 and substitution errors of 0.003.  On it:
  * RResolver cuts an edge at the 50-base repeat (shorter than its
    r-mers, so reads tell its true crossings apart);
  * the two SNPs on different haplotypes make a tangle that PopBubbles
    leaves, so SimpleGraph writes seed paths with ambiguous gaps and
    PathConsensus (stage 5) resolves them;
  * the 300-base repeat, longer than a read but shorter than a
    fragment, leaves contigs that mate pairs join across a gap: stage 8
    writes a scaffold with an N run.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from abyss_tpu.pipeline import pe as jpe
from abyss_tpu_torch import sim
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.pipeline import pe as tpe

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

NAME, LIB = "t", "pea"


def haplotypes(n=12000, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    f = n / 20000
    rep = g[int(1000 * f):int(1000 * f) + 300].copy()
    for p in (5200, 10400, 16800):
        g[int(p * f):int(p * f) + 300] = rep
    short = rng.integers(0, 4, 50).astype(np.uint8)
    for p in (3000, 13000):
        g[int(p * f):int(p * f) + 50] = short
    haps = [g]
    for pos in (5500, 5515):
        h = g.copy()
        h[pos] = (h[pos] + 1) % 4
        haps.append(h)
    return [alphabet.decode(h) for h in haps]


def write_reads(d, seed=3, coverage=40):
    haps = haplotypes(seed=seed)
    r1, r2 = [], []
    for i, h in enumerate(haps):
        pr = sim.simulate_paired_reads(
            h, coverage=coverage / len(haps), read_len=100,
            fragment_mean=500, fragment_sd=50, error_rate=0.003,
            seed=seed * 10 + i)
        r1 += [(f"h{i}" + a, b, c) for a, b, c in pr.reads1]
        r2 += [(f"h{i}" + a, b, c) for a, b, c in pr.reads2]
    paths = [os.path.join(d, "r1.fq"), os.path.join(d, "r2.fq")]
    sim.PairedReads(r1, r2).write_fastq(*paths)
    return paths


def params(mod, outdir, reads, **kw):
    """pe parameters of both packages: library `pea` (its files the
    reads), k = 31, mate pairs from 5, a small filter and batches."""
    extra = {"device": "cpu"} if mod is tpe else {}
    extra.update(kw)
    return mod.PipelineParams(
        name=NAME, k=31, libs={LIB: mod.Library(LIB, list(reads))},
        pe_names=[LIB], mp_names=[LIB], bloom_bytes=32 << 20,
        outdir=str(outdir), min_pairs=5, verbose=0, batch_size=2048,
        max_read_len=128, **extra)


# the artifacts of the bloom engine's chain, by file name
ARTIFACTS = (
    [f"{NAME}-{s}" for s in (
        "1.fa", "1.dot", "1-rr.fa", "1-rr.dot", "2.fa", "2.dot", "3.fa",
        "3.dot", "3.dist", "3.dist.dot", "4.fa", "4.dot", "4.path1",
        "4.path2", "4.path3", "5.fa", "5.dot", "5.path", "6.fa", "6.dot",
        "6.path", "6.dist.dot", "7.fa", "7.dot", "7.path", "8.fa", "8.dot",
        "stats.tab", "stats.csv", "stats.md")]
    + [f"{LIB}-{s}" for s in ("3.hist", "3.dist", "6.hist", "6.dist.dot")])
LINKS = [f"{NAME}-{s}" for s in ("unitigs.fa", "unitigs.dot", "contigs.fa",
                                 "contigs.dot", "scaffolds.fa",
                                 "scaffolds.dot")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reads, JAX outdir, port outdir) of one pe run of each package."""
    base = tmp_path_factory.mktemp("pe")
    reads = write_reads(str(base))
    jdir, tdir = base / "jax", base / "port"
    jpe.run(params(jpe, jdir, reads))
    tpe.run(params(tpe, tdir, reads))
    return reads, jdir, tdir


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifact_bytes_match_jax(runs, name):
    _, jdir, tdir = runs
    assert read(tdir / name) == read(jdir / name)


@pytest.mark.parametrize("name", LINKS)
def test_links_match_jax(runs, name):
    _, jdir, tdir = runs
    assert os.readlink(tdir / name) == os.readlink(jdir / name)


def test_no_other_artifacts(runs):
    _, jdir, tdir = runs
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == \
        sorted(ARTIFACTS + LINKS)


def out_edges(dot: str) -> dict:
    """{vertex: its successors} of a graph in the dot dialect."""
    out = {}
    for line in dot.splitlines():
        if "->" in line:
            u, vs = line.split("->")
            out[u.strip().strip('"')] = {
                v.strip('"') for v in vs.strip(" {}").split()}
    return out


def test_genome_exercises_every_stage(runs):
    """RResolver cut an edge, SimpleGraph wrote seed paths, stage 5
    resolved an ambiguous gap, stage 8 wrote a scaffold with N."""
    _, jdir, _ = runs
    before, after = (out_edges(read(jdir / f"{NAME}-{s}.dot").decode())
                     for s in ("1", "1-rr"))
    assert any(after.get(u, set()) < vs for u, vs in before.items())
    assert read(jdir / f"{NAME}-4.path1").strip()
    assert b"N" in read(jdir / f"{NAME}-4.path3")
    assert read(jdir / f"{NAME}-5.fa").count(b">") >= 1
    scaffolds = read(jdir / f"{NAME}-8.fa").split(b">")[1:]
    assert any(b"N" in s.split(b"\n", 1)[1] for s in scaffolds)


# stage outputs that Make-style resume finds done: after stage 3 and
# after stage 6 (the next stage starts where the first of its outputs is
# missing)
DONE_AFTER = {
    3: [f"{NAME}-{s}" for s in ("1.fa", "1.dot", "1-rr.fa", "1-rr.dot",
                                 "2.fa", "2.dot", "3.fa", "3.dot")],
    6: [f"{NAME}-{s}" for s in ("1.fa", "1.dot", "1-rr.fa", "1-rr.dot",
                                 "2.fa", "2.dot", "3.fa", "3.dot", "3.dist",
                                 "3.dist.dot", "4.fa", "4.dot", "4.path1",
                                 "4.path2", "4.path3", "5.fa", "5.dot",
                                 "5.path", "6.fa", "6.dot")]
    + [f"{LIB}-{s}" for s in ("3.hist", "3.dist")]}


@pytest.mark.parametrize("stage", [3, 6])
def test_resume_from_jax_artifacts(runs, tmp_path, stage):
    """A JAX run stopped after stage 3 or 6: the port finishes it and
    writes the JAX run's scaffolds and everything after the stop."""
    reads, jdir, _ = runs
    for name in DONE_AFTER[stage]:
        shutil.copy(jdir / name, tmp_path / name)
    tpe.run(params(tpe, tmp_path, reads))
    for name in ARTIFACTS:
        assert read(tmp_path / name) == read(jdir / name), name


def test_external_aligner_missing_falls_back_to_the_mapper(runs, tmp_path,
                                                           monkeypatch):
    """aligner=bwa without a bwa binary: the native mapper runs, as in
    the JAX package, and the scaffolds are the mapper's."""
    reads, jdir, _ = runs
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for name in DONE_AFTER[3]:
        shutil.copy(jdir / name, tmp_path / name)
    tpe.run(params(tpe, tmp_path, reads, aligner="bwa"))
    assert read(tmp_path / f"{NAME}-8.fa") == read(jdir / f"{NAME}-8.fa")


def test_cli_resumes_and_prints_stats(runs, tmp_path, capsys, monkeypatch):
    """`python -m abyss_tpu_torch pe ... device=cpu` in a directory that
    holds a finished run prints its stats table."""
    from abyss_tpu_torch import __main__ as cli
    reads, jdir, _ = runs
    for name in ARTIFACTS:
        shutil.copy(jdir / name, tmp_path / name)
    argv = ["abyss_tpu_torch", "pe", f"name={NAME}", "k=31",
            f"in={' '.join(reads)}", f"outdir={tmp_path}", "n=5",
            "device=cpu", "v=0"]
    monkeypatch.setattr(sys, "argv", argv)
    assert cli.main() in (None, 0)
    assert capsys.readouterr().out == read(
        jdir / f"{NAME}-stats.tab").decode()
    p = tpe.parse_params(argv[2:])
    assert p.device == "cpu" and p.min_pairs == 5
    assert tpe.parse_params(["k=31"]).device == "cuda"


UNPORTED = {
    "exact": dict(engine="exact"), "K": dict(K=15),
    "np": dict(np_devices=2), "nh": dict(n_hosts=2), "cs": dict(cs=True),
    "lr": dict(lr_files=["lr.fq"]), "long": dict(long_files=["long.fa"]),
    "sealer": dict(sealer_ks=[25])}


@pytest.mark.parametrize("branch", list(UNPORTED))
def test_unported_branch_raises(tmp_path, branch):
    reads = [str(tmp_path / "r.fq")]
    with open(reads[0], "w") as f:
        f.write("@r/1\n" + "ACGT" * 25 + "\n+\n" + "I" * 100 + "\n")
    p = params(tpe, tmp_path / "out", reads, **UNPORTED[branch])
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        tpe.run(p)
    assert not os.path.exists(tmp_path / "out")


def test_colour_space_input_raises(tmp_path):
    """Colour-space reads (an anchor base, then colours) are detected as
    the JAX package detects them, and refused."""
    reads = [str(tmp_path / "cs.fa")]
    with open(reads[0], "w") as f:
        f.write(">r1\nT0123012301230123012301\n")
    p = tpe.PipelineParams(name="c", k=15, in_files=reads,
                           outdir=str(tmp_path / "out"), device="cpu")
    with pytest.raises(NotImplementedError, match="colour-space"):
        tpe.run(p)
    assert p.cs is True


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reads = [str(tmp_path / "r.fq")]
    with open(reads[0], "w") as f:
        f.write("@r/1\n" + "ACGT" * 25 + "\n+\n" + "I" * 100 + "\n")
    p = tpe.PipelineParams(name="d", k=31, in_files=reads,
                           outdir=str(tmp_path / "out"))
    assert p.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.run(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpe.main(["k=31", f"in={reads[0]}", f"outdir={tmp_path}/cli"])
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("case", ["exact", "revcomp", "substitutions",
                                  "insertion", "deletion", "misjoin",
                                  "dense"])
def test_smoke_scaffold_placement_check(case):
    """chip_smoke.py holds the 4.6 Mbp scaffolds to an ungapped placement
    on the genome: substitutions pass (PathConsensus's tied columns), an
    insertion, a deletion, a misjoin or a dense run of differences
    fails."""
    import chip_smoke
    rng = np.random.default_rng(5)
    genome = alphabet.decode(rng.integers(0, 4, 60000).astype(np.uint8))
    rc = alphabet.revcomp(genome)
    strands = ((genome, alphabet.encode(genome)), (rc, alphabet.encode(rc)))
    b = genome[10000:30000]

    def sub(s, i):
        return s[:i] + "ACGT"[("ACGT".index(s[i]) + 1) % 4] + s[i + 1:]

    block = {"exact": b, "revcomp": alphabet.revcomp(b),
             "substitutions": sub(sub(sub(b, 500), 529), 15000),
             "insertion": b[:12000] + "A" + b[12000:],
             "deletion": b[:12000] + b[12001:],
             "misjoin": b[:-40] + genome[45000:45040],
             "dense": b[:9000] + "".join(
                 "ACGT"[("ACGT".index(c) + 1) % 4] if i % 8 == 0 else c
                 for i, c in enumerate(b[9000:9100])) + b[9100:]}[case]
    got = chip_smoke.ungapped_mismatches(block, strands)
    want = {"exact": [], "revcomp": [], "substitutions": [500, 529, 15000]}
    assert got == want.get(case)
