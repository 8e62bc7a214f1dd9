"""The port's `bloom` tool (abyss-bloom, cli/bloom_tool.py) against
abyss_tpu's, on the CPU: the cases of tests/test_formats_tools.py's
abyss-bloom section and the other subcommands, each run through both
packages on the same reads.  Filters must hold the same arrays (the
.npz zip headers carry timestamps, so the files are compared array by
array), and stdout and stderr must be identical."""

import os

import numpy as np
import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.cli import bloom_tool as jtool
from abyss_tpu_torch.cli import bloom_tool as ttool

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def readset(tmp_path_factory):
    """tests/test_formats_tools.py's readset."""
    d = tmp_path_factory.mktemp("bloomtool")
    genome = sim.random_genome(3000, seed=7)
    reads = sim.simulate_paired_reads(genome, coverage=20.0, seed=7)
    p1, p2 = str(d / "r1.fq"), str(d / "r2.fq")
    reads.write_fastq(p1, p2)
    return d, p1, p2


def run(capsys, args, d, outputs=()):
    """Run `bloom args` in abyss_tpu and in the port, each writing its
    own copies of `outputs` (names in d; "{}" in args is replaced by the
    package tag); returns the two (stdout, stderr) pairs."""
    got = []
    for tag, tool, extra in (("j", jtool, []), ("t", ttool,
                                                ["--device", "cpu"])):
        argv = [a.replace("{}", tag) for a in args]
        argv = argv[:1] + extra + argv[1:]
        capsys.readouterr()
        assert tool.main(argv) == 0
        got.append(capsys.readouterr())
    for name in outputs:
        same_npz(str(d / name.replace("{}", "j")),
                 str(d / name.replace("{}", "t")))
    return got


def same_npz(a: str, b: str):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(za[key], zb[key])


def test_bloom_build_union_window_parity(readset, capsys):
    """Windowed shard builds OR-merged == the single build, in both
    packages, with the same arrays; info prints the same lines."""
    d, p1, p2 = readset
    single = str(d / "single_{}.npz")
    run(capsys, ["build", "-k", "21", "-b", "1M", single, p1, p2], d,
        ["single_{}.npz"])
    shards = []
    for i in (1, 2, 3):
        sp = str(d / f"w{i}_{{}}.npz")
        run(capsys, ["build", "-k", "21", "-b", "1M", "-w", f"{i}/3", sp, p1,
                     p2], d, [f"w{i}_{{}}.npz"])
        shards.append(sp)
    run(capsys, ["union", str(d / "merged_{}.npz")] + shards, d,
        ["merged_{}.npz"])
    same_npz(str(d / "single_t.npz"), str(d / "merged_t.npz"))
    j, t = run(capsys, ["info", single], d)
    assert "occupancy" in t.out
    assert t == j


def test_bloom_compare_and_kmers(readset, capsys):
    d, p1, p2 = readset
    f1 = str(d / "c1_{}.npz")
    run(capsys, ["build", "-k", "21", "-b", "1M", f1, p1], d, ["c1_{}.npz"])
    run(capsys, ["build", "-k", "21", "-b", "1M", str(d / "c2_{}.npz"), p2],
        d, ["c2_{}.npz"])
    j, t = run(capsys, ["compare", "-m", "jaccard", f1, f1], d)
    assert "jaccard: 1.0" in t.out and t == j
    for method in ("jaccard", "czekanowski", "raw"):
        j, t = run(capsys, ["compare", "-m", method, f1,
                            str(d / "c2_{}.npz")], d)
        assert t == j
    j, t = run(capsys, ["kmers", "--count-only", f1, p1], d)
    assert "k-mers present" in t.err and t == j
    j, t = run(capsys, ["kmers", f1, p2], d)
    assert t.out.count("\n") > 100 and t == j


def test_bloom_trim(readset, capsys):
    d, p1, _ = readset
    f1 = str(d / "t1_{}.npz")
    run(capsys, ["build", "-k", "21", "-b", "1M", "-t", "counting", f1, p1],
        d, ["t1_{}.npz"])
    j, t = run(capsys, ["trim", f1, p1], d)
    assert t.out.startswith("@")  # fastq records survive
    assert t == j


def test_bloom_counting_cascading_intersect_graph(readset, capsys):
    """Counting (whole and windowed) and cascading builds, union and
    intersect of counting filters, info on each kind, and the graph
    dump, in both packages."""
    d, p1, p2 = readset
    run(capsys, ["build", "-k", "21", "-b", "256K", "-t", "counting",
                 str(d / "ca_{}.npz"), p1, p2], d, ["ca_{}.npz"])
    run(capsys, ["build", "-k", "21", "-b", "256K", "-t", "counting", "-w",
                 "2/3", str(d / "cw_{}.npz"), p1], d, ["cw_{}.npz"])
    run(capsys, ["build", "-k", "21", "-b", "256K", "-l", "3",
                 str(d / "cl_{}.npz"), p1, p2], d, ["cl_{}.npz"])
    run(capsys, ["build", "-k", "21", "-b", "256K", "-t", "cascading", "-w",
                 "1/2", str(d / "cc_{}.npz"), p1], d, ["cc_{}.npz"])
    run(capsys, ["union", str(d / "cu_{}.npz"), str(d / "ca_{}.npz"),
                 str(d / "cw_{}.npz")], d, ["cu_{}.npz"])
    run(capsys, ["intersect", str(d / "ci_{}.npz"), str(d / "ca_{}.npz"),
                 str(d / "cw_{}.npz")], d, ["ci_{}.npz"])
    for name in ("ca", "cu", "cl", "cc"):
        j, t = run(capsys, ["info", str(d / f"{name}_{{}}.npz")], d)
        assert t == j
    query = str(d / "q.fa")
    with open(p1) as f:
        lines = f.read().splitlines()
    with open(query, "w") as f:
        for i in range(0, 40, 4):
            f.write(f">{lines[i][1:]}\n{lines[i + 1]}\n")
    j, t = run(capsys, ["graph", str(d / "ca_{}.npz"), query], d)
    assert t.out.startswith("digraph") and t == j
    assert os.path.getsize(str(d / "ca_t.npz")) > 0
