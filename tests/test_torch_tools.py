"""The port's tool suite against abyss_tpu's, on the CPU.

`python -m abyss_tpu_torch <tool>` offers the same 56 tools as
`python -m abyss_tpu <tool>`.  Each tool new to the port in this slice
runs through both dispatchers (`--device cpu` for the port where the
tool takes a device) on the same inputs, in a directory of its own, and
its standard output, its standard error and every file of the directory
must be byte-identical.  The tools the port had before (pe, bloom-dbg,
assemble, bloom, paired-dbg, konnector, sealer) are held by
tests/test_torch_pe.py, test_torch_bloom_dbg.py,
test_torch_assemble_tool.py, test_torch_bloom_tool.py,
test_torch_paired_dbg.py, test_torch_konnector_cli.py and
test_torch_sealer.py.  `index` raises the reference's AttributeError in
both packages and writes no file.  The dispatcher's universal --db
records the same keys.
"""

import contextlib
import faulthandler
import importlib
import io
import os
import shutil
import sqlite3
import sys
import tempfile

import numpy as np
import pytest
import torch

from abyss_tpu_torch import sim
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.graph import adjlist, graphio
from abyss_tpu_torch.graph.contig_graph import ContigGraph

torch.set_num_threads(1)

K = 25
# the tools that take --device in the port
DEVICE_TOOLS = {"map", "index", "count", "distanceest", "pathconsensus",
                "rresolver", "consensus", "gapfill", "kmerprint",
                "logcounter", "samtobreak", "tigmint", "arcs", "bwa",
                "bwamem", "bowtie2", "kaligner", "dida", "paired-dbg"}
# held byte for byte by their own test files (module docstring)
EARLIER_TOOLS = {"pe", "bloom-dbg", "assemble", "bloom", "paired-dbg",
                 "konnector", "sealer"}


def _fa(path, recs):
    with open(path, "w") as f:
        for name, seq in recs:
            f.write(f">{name}\n{seq}\n")


def _fq(path, recs):
    with open(path, "w") as f:
        for name, seq in recs:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


def _sam_line(q, rname, pos1, cigar, seq):
    return f"{q}\t0\t{rname}\t{pos1}\t60\t{cigar}\t*\t0\t0\t{seq}\t*\n"


def _write_inputs(d):
    """Every input file of the cases, from seeded generators."""
    from abyss_tpu_torch.align.distance_est import DistanceEstimate
    from abyss_tpu_torch.io import formats
    from abyss_tpu_torch.utils import db as dbmod
    G = sim.random_genome(3000, seed=21)
    _fa(d / "genome.fa", [("ref", G)])
    with open(d / "contigs.fa", "w") as f:
        for n, s in (("0", G[:1600]), ("1", G[1500:])):
            f.write(f">{n} {len(s)} 99\n{s}\n")
    reads = sim.simulate_paired_reads(G, coverage=10.0, read_len=100,
                                      seed=22)
    reads.write_fastq(str(d / "r1.fq"), str(d / "r2.fq"))
    with open(d / "r1.fq") as src, open(d / "small.fq", "w") as dst:
        dst.writelines(src.readlines()[:4 * 60])

    # a chain of contigs with exact k-1 overlaps and a bubble: 0+ ->
    # {1+, 4+} -> 2+ -> 3+, contig 4 a low-coverage copy of contig 1 with
    # one substitution
    cuts = [(0, 800), (776, 1500), (1476, 2200), (2176, 3000)]
    chain = [G[a:b] for a, b in cuts]
    mid = len(chain[1]) // 2
    alt = chain[1][:mid] + ("A" if chain[1][mid] != "A" else "C") + \
        chain[1][mid + 1:]
    covs = [5000, 4000, 4500, 5200, 60]
    seqs = chain + [alt]
    with open(d / "bub.fa", "w") as f:
        for i, (s, c) in enumerate(zip(seqs, covs)):
            f.write(f">{i} {len(s)} {c}\n{s}\n")
    g = adjlist.build_overlap_graph([(str(i), s) for i, s in enumerate(seqs)],
                                    K, covs)
    graphio.write_dot(g, str(d / "bub.dot"), k=K)
    with open(d / "bub.adj", "w") as f:
        graphio.write_adj(g, f)
    with open(d / "seeds.path", "w") as f:
        f.write("0\t0+ 1+ 2+\n1\t1+ 2+ 3+\n2\t2+ 3+\n")
    with open(d / "merge.path", "w") as f:
        f.write("7\t0+ 1+ 2+ 3+\n")
    with open(d / "amb.path", "w") as f:
        f.write("8\t0+ 700N 2+ 3+\n")
    (d / "bub.dist.dot").write_text(
        'digraph dist {\n'
        '"0+" -> "2+" [d=700 e=5.0 n=20]\n'
        '"2-" -> "0-" [d=700 e=5.0 n=20]\n'
        '"2+" -> "3+" [d=-24 e=1.0 n=30]\n'
        '"3-" -> "2-" [d=-24 e=1.0 n=30]\n}\n')
    (d / "d.dist.dot").write_text(
        'digraph dist {\n'
        '"0+" [l=500 C=50]\n"0-" [l=500 C=50]\n'
        '"1+" [l=400 C=40]\n"1-" [l=400 C=40]\n'
        '"0+" -> "1+" [d=100 e=2.0 n=20]\n'
        '"1-" -> "0-" [d=100 e=2.0 n=20]\n}\n')

    # blunt contigs that overlap by 30 bp, with a negative estimate
    o = sim.random_genome(1000, seed=94)
    _fa(d / "ov.fa", [("0", o[:520]), ("1", o[490:])])
    og = ContigGraph()
    og.add_contig("0", 520)
    og.add_contig("1", 510)
    graphio.write_dot(og, str(d / "ov.dot"), k=K)
    with open(d / "ov.dist", "w") as f:
        formats.write_dist_text({("0", 0, "1", 0):
                                 DistanceEstimate(-28, 20, 3.0)}, f)
    with open(d / "b.dist", "w") as f:
        formats.write_dist_text({("0", 0, "1", 0):
                                 DistanceEstimate(-10, 25, 2.0)}, f)

    # a long read across contigs 0 and 2 of the chain
    (d / "long.sam").write_text(
        "@SQ\tSN:0\tLN:800\n@SQ\tSN:2\tLN:724\n"
        + _sam_line("L1", "0", 601, "200M300S", G[600:800] + "A" * 300)
        + _sam_line("L1", "2", 1, "250S250M", "A" * 250 + G[1476:1726])
        + _sam_line("L2", "0", 651, "150M350S", G[650:800] + "A" * 350)
        + _sam_line("L2", "2", 1, "200S300M", "A" * 200 + G[1476:1776]))

    frag = sim.random_genome(600, seed=5)
    _fa(d / "frag.fa", [("a", frag[:350]), ("b", frag[300:])])
    _fa(d / "x.fa", [("x", "ACGTACGTACGTACGTACGT")])
    _fa(d / "p.fa", [("a", "ACGTACGT"), ("b", "ACGACGT"),
                     ("c", G[:60]), ("d", G[:30] + G[33:63])])
    m = sim.random_genome(300, seed=11)[50:250]
    _fq(d / "m1.fq", [("p/1", m[:120])])
    _fq(d / "m2.fq", [("p/2", alphabet.revcomp(m[-120:]))])
    _fa(d / "seed.fa", [("s", G[1400:1500])])
    _fa(d / "scaf.fa", [("s0", G[:1200] + "N" * 30 + G[1230:2800])])
    (d / "s.fa").write_text(">s1\n" + "ACGT" * 30 + "N" * 12 + "GGCC" * 30
                            + "\n")
    (d / "c.fa").write_text(">r1\n" + alphabet.nucleotide_to_colour(
        "ACGTTGCA") + "\n")
    (d / "t.tab").write_text("n\tN50\tsum\n3\t1000\t4500\n12\t80\t960\n")

    # linked reads: molecules of the genome, reads tagged BX:Z:
    rng = np.random.default_rng(8)
    with open(d / "lr.fq", "w") as f:
        for mol in range(60):
            start = int(rng.integers(0, len(G) - 1200))
            for r in range(12):
                p = start + int(rng.integers(0, 1200 - 60))
                s = G[p:p + 60]
                f.write(f"@m{mol}r{r} BX:Z:BC{mol:04d}\n{s}\n+\n"
                        f"{'I' * 60}\n")

    with dbmod.DB(str(d / "t.sqlite"), tool="unittest", command="c") as db:
        db.add("reads", 100)
        db.add("kmers", 5000)

    # SAM of the read pairs against the contigs: the port's mapper on the
    # CPU writes it (the map case holds it to abyss_tpu's)
    from abyss_tpu_torch.cli import tools2
    with open(d / "a.sam", "w") as f, contextlib.redirect_stdout(f):
        tools2.map_main([str(d / "r1.fq"), str(d / "r2.fq"),
                         str(d / "contigs.fa"), "--device", "cpu"])


# (case id, tool, arguments); inputs are the names _write_inputs makes
CASES = [
    ("adjlist", "adjlist", ["bub.fa", "-k", "25"]),
    ("fac", "fac", ["contigs.fa", "bub.fa"]),
    ("tofastq", "tofastq", ["small.fq"]),
    ("todot", "todot", ["bub.adj", "-k", "25"]),
    ("gc", "gc", ["bub.dot", "bub.adj"]),
    ("db-txt", "db-txt", ["t.sqlite"]),
    ("db-csv", "db-csv", ["t.sqlite"]),
    ("map", "map", ["r1.fq", "r2.fq", "contigs.fa", "-l", "32"]),
    ("count", "count", ["-k", "5", "x.fa"]),
    ("dawg", "dawg", ["x.fa"]),
    ("overlap", "overlap", ["frag.fa", "-m", "20"]),
    ("layout", "layout", ["frag.fa", "-m", "20", "-o", "laid.fa"]),
    ("fixmate", "fixmate", ["-h", "f.hist", "a.sam"]),
    ("distanceest", "distanceest",
     ["r1.fq", "r2.fq", "--target", "contigs.fa", "--dot", "-n", "1",
      "-o", "out.dist.dot", "--hist", "h.hist", "-k", "25"]),
    ("filtergraph", "filtergraph", ["bub.dot", "-k", "25", "-o", "f.dot"]),
    ("popbubbles", "popbubbles", ["bub.fa", "bub.dot", "-k", "25",
                                  "-g", "popped.dot"]),
    ("overlap-contigs", "overlap-contigs",
     ["ov.fa", "ov.dot", "ov.dist", "-k", "25"]),
    ("simplegraph", "simplegraph", ["bub.dot", "bub.dist.dot", "-k", "25"]),
    ("mergepaths", "mergepaths", ["bub.dot", "seeds.path", "-k", "25"]),
    ("pathoverlap", "pathoverlap", ["bub.dot", "seeds.path", "-k", "25"]),
    ("pathconsensus", "pathconsensus",
     ["bub.fa", "bub.dot", "amb.path", "-k", "25", "-o", "out.path",
      "-s", "cons.fa", "-g", "pc.dot"]),
    ("mergecontigs", "mergecontigs", ["bub.fa", "bub.dot", "merge.path",
                                      "-o", "merged.fa"]),
    ("scaffold", "scaffold", ["d.dist.dot", "-n", "1-5", "-s", "100",
                              "-g", "sc.dot"]),
    ("junction", "junction", ["bub.dot"]),
    ("longseqdist", "longseqdist", ["long.sam", "-k", "25"]),
    ("rresolver", "rresolver", ["bub.fa", "bub.dot", "r1.fq", "r2.fq",
                                "-k", "25"]),
    ("consensus", "consensus", ["contigs.fa", "r1.fq", "r2.fq"]),
    ("dassembler", "dassembler", ["seed.fa", "small.fq", "-m", "30"]),
    ("gapfill", "gapfill", ["scaf.fa", "r1.fq", "r2.fq", "-k", "25",
                            "-b", "1M", "-o", "sealed.fa"]),
    ("mergepairs", "mergepairs", ["m1.fq", "m2.fq", "-o", "mg"]),
    ("align", "align", ["p.fa"]),
    ("kmerprint", "kmerprint", ["small.fq", "-k", "11"]),
    ("logcounter", "logcounter", ["r1.fq", "-k", "15", "-b", "1000"]),
    ("samtobreak", "samtobreak", ["genome.fa", "contigs.fa"]),
    ("fatoagp", "fatoagp", ["s.fa", "-f", "scaftigs.fa"]),
    ("samtoafg", "samtoafg", ["a.sam", "-m", "300", "-s", "30"]),
    ("cstont", "cstont", ["c.fa"]),
    ("joindist", "joindist", ["ov.dist", "b.dist"]),
    ("adjtodot", "adjtodot", ["bub.adj", "-k", "25"]),
    ("tabtomd", "tabtomd", ["t.tab"]),
    ("tigmint", "tigmint", ["contigs.fa", "lr.fq", "-o", "cut.fa", "--bed",
                            "mol.bed", "-d", "2000"]),
    ("arcs", "arcs", ["contigs.fa", "lr.fq", "-e", "1200", "-n", "2", "-s",
                      "400", "-o", "links.dot"]),
    ("stack-size", "stack-size", ["65536000", "fac", "contigs.fa"]),
    ("bwa", "bwa", ["contigs.fa", "r1.fq"]),
    ("bwamem", "bwamem", ["contigs.fa", "r1.fq"]),
    ("bowtie2", "bowtie2", ["contigs.fa", "r2.fq"]),
    ("kaligner", "kaligner", ["contigs.fa", "small.fq"]),
    ("dida", "dida", ["contigs.fa", "small.fq"]),
]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tool_inputs")
    _write_inputs(d)
    return d


def _tree(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@contextlib.contextmanager
def _captured():
    """stdout to a StringIO and stderr to a temporary file.  Both
    dispatchers point faulthandler at sys.stderr, which must have a file
    descriptor (ROADMAP C); faulthandler goes back to the process's
    standard error before the file closes."""
    out = io.StringIO()
    with tempfile.TemporaryFile("w+") as err:
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                yield out, err
        finally:
            faulthandler.enable(file=sys.__stderr__, all_threads=True)


def _text(f) -> str:
    f.flush()
    f.seek(0)
    return f.read()


def _dispatch(pkg, argv, workdir, monkeypatch):
    """Run `python -m <pkg> <argv>` in-process from workdir: (exit code
    or the exception raised, stdout, stderr)."""
    mod = importlib.import_module(pkg + ".__main__")
    monkeypatch.setattr(sys, "argv", [pkg] + list(argv))
    monkeypatch.chdir(workdir)
    with _captured() as (out, err):
        try:
            result = mod.main()
        except Exception as e:  # the same exception from both packages
            result = e
        return result, out.getvalue(), _text(err)


def _run_both(inputs, tmp_path, monkeypatch, tool, args):
    runs = {}
    for pkg in ("abyss_tpu", "abyss_tpu_torch"):
        work = tmp_path / pkg
        shutil.copytree(inputs, work)
        argv = [tool] + args
        if pkg == "abyss_tpu_torch" and tool in DEVICE_TOOLS:
            argv += ["--device", "cpu"]
        result, out, err = _dispatch(pkg, argv, work, monkeypatch)
        runs[pkg] = dict(result=result, out=out, err=err, tree=_tree(work))
    return runs["abyss_tpu"], runs["abyss_tpu_torch"]


@pytest.mark.parametrize("tool,args", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_tool_matches_jax(inputs, tmp_path, monkeypatch, tool, args):
    jax_run, port_run = _run_both(inputs, tmp_path, monkeypatch, tool, args)
    assert not isinstance(jax_run["result"], Exception), jax_run["result"]
    assert port_run["result"] == jax_run["result"]
    assert port_run["out"] == jax_run["out"]
    assert port_run["err"] == jax_run["err"]
    assert sorted(port_run["tree"]) == sorted(jax_run["tree"])
    for name, data in jax_run["tree"].items():
        assert port_run["tree"][name] == data, name
    written = set(jax_run["tree"]) - set(_tree(inputs))
    # every case makes some output
    assert jax_run["out"] or jax_run["err"] or written, tool


def test_index_raises_the_reference_error(inputs, tmp_path, monkeypatch):
    """abyss_tpu's index saves `fm.occ` and `fm.sa_sample`, which FMIndex
    lacks: both packages raise AttributeError before writing a file."""
    jax_run, port_run = _run_both(inputs, tmp_path, monkeypatch, "index",
                                  ["contigs.fa"])
    for run in (jax_run, port_run):
        assert isinstance(run["result"], AttributeError)
        assert "sa_sample" in str(run["result"])
        assert run["tree"] == _tree(inputs)
        assert run["out"] == ""


def test_every_tool_is_dispatched_or_held_elsewhere():
    from abyss_tpu import __main__ as jmain
    from abyss_tpu_torch import __main__ as tmain
    assert list(tmain.TOOLS) == list(jmain.TOOLS)
    assert len(tmain.TOOLS) == 56
    cased = {c[1] for c in CASES} | {"index"}
    assert cased | EARLIER_TOOLS == set(tmain.TOOLS)
    for name, (desc, module, fn) in tmain.TOOLS.items():
        assert module.startswith("abyss_tpu_torch."), name
        assert callable(getattr(importlib.import_module(module), fn)), name
        assert desc == jmain.TOOLS[name][0], name


def test_help_lists_the_same_tools(monkeypatch):
    outs = {}
    for pkg in ("abyss_tpu", "abyss_tpu_torch"):
        mod = importlib.import_module(pkg + ".__main__")
        monkeypatch.setattr(sys, "argv", [pkg, "--help"])
        with _captured() as (out, _):
            assert mod.main() == 0
        outs[pkg] = out.getvalue().splitlines()
    assert outs["abyss_tpu_torch"][0] == \
        "usage: python -m abyss_tpu_torch <tool> [args...]"
    assert outs["abyss_tpu_torch"][1:] == outs["abyss_tpu"][1:]
    names = [ln.split()[0] for ln in outs["abyss_tpu_torch"][3:]]
    assert len(names) == 56 and len(set(names)) == 56


def test_universal_db_records_the_same_keys(inputs, tmp_path, monkeypatch):
    """--db=FILE on a tool without its own --db: the dispatcher strips it
    and records the same keys, tool and command in both packages."""
    rows = {}
    for pkg in ("abyss_tpu", "abyss_tpu_torch"):
        work = tmp_path / pkg
        shutil.copytree(inputs, work)
        result, out, _ = _dispatch(pkg, ["fac", "contigs.fa",
                                         "--db=run.sqlite"], work,
                                   monkeypatch)
        assert result in (0, None) and "contigs.fa" in out
        conn = sqlite3.connect(str(work / "run.sqlite"))
        rows[pkg] = (conn.execute("SELECT tool, seq, key FROM stats ORDER "
                                  "BY seq").fetchall(),
                     conn.execute("SELECT command FROM runs").fetchall())
        conn.close()
    assert rows["abyss_tpu_torch"] == rows["abyss_tpu"]
    assert [r[2] for r in rows["abyss_tpu"][0]] == \
        ["wall_s", "peak_rss_bytes", "exit"]
