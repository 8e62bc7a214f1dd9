"""Stage 1 end to end: the port's bloom-dbg writes byte-identical FASTA
(headers included) to abyss_tpu's on the same reads and parameters, on
the CPU: here the quick fixtures of tests/test_bloom_dbg.py; a genome
with repeats and errors over several batches in
test_torch_bloom_dbg_batches.py; resuming from a checkpoint in
test_torch_checkpoint.py (separate files, so that the test workers run
them side by side)."""

import io

import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.dbg import bloom_dbg as jbd
from abyss_tpu.dbg.params import AssemblyParams as JParams
from abyss_tpu_torch.dbg import bloom_dbg as tbd
from abyss_tpu_torch.dbg.params import AssemblyParams as TParams

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)


def write_reads(tmp_path, genome, name, **kw):
    pr = sim.simulate_paired_reads(genome, **kw)
    p1, p2 = str(tmp_path / f"{name}1.fq"), str(tmp_path / f"{name}2.fq")
    pr.write_fastq(p1, p2)
    return [p1, p2]


def both(paths, **kw):
    """(JAX FASTA, port FASTA, JAX counters, port counters)."""
    jout, tout = io.StringIO(), io.StringIO()
    jc = jbd.assemble(paths, JParams(**kw), out=jout)
    tc = tbd.assemble(paths, TParams(**kw), out=tout, device="cpu")
    return jout.getvalue(), tout.getvalue(), jc, tc


def test_header_format_fixture(tmp_path):
    """tests/test_bloom_dbg.py::test_header_format's reads and params."""
    paths = write_reads(tmp_path, sim.random_genome(3000, seed=33), "h",
                        coverage=40, read_len=100, seed=1)
    j, t, jc, tc = both(paths, k=25, bloom_bytes=16 << 20, batch_size=1024,
                        max_read_len=128)
    assert j.count(">") >= 1
    assert t == j
    assert tbd.dataclasses_dict(tc) == jbd.dataclasses_dict(jc)


def test_read_log_fixture(tmp_path):
    """tests/test_bloom_dbg.py::test_read_log_trace: FASTA and the
    per-read outcome log are both byte-identical."""
    paths = write_reads(tmp_path, sim.random_genome(2000, seed=61), "t",
                        coverage=15, seed=62)
    kw = dict(k=25, min_cov=2, bloom_bytes=1 << 22, batch_size=512,
              max_read_len=128)
    jlog, tlog = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    jout, tout = io.StringIO(), io.StringIO()
    jbd.assemble(paths, JParams(read_log=jlog, **kw), out=jout)
    tbd.assemble(paths, TParams(read_log=tlog, **kw), out=tout,
                 device="cpu")
    assert tout.getvalue() == jout.getvalue()
    with open(jlog) as a, open(tlog) as b:
        assert b.read() == a.read()


def test_bloom_filter_mode_not_ported(tmp_path):
    paths = write_reads(tmp_path, sim.random_genome(500, seed=1), "b",
                        coverage=5, seed=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbd.assemble(paths, TParams(k=25, filter_mode="bloom"),
                     out=io.StringIO(), device="cpu")
