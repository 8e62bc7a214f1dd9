"""Stage 1 with the counting Bloom filter (filter_mode="bloom") end to
end, on the CPU: the port's bloom-dbg writes byte-identical FASTA
(headers included), counters and pass-1 counting filter to abyss_tpu's,
on the reads and parameters of test_torch_bloom_dbg.py's header fixture
and of test_torch_bloom_dbg_batches.py (several batches and seed
rounds); it resumes from a counting-filter checkpoint that abyss_tpu
wrote, and its own checkpoints reload to the same state.  The
abyss-bloom `build -t counting` filter equals bloom-dbg's pass-1
filter at twice the budget, in both packages (chip_smoke.py holds the
port's two to the same equality at full size)."""

import io
import os
import shutil

import numpy as np
import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.cli import bloom_tool as jtool
from abyss_tpu.dbg import bloom_dbg as jbd
from abyss_tpu.dbg import checkpoint as jckpt
from abyss_tpu.dbg.params import AssemblyParams as JParams
from abyss_tpu.io import read_batches as j_read_batches
from abyss_tpu.ops import bloom as jbloom
from abyss_tpu_torch.cli import bloom_tool as ttool
from abyss_tpu_torch.dbg import bloom_dbg as tbd
from abyss_tpu_torch.dbg import checkpoint as tckpt
from abyss_tpu_torch.dbg.params import AssemblyParams as TParams
from abyss_tpu_torch.io import read_batches as t_read_batches
from abyss_tpu_torch.ops import bloom as tbloom

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

# test_torch_bloom_dbg.py::test_header_format_fixture
HEADER_KW = dict(k=25, bloom_bytes=16 << 20, batch_size=1024,
                 max_read_len=128, filter_mode="bloom")
# test_torch_bloom_dbg_batches.py: several batches and seed rounds
BATCHES_KW = dict(k=25, bloom_bytes=1 << 22, batch_size=256,
                  max_read_len=128, seeds_per_round=16, filter_mode="bloom")


@pytest.fixture(scope="module")
def header_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("header")
    paths = [str(d / "h1.fq"), str(d / "h2.fq")]
    sim.simulate_paired_reads(sim.random_genome(3000, seed=33), coverage=40,
                              read_len=100, seed=1).write_fastq(*paths)
    return paths


@pytest.fixture(scope="module")
def batch_reads(tmp_path_factory):
    genome = sim.genome_with_repeats(3000, seed=7, n_repeats=2,
                                     repeat_len=300)
    d = tmp_path_factory.mktemp("reads")
    paths = [str(d / "g1.fq"), str(d / "g2.fq")]
    sim.simulate_paired_reads(genome, coverage=30, read_len=100,
                              error_rate=0.01, seed=3).write_fastq(*paths)
    return paths


def pass1(reads, kw):
    """(JAX, port) pass-1 counting filters and their counters."""
    jp, tp = JParams(**kw), TParams(**kw)
    jc, tc = jbd.AssemblyCounters(), tbd.AssemblyCounters()
    jf = jbd.load_filter(j_read_batches(reads, jp.batch_size,
                                        jp.max_read_len), jp, jc)
    tf = tbd.load_filter(t_read_batches(reads, tp.batch_size,
                                        tp.max_read_len), tp, tc,
                         device="cpu")
    return jf, tf, jc, tc


@pytest.mark.parametrize("fixture,kw", [("header_reads", HEADER_KW),
                                        ("batch_reads", BATCHES_KW)],
                         ids=["header", "batches"])
def test_bloom_mode_fasta_identical(request, fixture, kw):
    reads = request.getfixturevalue(fixture)
    jout, tout = io.StringIO(), io.StringIO()
    jc = jbd.assemble(reads, JParams(**kw), out=jout)
    tc = tbd.assemble(reads, TParams(**kw), out=tout, device="cpu")
    assert jout.getvalue().count(">") >= 1
    assert tout.getvalue() == jout.getvalue()
    assert tbd.dataclasses_dict(tc) == jbd.dataclasses_dict(jc)


def test_pass1_counting_filter_identical(batch_reads):
    jf, tf, jc, tc = pass1(batch_reads, BATCHES_KW)
    assert isinstance(tf, tbloom.CountingBloomFilter)
    np.testing.assert_array_equal(tf.counters.numpy(),
                                  np.asarray(jf.counters))
    assert (tf.k, tf.num_hashes, tf.threshold) == \
        (jf.k, jf.num_hashes, jf.threshold)
    assert int(tf.counters.max()) >= 3
    assert tbd.dataclasses_dict(tc) == jbd.dataclasses_dict(jc)


def test_resume_from_jax_counting_checkpoint(batch_reads, tmp_path):
    """abyss_tpu assembles the first batch in Bloom mode and checkpoints;
    the port resumes from that directory and writes the same remaining
    FASTA as abyss_tpu resuming from a copy."""
    jp = JParams(**BATCHES_KW)
    counters = jbd.AssemblyCounters()
    cbf = jbd.load_filter(
        j_read_batches(batch_reads, jp.batch_size, jp.max_read_len), jp,
        counters)
    counters.read_count = 0
    asm = jbd.Assembler(cbf, jp, counters)
    first = next(iter(j_read_batches(batch_reads, jp.batch_size,
                                     jp.max_read_len)))
    asm.process_batch(first)
    ck_j, ck_t = str(tmp_path / "ck_j"), str(tmp_path / "ck_t")
    jckpt.save(ck_j, asm.cbf, asm.visited, first.num_reads,
               jbd.dataclasses_dict(counters))
    shutil.copytree(ck_j, ck_t)

    tcbf, tvis, n_reads, _ = tckpt.load(ck_t, device="cpu")
    assert isinstance(tcbf, tbloom.CountingBloomFilter)
    assert n_reads == first.num_reads
    np.testing.assert_array_equal(tcbf.counters.numpy(),
                                  np.asarray(asm.cbf.counters))
    np.testing.assert_array_equal(tvis.bits.numpy(),
                                  np.asarray(asm.visited.bits))
    assert (tcbf.k, tcbf.num_hashes, tcbf.threshold) == \
        (asm.cbf.k, asm.cbf.num_hashes, asm.cbf.threshold)

    jout, tout = io.StringIO(), io.StringIO()
    jc = jbd.assemble(batch_reads, JParams(checkpoint_dir=ck_j,
                                           checkpoint_every=10 ** 9,
                                           **BATCHES_KW), out=jout)
    tc = tbd.assemble(batch_reads, TParams(checkpoint_dir=ck_t,
                                           checkpoint_every=10 ** 9,
                                           **BATCHES_KW),
                      out=tout, device="cpu")
    assert jout.getvalue().count(">") >= 1
    assert tout.getvalue() == jout.getvalue()
    assert tbd.dataclasses_dict(tc) == jbd.dataclasses_dict(jc)
    assert not os.path.exists(ck_t)       # removed after the run


def test_port_counting_checkpoint_roundtrip(batch_reads, tmp_path):
    """A counting-filter checkpoint the port writes reloads to the same
    state in the port, and abyss_tpu reads the same arrays from it."""
    p = TParams(**BATCHES_KW)
    cbf = tbd.load_filter(t_read_batches(batch_reads, p.batch_size,
                                         p.max_read_len), p, device="cpu")
    asm = tbd.Assembler(cbf, p)
    asm._mark_assembled([np.zeros(60, np.uint8)])
    ck = str(tmp_path / "ck")
    tckpt.save(ck, cbf, asm.visited, 123, {"contig_id": 4})
    c2, v2, reads, counters = tckpt.load(ck, device="cpu")
    assert reads == 123 and counters == {"contig_id": 4}
    assert torch.equal(c2.counters, cbf.counters)
    assert torch.equal(v2.bits, asm.visited.bits)
    assert (c2.k, c2.num_hashes, c2.threshold) == \
        (cbf.k, cbf.num_hashes, cbf.threshold)
    jc, jv, _, _ = jckpt.load(ck)
    assert isinstance(jc, jbloom.CountingBloomFilter)
    np.testing.assert_array_equal(np.asarray(jc.counters),
                                  cbf.counters.numpy())
    np.testing.assert_array_equal(np.asarray(jv.bits),
                                  asm.visited.bits.numpy())


def test_bloom_build_counting_equals_pass1_filter(header_reads, tmp_path):
    """`bloom build -t counting -b X` writes bloom-dbg's pass-1 counters
    at bloom_bytes = 2X and the CLI's batch shape (both insert the same
    read batches into 2^n counters), in abyss_tpu and in the port
    alike."""
    kw = dict(HEADER_KW, batch_size=4096, max_read_len=512)
    jf, tf, _, _ = pass1(header_reads, kw)
    half = kw["bloom_bytes"] // 2
    assert jf.size == tf.size == half
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    args = ["build", "-t", "counting", "-k", str(kw["k"]), "-b", str(half)]
    jtool.main(args + [jpath] + header_reads)
    ttool.main(args + ["--device", "cpu", tpath] + header_reads)
    np.testing.assert_array_equal(
        np.asarray(jbloom.load_filter(jpath).counters),
        np.asarray(jf.counters))
    np.testing.assert_array_equal(
        tbloom.load_filter(tpath, "cpu").counters.numpy(),
        tf.counters.numpy())
