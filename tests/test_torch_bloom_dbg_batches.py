"""Stage 1 end to end over several batches and seed rounds, on the CPU:
the port's bloom-dbg writes byte-identical FASTA (headers included) and
counters to abyss_tpu's on a genome with repeats and read errors, and
resumes from a checkpoint that abyss_tpu wrote mid-run.  Both tests share
one set of reads and parameters, so the JAX reference compiles once for
the module."""

import io
import os
import shutil

import numpy as np
import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.dbg import bloom_dbg as jbd
from abyss_tpu.dbg import checkpoint as jckpt
from abyss_tpu.dbg.params import AssemblyParams as JParams
from abyss_tpu.io import read_batches as j_read_batches
from abyss_tpu_torch import u64
from abyss_tpu_torch.dbg import bloom_dbg as tbd
from abyss_tpu_torch.dbg import checkpoint as tckpt
from abyss_tpu_torch.dbg.params import AssemblyParams as TParams

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

# a small batch size and few seeds per round force several batches and
# several seed rounds in each
KW = dict(k=25, bloom_bytes=1 << 22, batch_size=256, max_read_len=128,
          seeds_per_round=16)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Repeats break unitigs, errors make tips and bubbles."""
    genome = sim.genome_with_repeats(3000, seed=7, n_repeats=2,
                                     repeat_len=300)
    d = tmp_path_factory.mktemp("reads")
    paths = [str(d / "g1.fq"), str(d / "g2.fq")]
    sim.simulate_paired_reads(genome, coverage=30, read_len=100,
                              error_rate=0.01, seed=3).write_fastq(*paths)
    return paths


def test_repeats_and_errors_several_batches(reads):
    jout, tout = io.StringIO(), io.StringIO()
    jc = jbd.assemble(reads, JParams(**KW), out=jout)
    tc = tbd.assemble(reads, TParams(**KW), out=tout, device="cpu")
    assert jout.getvalue().count(">") >= 5 and jc.read_count > 2 * 256
    assert tout.getvalue() == jout.getvalue()
    assert tbd.dataclasses_dict(tc) == jbd.dataclasses_dict(jc)


def test_resume_from_jax_checkpoint(reads, tmp_path):
    """abyss_tpu assembles the first batch and checkpoints; the port
    resumes from that directory (checkpoint.load -> convert) and writes
    the same remaining FASTA as abyss_tpu resuming from a copy."""
    jp = JParams(**KW)
    counters = jbd.AssemblyCounters()
    cbf = jbd.load_filter(
        j_read_batches(reads, jp.batch_size, jp.max_read_len), jp, counters)
    counters.read_count = 0
    asm = jbd.Assembler(cbf, jp, counters)
    first = next(iter(j_read_batches(reads, jp.batch_size, jp.max_read_len)))
    asm.process_batch(first)
    ck_j, ck_t = str(tmp_path / "ck_j"), str(tmp_path / "ck_t")
    jckpt.save(ck_j, asm.cbf, asm.visited, first.num_reads,
               jbd.dataclasses_dict(counters))
    shutil.copytree(ck_j, ck_t)

    # the port reads the JAX-written state exactly
    tcbf, tvis, n_reads, cstate = tckpt.load(ck_t, device="cpu")
    assert n_reads == first.num_reads
    np.testing.assert_array_equal(u64.to_numpy(tcbf.kmers),
                                  np.asarray(asm.cbf.kmers))
    np.testing.assert_array_equal(tvis.bits.numpy(),
                                  np.asarray(asm.visited.bits))
    np.testing.assert_array_equal(tcbf.counts.numpy(),
                                  np.asarray(asm.cbf.counts))
    assert (tcbf.k, tcbf.threshold) == (asm.cbf.k, asm.cbf.threshold)

    jout, tout = io.StringIO(), io.StringIO()
    jc = jbd.assemble(reads, JParams(checkpoint_dir=ck_j,
                                     checkpoint_every=10 ** 9, **KW),
                      out=jout)
    tc = tbd.assemble(reads, TParams(checkpoint_dir=ck_t,
                                     checkpoint_every=10 ** 9, **KW),
                      out=tout, device="cpu")
    assert jout.getvalue().count(">") >= 1
    assert tout.getvalue() == jout.getvalue()
    assert tbd.dataclasses_dict(tc) == jbd.dataclasses_dict(jc)
    assert not os.path.exists(ck_t)       # removed after the run
