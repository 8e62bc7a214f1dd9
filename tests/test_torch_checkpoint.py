"""Checkpoints: the port's own checkpoints reload to the same state
(resuming from one that abyss_tpu wrote is in
test_torch_bloom_dbg_batches.py)."""

import numpy as np
import torch

from abyss_tpu import sim
from abyss_tpu_torch.dbg import bloom_dbg as tbd
from abyss_tpu_torch.dbg import checkpoint as tckpt
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


def test_port_checkpoint_roundtrip(tmp_path):
    """A checkpoint the port writes reloads to the same state."""
    genome = sim.random_genome(2000, seed=21)
    paths = write_reads(tmp_path, genome, "r", coverage=15, seed=22)
    p = TParams(k=25, bloom_bytes=1 << 22, batch_size=512, max_read_len=128)
    from abyss_tpu_torch.io import read_batches
    cbf = tbd.load_filter(read_batches(paths, 512, 128), p, device="cpu")
    asm = tbd.Assembler(cbf, p)
    asm._mark_assembled([np.zeros(60, np.uint8)])
    ck = str(tmp_path / "ck")
    tckpt.save(ck, cbf, asm.visited, 123, {"contig_id": 4})
    assert tckpt.exists(ck)
    c2, v2, reads, counters = tckpt.load(ck, device="cpu")
    assert reads == 123 and counters == {"contig_id": 4}
    assert (c2.kmers == cbf.kmers).all() and (c2.counts == cbf.counts).all()
    assert (v2.bits == asm.visited.bits).all()
