"""The port's read batches (its own native FASTQ build, and the Python
reader) against abyss_tpu's, on the same files."""

import gzip

import numpy as np
import pytest
import torch

from abyss_tpu import io as jio
from abyss_tpu import sim
from abyss_tpu_torch import io as tio
from abyss_tpu_torch.io import fastx as tfastx
from abyss_tpu_torch.io import native_fastx as tnative
from abyss_tpu_torch.native import BUILD_DIR

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)


def write_fastq(path, seed, gz=False):
    """Reads of varied length, lowercase bases, N runs and low-quality
    tails; one read longer than max_len."""
    rng = np.random.default_rng(seed)
    genome = sim.random_genome(4000, seed=seed)
    pr = sim.simulate_paired_reads(genome, coverage=8, read_len=90,
                                   seed=seed + 1)
    op = gzip.open if gz else open
    with op(path, "wt") as f:
        for i, (rid, seq, qual) in enumerate(pr.reads1):
            n = int(rng.integers(20, len(seq) + 1))
            seq, qual = seq[:n], qual[:n]
            if i % 7 == 0:
                seq = seq[:5] + "NNN" + seq[8:]
            if i % 5 == 0:
                seq = seq.lower()
            if i % 3 == 0:
                qual = qual[:-6] + "!!!!!!"
            f.write(f"@{rid} c{i}\n{seq}\n+\n{qual}\n")
        f.write("@long\n" + "ACGT" * 60 + "\n+\n" + "I" * 240 + "\n")


def same(a, b):
    assert a.ids == b.ids
    np.testing.assert_array_equal(a.lengths, b.lengths)
    np.testing.assert_array_equal(a.codes, b.codes)


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("q", [0, 3])
def test_read_batches_match_abyss_tpu(tmp_path, gz, q):
    path = str(tmp_path / ("r.fq" + (".gz" if gz else "")))
    write_fastq(path, seed=11, gz=gz)
    j = list(jio.read_batches(path, 64, 128, q=q))
    t = list(tio.read_batches(path, 64, 128, q=q))
    p = list(tfastx.read_batches(path, 64, 128, q))
    assert len(j) == len(t) == len(p) > 2
    for a, b, c in zip(j, t, p):
        same(a, b)
        same(a, c)


def test_native_reader_builds_into_the_port(tmp_path):
    """The port's reader is its own build, in its own build directory."""
    assert tnative.available()
    lib = tnative._lib()
    assert lib is not None and lib._name.startswith(BUILD_DIR)
