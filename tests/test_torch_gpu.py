"""The CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU with nvcc (they build the kernels from
csrc/); without one they skip.  Run them on the card with

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(`--noconftest`: tests/conftest.py imports jax, which the port's
machine need not have.)
"""

import numpy as np
import pytest
import torch

from abyss_tpu_torch import sim
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.dbg import extend as ext
from abyss_tpu_torch.ops import kernels
from abyss_tpu_torch.ops import nthash
from abyss_tpu_torch.ops import sorted_filter as tsf

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 5, 25, 31, 96])
def test_nthash_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(64, 700), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[1, 300:] = 4
    codes[2, 50] = 9
    t = torch.from_numpy(codes).to(cuda)
    launched = kernels.launches["nthash"]
    fwd, rev, canon, valid = nthash.kmer_hashes(t, k)
    assert kernels.launches["nthash"] == launched + 1
    pf, pr, pc, pv = nthash.kmer_hashes_plain(t, k)
    for a, b in ((fwd, pf), (rev, pr), (canon, pc), (valid, pv)):
        assert torch.equal(a, b)


def test_nthash_kernel_refuses_bad_input(cuda):
    with pytest.raises(TypeError):
        kernels.nthash(torch.zeros((2, 40), dtype=torch.int32, device=cuda),
                       5)
    with pytest.raises(ValueError):
        kernels.nthash(torch.zeros((2, 40), dtype=torch.uint8, device=cuda),
                       41)


@pytest.mark.parametrize("max_steps", [1, 50, 2000])
def test_walk_kernel_matches_plain(cuda, max_steps):
    k = 25
    genome = sim.genome_with_repeats(5000, seed=3, n_repeats=3,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=4)
    seqs = [s for _, s, _ in pr.reads1 + pr.reads2]
    ctr = tsf.SortedKmerCounter(k, 2)
    for s in seqs:
        ctr.add(*nthash.canonical_hashes(
            torch.from_numpy(alphabet.encode(s)[None]).to(cuda), k))
    wf = ext.walk_filter(ctr.finalize(cuda))
    seeds = np.stack([alphabet.encode(s[:k]) for s in seqs[:300]])
    st0 = ext.init_state(seeds, k + 400, k, cuda,
                         prev_base=np.zeros(len(seeds), np.uint8))
    fields = ("buf", "length", "f", "r", "status", "has_prev")
    a = st0._replace(**{n: getattr(st0, n).clone() for n in fields})
    b = st0._replace(**{n: getattr(st0, n).clone() for n in fields})
    launched = kernels.launches["walk"]
    a = ext.fast_extend(wf, a, k, max_steps)
    assert kernels.launches["walk"] == launched + 1
    b = ext.fast_extend_plain(wf, b, k, max_steps)
    for n in fields:
        assert torch.equal(getattr(a, n), getattr(b, n)), n


@pytest.mark.parametrize("max_depth,width", [(25, 16), (5, 16), (40, 4)])
def test_branch_kernel_matches_plain(cuda, max_depth, width):
    k = 25
    genome = sim.genome_with_repeats(5000, seed=5, n_repeats=3,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=6)
    seqs = [s for _, s, _ in pr.reads1 + pr.reads2] + [genome]
    ctr = tsf.SortedKmerCounter(k, 1)
    for s in seqs:
        ctr.add(*nthash.canonical_hashes(
            torch.from_numpy(alphabet.encode(s)[None]).to(cuda), k))
    wf = ext.walk_filter(ctr.finalize(cuda))
    g = alphabet.encode(genome)
    roots = np.stack([alphabet.encode(s[30:30 + k]) for s in seqs[:500]]
                     + [g[len(g) - k - d:len(g) - d] for d in range(45)])
    t = torch.from_numpy(roots).to(cuda)
    hashes = nthash.hash_base(t, k)
    launched = kernels.launches["branch"]
    d = ext.branch_depths(wf, t, hashes, k, max_depth, width)
    assert kernels.launches["branch"] == launched + 1
    assert torch.equal(d, ext.branch_depths_plain(wf, t, hashes, k,
                                                  max_depth, width))
