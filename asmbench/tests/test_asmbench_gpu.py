"""The benchmark on the card at a test's size: the reference counts the
same on the card as on the CPU, a sound run of each cell is correct and
its control is not.  Run on the card with

    python -m pytest asmbench/tests -q -m gpu
"""

import time

import numpy as np
import pytest
import torch

from asmbench import faults, reference, registry, run

from .conftest import REPO, small_base

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def test_reference_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, 200000).astype(np.uint8)
    kc, sc = reference.kmer_keys(codes, 96, "cpu")
    kg, sg = reference.kmer_keys(codes, 96, cuda)
    assert torch.equal(kc, kg.cpu()) and torch.equal(sc, sg.cpu())
    (cc,) = reference.join_counts([kc, kc[::7]])
    (cg,) = reference.join_counts([kg, kg[::7]])
    assert torch.equal(cc, cg.cpu())


@pytest.mark.parametrize("workload", ["bloom-k96.pe", "bloom-k96.unitigs",
                                      "exact-k96.unitigs"])
def test_cell_and_its_control(cuda, tmp_path, workload):
    base = small_base(tmp_path, 200000, 50000)
    bench = registry.benchmark(REPO)
    result, rows = run.run_cell(bench, workload, 2 ** 31 + 3, 1.0, True,
                                cuda, time.perf_counter(), base=base)
    assert result["correct"], rows
    assert result["device"]["busy_s"] > 0
    result, rows = run.run_cell(bench, workload, 2 ** 31 + 3, 1.0, False,
                                cuda, time.perf_counter(), base=base,
                                under_window=faults.control)
    assert not result["correct"], rows
