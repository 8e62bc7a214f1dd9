"""A whole run of each cell on the CPU at a test's size, past the look
for a card: sound it is correct; with the control or a fault planted
under the timed path (faults.py) `correct` comes out false."""

import contextlib
import time

import pytest
import torch

from asmbench import faults, registry, run

from .conftest import REPO, small_base

CELLS = ["bloom-k96.pe", "bloom-k96.unitigs", "exact-k96.unitigs"]
# the bloom engine's walks run their plain versions on the CPU, slowly:
# its cells get the smallest genome that still holds the 12 repeats, and
# pe one that leaves its stages 6-8 joins to make (conftest.py)
GENOME_BP = {"bloom-k96.pe": 20000, "bloom-k96.unitigs": 10000,
             "exact-k96.unitigs": 20000}


def _run(tmp_path, workload, tracing=False, plant=contextlib.nullcontext):
    torch.set_num_threads(4)
    base = small_base(tmp_path, GENOME_BP[workload], 3000)
    bench = registry.benchmark(REPO)
    return run.run_cell(bench, workload, 2 ** 32 + 17, 0.01, tracing, "cpu",
                        time.perf_counter(), base=base, under_window=plant)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tmp_path, workload):
    result, rows = _run(tmp_path, workload)
    assert result["correct"], rows
    assert result["attempted"] == 1 and result["failed"] == 0
    names = [m["name"] for m in registry.cell_metrics(
        registry.benchmark(REPO), workload, "end_to_end")]
    assert list(result["metrics"]) == names
    if "ng50_kbp" in names:
        assert result["metrics"]["ng50_kbp"]["value"] > 0


def test_traced_run_reports_spans(tmp_path):
    result, rows = _run(tmp_path, "exact-k96.unitigs", tracing=True)
    assert result["correct"], rows
    m = result["metrics"]
    assert m["hash_dbg.count_s"]["value"] > 0
    assert m["hash_dbg.graph_s"]["value"] > 0
    # no card: the device metrics find nothing to read and stay out
    assert "device.idle_share" not in m
    assert "kernels.nthash_roofline" not in m
    assert result["device"]["window_s"] > 0


PLANTED = [(w, plant) for w in CELLS for plant in sorted(faults.plants_for(
    registry.traffic(registry.cell(registry.benchmark(REPO), w)["traffic"])
    ["target"]))]


@pytest.mark.parametrize("workload,plant", PLANTED)
def test_planted_fault_is_not_correct(tmp_path, workload, plant):
    result, rows = _run(tmp_path, workload, plant=faults.PLANTS[plant])
    assert not result["correct"], rows
