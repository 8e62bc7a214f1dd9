"""The paired de Bruijn graph's cell (paired-k96K16.unitigs) and
exact-k96.pe on the CPU at a test's size: sound runs are correct, the
planted faults are not, the traced paired run reads its three spans,
and the new parts are found by name.

What `correct` cannot see in the paired cell is the control (counts
held in 8 bits): pe writes every paired unitig with coverage 0, so no
header carries a count to compare, and the FASTA under the control is
the sound one byte for byte.

With coverage 0 in every header, `cov_mismatch` counts the unitigs
that hold a 96-mer some read holds, and the paired traffic gives it a
minimum.  That is what sees half_batch: without bubble popping, the
pair graph of half the reads holds fewer solid error pairs, so it
breaks into fewer, longer unitigs that miss less of the genome, and
the other numbers of reference.py read as well or better.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from asmbench import faults, gen, jobs, reference_paired, registry, run, trace

from .conftest import REPO, small_base

PAIRED = "paired-k96K16.unitigs"
EXACT_PE = "exact-k96.pe"
# the exact engine's stage 8 joins nothing at 20-30 kbp (its scaffolds
# read the unscaffolded NG50 there); at 50 kbp sound scaffolds read
# 15.654 kbp and both pe faults 5.552
GENOME_BP = {PAIRED: 20000, EXACT_PE: 50000}
# limits of the test's size: at 20 kbp the paired cell's sound unitigs
# miss 0.34 of the genome's 96-mers and hold 35 unsolid ones, `altered`
# 131, `unchanged` misses all; 34 sound unitigs hold read 96-mers,
# 20 under `half_batch`
SMALL_LIMITS = {PAIRED: {"genome_miss": 0.5, "unsolid_kmers": 80,
                         "cov_mismatch": {"min": 27}},
                EXACT_PE: {"scaffold_ng50_kbp": {"min": 10}}}
SEED = 2 ** 32 + 17


def _base(tmp_path, workload):
    base = small_base(tmp_path, GENOME_BP[workload], 3000)
    bench = registry.benchmark(REPO)
    path = os.path.join(base, "traffic",
                        registry.cell(bench, workload)["traffic"] + ".json")
    with open(path) as f:
        t = json.load(f)
    t["limits"].update(SMALL_LIMITS[workload])
    with open(path, "w") as f:
        json.dump(t, f)
    return base


def _run(tmp_path, workload, tracing=False, plant=contextlib.nullcontext):
    torch.set_num_threads(4)
    return run.run_cell(registry.benchmark(REPO), workload, SEED, 0.01,
                        tracing, "cpu", time.perf_counter(),
                        base=_base(tmp_path, workload), under_window=plant)


def test_new_parts_are_found_by_name(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[PAIRED]["config"] == "ecoli-k96K16-paired"
    assert cells[EXACT_PE]["config"] == "ecoli-k96-exact"
    for name in (PAIRED, EXACT_PE):
        assert cells[name]["chips"] == 1
        assert 1 <= len(cells[name]["why"]) <= 200
    cfg = registry.config("ecoli-k96K16-paired")
    assert (cfg["k"], cfg["K"], cfg["reduced"]) == (96, 16, [])
    assert registry.traffic("unitigs-paired")["target"] == "unitigs"
    assert registry.traffic("pe-exact")["target"] == "pe"
    # the paired headers carry coverage 0: cov_mismatch counts the
    # unitigs that reads support, and has a minimum
    assert "min" in registry.traffic("unitigs-paired")["limits"][
        "cov_mismatch"]
    names = [m["name"] for m in registry.cell_metrics(bench, PAIRED,
                                                      "per_layer")]
    assert {"paired_dbg.count_s", "paired_dbg.graph_s", "paired_dbg.emit_s",
            "device.idle_share"} == set(names)
    for name in ("paired_dbg.count_s", "paired_dbg.graph_s",
                 "paired_dbg.emit_s"):
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        mod = registry.metric(name)
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            entry["unit"], entry["layer"], entry["moves"])


def test_reference_paired_loads_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, sys, asmbench.reference_paired\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO})
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"abyss_tpu_torch", "abyss_tpu", "jax", "jaxlib",
                       "torch"}


@pytest.mark.parametrize("workload", [PAIRED, EXACT_PE])
def test_sound_run_is_correct(tmp_path, workload):
    result, rows = _run(tmp_path, workload)
    assert result["correct"], rows
    assert result["attempted"] == 1 and result["failed"] == 0
    names = [m["name"] for m in registry.cell_metrics(
        registry.benchmark(REPO), workload, "end_to_end")]
    assert list(result["metrics"]) == names


PLANTED = [(PAIRED, p) for p in ("unchanged", "half_batch", "altered")] + \
    [(EXACT_PE, p) for p in faults.plants_for("pe")]


@pytest.mark.parametrize("workload,plant", PLANTED)
def test_planted_fault_is_not_correct(tmp_path, workload, plant):
    result, rows = _run(tmp_path, workload, plant=faults.PLANTS[plant])
    assert not result["correct"], rows


def _paired_job(tmp_path, plant=contextlib.nullcontext):
    base = _base(tmp_path, PAIRED)
    bench = registry.benchmark(REPO)
    cell = registry.cell(bench, PAIRED)
    config = registry.config(cell["config"], base)
    traffic = registry.traffic(cell["traffic"], base)
    inputs = run.Inputs(traffic["genome"], traffic["reads"], SEED,
                        str(tmp_path), "reads")
    with plant():
        out = jobs.run_job("unitigs", config, inputs.paths,
                           str(tmp_path / "job"), "cpu")
    return out["unitigs"], inputs, config


def test_control_cannot_show_in_the_paired_cell(tmp_path):
    sound, _, _ = _paired_job(tmp_path / "sound")
    held, _, _ = _paired_job(tmp_path / "control", faults.control)
    heads = [h for h, _ in gen.parse_fasta(sound)]
    assert heads and all(h.split()[2] == "0" for h in heads)
    assert held == sound


def test_pair_graph_reference_tells_half_batch_apart(tmp_path):
    sound, inputs, config = _paired_job(tmp_path / "sound")
    halved, _, _ = _paired_job(tmp_path / "half", faults.half_batch)
    ref = {s for s, _ in reference_paired.assemble(
        list(inputs.reads), config["K"], config["k"], kc=2)}
    assert {s.decode() for _, s in gen.parse_fasta(sound)} == ref
    assert {s.decode() for _, s in gen.parse_fasta(halved)} != ref


def test_traced_paired_run_reports_spans(tmp_path):
    result, rows = _run(tmp_path, PAIRED, tracing=True)
    assert result["correct"], rows
    m = result["metrics"]
    for name in ("paired_dbg.count_s", "paired_dbg.graph_s",
                 "paired_dbg.emit_s"):
        assert m[name]["value"] > 0
    assert "device.idle_share" not in m      # no card
    assert result["device"]["window_s"] > 0


def test_metrics_fall_silent_without_the_emission_function(monkeypatch):
    """A program from before the emission was a function (a parent
    checkout): the readers wrap nothing that is not there and read
    nothing, and the count still reads."""
    from abyss_tpu_torch.dbg import paired_dbg
    monkeypatch.delattr(paired_dbg, "_emit_packed_chains")
    emit = registry.metric("paired_dbg.emit_s")
    graph = registry.metric("paired_dbg.graph_s")
    count = registry.metric("paired_dbg.count_s")
    assert emit.SPANS == {}
    assert "paired_dbg.emit" not in graph.SPANS

    class View:
        jobs = [{"paired_dbg.assemble_pairs": 9.0,
                 "paired_dbg.count_pairs": 2.0}]

        @classmethod
        def span_mean(cls, name):
            vals = [j[name] for j in cls.jobs if name in j]
            return sum(vals) / len(vals) if vals else None

    assert emit.read(View) is None and graph.read(View) is None
    assert count.read(View) == 2.0
    rec = trace.Recorder(lambda: None)
    rec.install({**emit.SPANS, **graph.SPANS, **count.SPANS}, {})
    rec.remove()
