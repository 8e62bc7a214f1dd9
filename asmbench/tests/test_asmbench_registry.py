"""BENCHMARK.json against the contract's form, and the registry finding
parts that later changes add as new files."""

import json
import os
import re
import shutil

import pytest

from asmbench import registry

from .conftest import BASE, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_form(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["asmbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for kind in ("configs", "workloads", "end_to_end",
                                    "per_layer") for x in bench[kind]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in bench["workloads"])) == \
        len(bench["workloads"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert set(e2e) == {"read_mbp_per_s", "peak_mem_gib", "ng50_kbp",
                        "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            registry.cell(bench, w)
    assert [w["name"] for w in bench["workloads"]] == [
        "bloom-k96.pe", "bloom-k96.unitigs", "exact-k96.unitigs"]
    assert all(w["chips"] == 1 for w in bench["workloads"])
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_part_is_a_file_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"asmbench/configs/{c['name']}.json"
        cfg = registry.config(c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        registry.config(w["config"])
        t = registry.traffic(w["traffic"])
        assert t["target"] in ("pe", "unitigs")
    for m in bench["per_layer"]:
        mod = registry.metric(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])
        assert callable(mod.read)


def test_new_parts_are_found_without_edits(tmp_path):
    base = str(tmp_path / "asmbench")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BASE, sub), os.path.join(base, sub))
    with open(os.path.join(base, "configs", "new-k64.json"), "w") as f:
        json.dump({"k": 64, "engine": "exact", "source": "x",
                   "reduced": [], "chips": 1}, f)
    with open(os.path.join(base, "traffic", "err1pct.unitigs.json"),
              "w") as f:
        json.dump({"target": "unitigs", "reads": {"error_rate": 0.01}}, f)
    with open(os.path.join(base, "metrics", "new.layer_s.py"), "w") as f:
        f.write("UNIT = 's'\nLAYER = 'new'\nMOVES = 'read_mbp_per_s'\n"
                "SPANS = {'x': ('abyss_tpu_torch.pipeline.pe', 'run')}\n"
                "def read(run):\n    return run.span_mean('x')\n")
    bench = registry.benchmark(REPO)
    bench["workloads"].append({"name": "new-k64.err1pct", "chips": 1,
                               "config": "new-k64",
                               "traffic": "err1pct.unitigs"})
    bench["per_layer"].append({"name": "new.layer_s", "unit": "s",
                               "workloads": ["new-k64.err1pct"]})
    cell = registry.cell(bench, "new-k64.err1pct")
    assert registry.config(cell["config"], base)["k"] == 64
    assert registry.traffic(cell["traffic"], base)["reads"] == {
        "error_rate": 0.01}
    names = [m["name"] for m in registry.cell_metrics(
        bench, "new-k64.err1pct", "per_layer")]
    assert names == ["new.layer_s"]
    mod = registry.metric("new.layer_s", base)

    class View:
        @staticmethod
        def span_mean(name):
            return 2.5 if name == "x" else None
    assert mod.read(View) == 2.5
    assert registry.cell_metrics(bench, "new-k64.err1pct", "end_to_end") \
        == [m for m in bench["end_to_end"] if "workloads" not in m]
    with pytest.raises(KeyError):
        registry.cell(bench, "absent")


def test_limits_cover_every_number():
    for name in os.listdir(os.path.join(BASE, "traffic")):
        t = registry.traffic(name[:-len(".json")])
        want = {"failed_jobs", "fasta_differs", "cov_mismatch",
                "unsolid_kmers", "genome_miss"}
        if t["target"] == "pe":
            want |= {"scaffold_miss", "scaffold_ng50_kbp"}
        assert set(t["limits"]) == want
