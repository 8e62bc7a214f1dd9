"""Shared fixtures of the benchmark's tests: a copy of the benchmark's
files with the genome cut to a test's size."""

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BASE = os.path.dirname(HERE)
REPO = os.path.dirname(BASE)


def small_base(tmp_path, genome_bp: int = 20000, warm_bp: int = 8000) -> str:
    base = str(tmp_path / "asmbench")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BASE, sub), os.path.join(base, sub))
    for name in os.listdir(os.path.join(base, "traffic")):
        path = os.path.join(base, "traffic", name)
        with open(path) as f:
            t = json.load(f)
        t["genome"]["length"] = genome_bp
        t["warmup_genome_bp"] = warm_bp
        # the genome's ends, covered thinly, are a larger share of a small
        # genome (sound runs read genome_miss 0.006-0.02 and scaffold_miss
        # up to 0.12 at 10-20 kbp, an empty assembly 1.0): the shares get
        # limits of the test's size
        t["limits"]["genome_miss"] = 0.1
        if t["target"] == "pe":
            t["limits"]["scaffold_miss"] = 0.5
            # 700 bp repeats, longer than a fragment, cut a genome of a
            # test's size into pieces that no stage can join; repeats of
            # 300 bp leave stages 6-8 joins to make.  At 20 kbp sound
            # scaffolds read NG50 5.033 kbp, stage 3's contigs 1.972 and
            # stage 6's 2.416
            t["genome"]["repeat_len"] = 300
            t["limits"]["scaffold_ng50_kbp"] = {"min": 3.5}
        with open(path, "w") as f:
            json.dump(t, f)
    return base


@pytest.fixture
def small(tmp_path):
    return small_base(tmp_path)


@pytest.fixture
def bench():
    from asmbench import registry
    return registry.benchmark(REPO)
