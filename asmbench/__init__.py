"""asmbench: the benchmark of abyss_tpu_torch on one NVIDIA card.

    python3 -m asmbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json (run.py).  The parts are data found by
name: configurations in configs/, traffic mixes in traffic/, per-layer
metric readers in metrics/.  gen.py, contiguity.py and roofline.py are
frozen copies of the yardstick's arithmetic; reference.py is the plain
reference that decides `correct`, calibrate.py and faults.py give the
readings its limits were set from.  Tests: `python -m pytest
asmbench/tests -q` (CPU), `-m gpu` on the card.
"""
