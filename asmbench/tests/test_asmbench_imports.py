"""What a run loads: never JAX or the JAX package, and the reference
nothing of the program."""

import json
import subprocess
import sys

from .conftest import REPO

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         cwd=REPO, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _top_level("import asmbench.reference, asmbench.check, "
                      "asmbench.contiguity, asmbench.roofline, asmbench.gen")
    assert "abyss_tpu_torch" not in mods
    assert not mods & {"jax", "jaxlib", "flax", "abyss_tpu"}


def test_harness_and_program_load_no_jax():
    mods = _top_level(
        "import asmbench.run, asmbench.calibrate, asmbench.faults\n"
        "from asmbench import registry\n"
        "import abyss_tpu_torch.pipeline.pe, abyss_tpu_torch.ops.kernels\n"
        "b = registry.benchmark('.')\n"
        "[registry.metric(m['name']) for m in b['per_layer']]")
    assert "abyss_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "abyss_tpu"}


def test_the_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "asmbench.run", "--workload",
         "exact-k96.unitigs", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
