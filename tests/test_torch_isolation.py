"""The port stands alone: it imports neither jax nor any module of
abyss_tpu, its entry points default to the GPU and refuse to fall back
to the CPU, and chip_smoke.py refuses to run without a card or outside
a checkout of the repository."""

import ast
import contextlib
import io
import os
import shutil
import subprocess
import sys

import pytest
import torch

import abyss_tpu_torch
from abyss_tpu_torch import resolve_device
from abyss_tpu_torch.cli import tools
from abyss_tpu_torch.dbg import bloom_dbg
from abyss_tpu_torch.dbg.params import AssemblyParams

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "abyss_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "abyss_tpu")


def port_sources():
    for root, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import abyss_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'abyss_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", list(port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path}:{node.lineno} imports {name}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    fq = tmp_path / "r.fq"
    fq.write_text("@r/1\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bloom_dbg.assemble([str(fq)], AssemblyParams(k=25), out=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools.bloom_dbg_main(["-k", "25", str(fq), "-o",
                              str(tmp_path / "u.fa")])
    assert abyss_tpu_torch.__version__


def run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# every tool of `python -m abyss_tpu_torch` that takes --device, with
# arguments that reach the device (file names that need not exist where
# the device is resolved before any input is read)
DEVICE_TOOL_ARGS = {
    "map": ["r.fq", "c.fa"], "index": ["c.fa"],
    "count": ["-k", "5", "c.fa"],
    "distanceest": ["r.fq", "--target", "c.fa"],
    "pathconsensus": ["c.fa", "g.dot", "p.path", "-o", "o", "-s", "s"],
    "rresolver": ["c.fa", "g.dot", "r.fq", "-k", "25"],
    "consensus": ["c.fa", "r.fq"], "gapfill": ["c.fa", "r.fq", "-k", "25",
                                               "-o", "o"],
    "paired-dbg": ["r.fq", "-k", "50", "-K", "25"],
    "kmerprint": ["r.fq", "-k", "11"], "logcounter": ["r.fq", "-k", "15"],
    "samtobreak": ["c.fa", "c.fa"], "tigmint": ["c.fa", "r.fq", "-o", "o"],
    "arcs": ["c.fa", "r.fq"], "bwa": ["c.fa", "r.fq"],
    "bwamem": ["c.fa", "r.fq"], "bowtie2": ["c.fa", "r.fq"],
    "kaligner": ["c.fa", "r.fq"], "dida": ["c.fa", "r.fq"]}


@pytest.mark.parametrize("tool", sorted(DEVICE_TOOL_ARGS))
def test_device_tools_default_to_cuda(no_card, tmp_path, monkeypatch,
                                      tool):
    """Without a card each device tool raises, by default and with
    --device cuda, before it writes anything."""
    import importlib
    from abyss_tpu_torch.__main__ import TOOLS
    _, module, fn = TOOLS[tool]
    main = getattr(importlib.import_module(module), fn)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "c.fa").write_text(">c\n" + "ACGTTGCA" * 20 + "\n")
    for extra in ([], ["--device", "cuda"]):
        out = io.StringIO()
        with pytest.raises(RuntimeError, match="no CUDA device"), \
                contextlib.redirect_stdout(out):
            main(DEVICE_TOOL_ARGS[tool] + extra)
        assert out.getvalue() == ""
    assert sorted(os.listdir(tmp_path)) == ["c.fa"]


def test_every_dispatched_device_flag_is_listed():
    """The tools whose parser takes --device are exactly those above."""
    import argparse
    import importlib
    from abyss_tpu_torch.__main__ import TOOLS
    seen = set()

    class Probe(Exception):
        pass

    def parse_args(self, argv=None, namespace=None):
        raise Probe("--device" in self._option_string_actions)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        for name, (_, module, fn) in TOOLS.items():
            if name in ("pe", "stack-size", "fac", "bloom"):
                continue        # key=value arguments, or a dispatcher
            with pytest.raises(Probe) as got:
                getattr(importlib.import_module(module), fn)([])
            if got.value.args[0]:
                seen.add(name)
    assert seen == set(DEVICE_TOOL_ARGS) | {"bloom-dbg", "assemble",
                                            "konnector", "sealer"}
