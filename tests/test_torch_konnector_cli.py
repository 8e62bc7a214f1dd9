"""The port's `konnector` CLI against abyss_tpu's, on the CPU: the
three output files (merged reads, unmerged mates) byte for byte with
the default filter, with `--cascade 2 --extend -D` on the cascading
Bloom filter (ABYSS_TPU_KONN_FILTER=cascade) with a trace file, with the
exact cascade counter, and with a branch cap (the host engine); and the
tool raises without a card unless --device cpu is given.
"""

import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.cli import tools as jtools
from abyss_tpu_torch.cli import tools as ttools

torch.set_num_threads(1)


def _write_reads(tmp_path, seed=60, glen=3000):
    genome = sim.random_genome(glen, seed=seed)
    pr = sim.simulate_paired_reads(genome, coverage=8, read_len=100,
                                   seed=seed + 1)
    p1, p2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    pr.write_fastq(p1, p2)
    return p1, p2


KONN_OUTPUTS = ("_merged.fa", "_reads_1.fq", "_reads_2.fq")


@pytest.mark.parametrize("opts,env", [
    ([], {}),
    (["--cascade", "2", "--extend", "-D", "1M", "-t", "trace"],
     {"ABYSS_TPU_KONN_FILTER": "cascade"}),
    (["--cascade", "2", "-P", "3", "--mask"], {}),
    (["-B", "4"], {}),
])
def test_konnector_cli_matches_jax(tmp_path, monkeypatch, opts, env):
    p1, p2 = _write_reads(tmp_path)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    outs = {}
    for name, main, extra in (("jax", jtools.konnector_main, []),
                              ("torch", ttools.konnector_main,
                               ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        o = [x if x != "trace" else str(d / "trace.tsv") for x in opts]
        main([p1, p2, "-k", "25", "-o", str(d / "out")] + o + extra)
        outs[name] = {s: open(str(d / "out") + s, "rb").read()
                      for s in KONN_OUTPUTS}
        if "trace" in opts:
            outs[name]["trace"] = open(d / "trace.tsv", "rb").read()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"]["_merged.fa"].count(b">") >= 1


def test_konnector_cli_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p1, p2 = _write_reads(tmp_path)
    with pytest.raises(RuntimeError):
        ttools.konnector_main([p1, p2, "-k", "25", "-o",
                               str(tmp_path / "o")])
