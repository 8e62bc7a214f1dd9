"""The port's Sealer (gap/sealer.py and the `sealer` tool) against
abyss_tpu's, on the CPU: tests/test_gap.py::test_sealer_closes_gap as a
parity case of `seal`, and the tool's scaffold file byte for byte with
one k and with a sweep of two (`pe sealer_ks` is held to the JAX
package in test_torch_pe.py, resumed from the JAX run's stage-8
files).
"""

import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.cli import tools as jtools
from abyss_tpu.gap import sealer as J
from abyss_tpu_torch.cli import tools as ttools
from abyss_tpu_torch.gap import sealer as T

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gapped(tmp_path_factory):
    """Reads of a 4 kbp genome and scaffolds with N gaps: one of 150 Ns
    over genome[2000:2150], one of 40 Ns, and one whose flank holds an
    N (not a candidate)."""
    base = tmp_path_factory.mktemp("sealer")
    genome = sim.random_genome(4000, seed=84)
    pr = sim.simulate_paired_reads(genome, coverage=30, read_len=100,
                                   seed=85)
    p1, p2 = str(base / "r1.fq"), str(base / "r2.fq")
    pr.write_fastq(p1, p2)
    scaffolds = [("s0", genome[:2000] + "N" * 150 + genome[2150:]),
                 ("s1", genome[300:900] + "N" * 40 + genome[1000:1600]),
                 ("s2", genome[:50] + "N" * 10 + genome[60:70] + "N" * 5
                  + genome[75:400])]
    path = str(base / "scaf.fa")
    with open(path, "w") as f:
        for name, seq in scaffolds:
            f.write(f">{name}\n{seq}\n")
    return base, [p1, p2], genome, scaffolds, path


def test_seal_matches_jax(gapped):
    _, reads, genome, scaffolds, _ = gapped
    kw = dict(ks=[21], bloom_bytes=8 << 20, flank=100, max_gap=400)
    want, wst = J.seal(scaffolds, reads, **kw)
    got, gst = T.seal(scaffolds, reads, device="cpu", **kw)
    assert got == want
    assert (gst.gaps, gst.closed) == (wst.gaps, wst.closed)
    assert got[0][1] == genome and gst.closed >= 1


@pytest.mark.parametrize("ks", [["25"], ["31", "21"]])
def test_sealer_cli_matches_jax(gapped, ks):
    base, reads, _, _, scaf = gapped
    outs = {}
    for tag, main, extra in (("jax", jtools.sealer_main, []),
                             ("port", ttools.sealer_main,
                              ["--device", "cpu"])):
        prefix = str(base / f"{tag}{len(ks)}")
        kargs = [a for k in ks for a in ("-k", k)]
        main(reads + ["-S", scaf, "-b", "8M", "-o", prefix] + kargs + extra)
        with open(prefix + "_scaffold.fa", "rb") as f:
            outs[tag] = f.read()
    assert outs["port"] == outs["jax"]
    assert outs["port"].count(b"N") < 200


def test_seal_overlapping_flanks_matches_jax(gapped):
    """A gap between two contigs that overlap by 13 bases on the genome:
    abyss_tpu's sealer closes it with an empty interior and so writes
    the overlap twice (its merged read is shorter than the two flanks);
    the port writes the same bytes."""
    _, reads, genome, _, _ = gapped
    scaffolds = [("s0", genome[:2013] + "N" * 10 + genome[2000:])]
    kw = dict(ks=[21], bloom_bytes=8 << 20, flank=100, max_gap=400)
    want, wst = J.seal(scaffolds, reads, **kw)
    got, gst = T.seal(scaffolds, reads, device="cpu", **kw)
    assert got == want and (gst.gaps, gst.closed) == (wst.gaps, wst.closed)
    assert want[0][1] == genome[:2013] + genome[2000:]


def test_sealer_cli_needs_a_card(gapped):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    base, reads, _, _, scaf = gapped
    with pytest.raises(RuntimeError):
        ttools.sealer_main(reads + ["-S", scaf, "-k", "25", "-o",
                                    str(base / "x")])
