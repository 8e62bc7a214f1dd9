"""chip_smoke.py's own checks, on the CPU: its two placement lookups
agree, the sealer gate excuses only a short overlap written twice, its
phase selection runs each phase's prerequisites, and its patches of
module attributes come undone."""

import numpy as np
import pytest

import chip_smoke
from abyss_tpu_torch.core import alphabet

CASES = ["exact", "revcomp", "substitutions", "insertion", "deletion",
         "misjoin", "dense", "repeat", "short"]


def _genome():
    rng = np.random.default_rng(5)
    g = alphabet.decode(rng.integers(0, 4, 60000).astype(np.uint8))
    # a 300 bp repeat: anchors with several hits
    return g[:40000] + g[20000:20300] + g[40300:]


def _sub(s, i):
    return s[:i] + "ACGT"[("ACGT".index(s[i]) + 1) % 4] + s[i + 1:]


@pytest.mark.parametrize("case", CASES)
def test_genome_index_places_as_ungapped_mismatches(case):
    """GenomeIndex (the konnector and sealer phases) finds the placement
    ungapped_mismatches (the pe phases) finds, on both strands, with
    repeats, indels, misjoins and blocks shorter than an anchor."""
    genome = _genome()
    rc = alphabet.revcomp(genome)
    strands = ((genome, alphabet.encode(genome)), (rc, alphabet.encode(rc)))
    b = genome[10000:30000]
    block = {"exact": b, "revcomp": alphabet.revcomp(b),
             "substitutions": _sub(_sub(_sub(b, 500), 529), 15000),
             "insertion": b[:12000] + "A" + b[12000:],
             "deletion": b[:12000] + b[12001:],
             "misjoin": b[:-40] + genome[45000:45040],
             "dense": b[:9000] + "".join(
                 _sub(b[9000:9100], i)[i] if i % 8 == 0 else c
                 for i, c in enumerate(b[9000:9100])) + b[9100:],
             "repeat": _sub(genome[19950:20400], 100),
             "short": b[:31]}[case]
    want = chip_smoke.ungapped_mismatches(block, strands)
    got = chip_smoke.GenomeIndex(genome).locate(block)
    assert (got and got[0]) == want if want is not None else got is None
    if case in ("exact", "substitutions"):
        assert got[1:] == (0, 10000)
    if case == "revcomp":
        assert got[1:] == (1, len(genome) - 30000)


def _sealed(case):
    """(sealed block, its scaffold before sealing) for a gap between two
    flanks of the genome joined as `case` says."""
    g = _genome()
    a = g[1000:1600]
    b, inner = {"overlap": (g[1587:2200], ""),
                "overlap_revcomp": (g[1587:2200], ""),
                "long_overlap": (g[1300:1900], ""),
                "backward": (g[400:900], ""),
                "backward_near": (g[990:1590], ""),
                "distant": (g[5000:5600], ""),
                "gap_filled": (g[1620:2200], g[1600:1620]),
                "interior_left": (g[1587:2200], "ACGT")}[case]
    if case == "overlap_revcomp":
        a, b = alphabet.revcomp(b), alphabet.revcomp(a)
    return a + inner + b, a + "N" * 10 + b


@pytest.mark.parametrize("case,excused", [
    ("overlap", True), ("overlap_revcomp", True), ("long_overlap", False),
    ("backward", False), ("backward_near", False), ("distant", False),
    ("gap_filled", False), ("interior_left", False)])
def test_sealer_gate_excuses_only_a_short_overlap(case, excused):
    """The sealer phase excuses a sealed block only when its one fault is
    an overlap of fewer than max(SEALER_KS) bases between two flanks,
    written twice: not a longer overlap, a join backwards or to a
    distant place, or a gap closed with bases between the flanks (a
    correctly filled gap needs no excuse: the block places)."""
    genome = _genome()
    gidx = chip_smoke.GenomeIndex(genome)
    block, before = _sealed(case)
    parts = chip_smoke._flank_parts(block, before, gidx)
    assert len(parts) == 2
    assert chip_smoke._overlap_duplication(
        parts, len(block), max(chip_smoke.SEALER_KS)) is excused
    if case == "gap_filled":
        assert gidx.place(block) == []
    else:
        assert gidx.place(block) is None


@pytest.mark.parametrize("names,want", [
    ([], list(chip_smoke.PHASES)),
    (["sealer"], ["pe", "sealer"]),
    (["walk"], ["kernel", "main", "walk"]),
    (["paired_parity", "konnector"],
     ["parity", "pe_parity", "konnector", "paired_parity"]),
    (["tools", "tools_parity"], ["parity", "tools_parity", "tools"]),
    (["mesh_exact", "mesh_bloom"], ["exact_pe", "mesh_exact", "mesh_bloom"]),
    (["mesh_parity"], ["parity", "mesh_parity"])])
def test_phase_selection_runs_prerequisites(names, want):
    assert chip_smoke.phases_to_run(names) == want


def test_unknown_phase_is_refused(capsys):
    assert chip_smoke.main(["no_such_phase"]) == 2
    assert capsys.readouterr().out == ""


def test_patches_come_undone():
    """Patches (and Spans, built on it) put every replaced attribute back,
    also when the block raises."""
    import types
    mod = types.SimpleNamespace(f=lambda x: x + 1, g=lambda x: 2 * x)
    orig = (mod.f, mod.g)
    with pytest.raises(RuntimeError):
        with chip_smoke.Patches((mod, "f", lambda f: lambda x: f(x) * 10)):
            assert mod.f(1) == 20
            raise RuntimeError
    assert (mod.f, mod.g) == orig
    spans = chip_smoke.Spans()
    spans.patch(mod, "g", lambda x: -x)
    assert mod.g(3) == -3
    spans.restore()
    assert (mod.f, mod.g) == orig


def test_suffix_order_and_host_search():
    """The tools phase's checks of the genome's suffix array and of
    FM-index queries: a host search finds overlapping occurrences, and
    the order check refuses a swapped pair."""
    import numpy as np
    assert chip_smoke._host_find_all("AAAA", "AA") == [0, 1, 2]
    assert chip_smoke._host_find_all("ACGT", "GG") == []
    tb = bytes([2, 1, 2, 1, 0])
    sa = np.array([4, 3, 1, 2, 0])          # "$" < "A$" < "ACA$" < ...
    assert chip_smoke._suffix_order_ok(tb, sa, range(4))
    sa[[1, 2]] = sa[[2, 1]]
    assert not chip_smoke._suffix_order_ok(tb, sa, range(4))
