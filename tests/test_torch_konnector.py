"""The port's Konnector (gap/konnector.py, gap/konnector_dev.py) against
abyss_tpu's, on the CPU: every case of tests/test_konnector.py and
tests/test_gap.py as a parity case, under both search engines (the
device BFS and ABYSS_TPU_KONNECTOR=host), on the sorted, counting-Bloom
and cascading-Bloom filters.  Each ConnectResult must be equal field
for field (reason, seq, num_paths, mismatch counts, start_pos,
goal_pos).  Also `extend_outward` and `DupFilter`.  Error-laden reads,
the device search and its regrow path are in
test_torch_konnector_races.py, the CLI in test_torch_konnector_cli.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from abyss_tpu import sim
from abyss_tpu.core import alphabet
from abyss_tpu.gap import konnector as J
from abyss_tpu.ops import bloom as JB
from abyss_tpu.ops import nthash as JN
from abyss_tpu.ops.sorted_filter import SortedKmerCounter as JCounter
from abyss_tpu_torch.gap import konnector as T
from abyss_tpu_torch.ops import bloom as TB
from abyss_tpu_torch.ops import nthash as TN
from abyss_tpu_torch.ops.sorted_filter import SortedKmerCounter as TCounter

torch.set_num_threads(1)


def _codes(seqs):
    L = max(len(s) for s in seqs)
    codes = np.full((len(seqs), L), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = alphabet.encode(s)
    return codes


def filters(kind, seqs, k, threshold=1, reps=1):
    """(JAX filter, port filter) of the same reads: "sorted" (the
    exact counter), "bloom" (counting Bloom) or "cascade" (a depth-2
    cascading Bloom filter, the reads inserted `reps` times)."""
    codes = _codes(seqs)
    _, _, jc, jv = JN.kmer_hashes(jnp.asarray(codes), k)
    _, _, tc, tv = TN.kmer_hashes(torch.from_numpy(codes), k)
    if kind == "sorted":
        jctr, tctr = JCounter(k, threshold=threshold), \
            TCounter(k, threshold=threshold)
        jctr.add(jc, jv)
        tctr.add(tc, tv)
        return jctr.finalize(), tctr.finalize("cpu")
    if kind == "bloom":
        jf = JB.CountingBloomFilter.create(1 << 20, k, 4, threshold=threshold)
        tf = TB.CountingBloomFilter.create(1 << 20, k, 4, threshold=threshold,
                                           device="cpu")
    else:
        jf = JB.CascadingBloomFilter.create(1 << 20, k, depth=2)
        tf = TB.CascadingBloomFilter.create(1 << 20, k, depth=2,
                                            device="cpu")
    for _ in range(reps):
        jf = jf.insert(jc, jv)
        tf = tf.insert(tc, tv)
    return jf, tf


def results(r):
    return [dataclasses.astuple(x) for x in r]


def both(jf, tf, pairs, k, params=None, legacy=False, **kw):
    """Run both packages; assert equal results; return the port's."""
    if legacy:
        want = J.connect_pairs(jf, pairs, k, **kw)
        got = T.connect_pairs(tf, pairs, k, **kw)
    else:
        jp = J.ConnectPairsParams(**(params or {}))
        tp = T.ConnectPairsParams(**(params or {}))
        js, ts = J.ConnectStats(), T.ConnectStats()
        want = J.connect_pairs_full(jf, pairs, k, jp, stats=js, **kw)
        got = T.connect_pairs_full(tf, pairs, k, tp, stats=ts, **kw)
        assert ts.summary() == js.summary()
    assert results(got) == results(want)
    return got


@pytest.fixture(params=["device", "host"])
def engine(request, monkeypatch):
    monkeypatch.setenv("ABYSS_TPU_KONNECTOR", request.param)
    return request.param


# --------------------------------------------------------------------------
# tests/test_konnector.py as parity cases

K = 25


def _konnector_cases():
    g11 = sim.random_genome(600, seed=11)
    g12 = sim.random_genome(1200, seed=12)
    g13 = sim.random_genome(1200, seed=13)
    g14 = sim.random_genome(500, seed=14)
    other = sim.random_genome(200, seed=999)
    Lb = sim.random_genome(220, seed=15)
    Rb = sim.random_genome(220, seed=16)
    mid = sim.random_genome(81, seed=17)
    alt = mid[:40] + ("A" if mid[40] != "A" else "C") + mid[41:]
    g18 = sim.random_genome(400, seed=18)
    r1 = g18[50:150]
    bad = list(r1)
    bad[95] = "A" if r1[95] != "A" else "C"
    g19 = sim.random_genome(2000, seed=19)
    alien = sim.random_genome(200, seed=77)
    batch = [(g19[s:s + 100], alphabet.revcomp(g19[s + 300:s + 400]))
             for s in range(0, 1200, 120)] + [(alien[:100], alien[100:])]
    g21 = sim.random_genome(700, seed=21)
    bubble = ([Lb + mid + Rb, Lb + alt + Rb],
              [(Lb[-100:], alphabet.revcomp(Rb[:100]))])
    mask = ([g18], [("".join(bad), alphabet.revcomp(g18[250:350]))])
    return {
        "long_gap": ([g11], [(g11[100:200], alphabet.revcomp(g11[375:475]))],
                     K, {}),
        "near_max_frag": ([g12], [(g12[50:150],
                                   alphabet.revcomp(g12[850:950]))],
                          K, {"max_frag": 1000}),
        "max_frag_rejects": ([g13], [(g13[:100],
                                      alphabet.revcomp(g13[800:900]))],
                             K, {"max_frag": 400}),
        "no_kmer": ([g14], [(other[:100], other[100:200])], K, {}),
        "bubble": bubble + (K, {}),
        "bubble_too_many": bubble + (K, {"max_paths": 1}),
        "mask": mask + (K, {"mask": True}),
        "read_mismatch": mask + (K, {"max_read_mismatches": 0}),
        "preserve_reads": ([g19], batch, K, {"preserve_reads": True}),
        "identity_gates": bubble + (K, {"max_path_mismatches": 0,
                                        "min_read_identity": 99.5}),
        "batch_mixed": ([g19], batch, K, {}),
        "wide_k41": ([g21], [(g21[100:200], alphabet.revcomp(g21[400:500]))],
                     41, {}),
        "min_frag": ([g19], batch, K, {"min_frag": 390, "max_cost": 300}),
    }


@pytest.mark.parametrize("case", list(_konnector_cases()))
@pytest.mark.parametrize("kind", ["sorted", "bloom"])
def test_konnector_cases_match_jax(case, kind, engine):
    seqs, pairs, k, params = _konnector_cases()[case]
    jf, tf = filters(kind, seqs, k)
    got = both(jf, tf, pairs, k, params)
    assert got[0].reason


def test_start_kmer_positions_match_jax():
    rng = np.random.default_rng(0)
    solid = rng.random((50, 40)) < 0.7
    lens = rng.integers(20, 70, 50)
    for anchor in (False, True):
        for th in (1, 3):
            np.testing.assert_array_equal(
                J.start_kmer_positions(solid, lens, K, th, anchor),
                T.start_kmer_positions(solid, lens, K, th, anchor))


def test_dup_filter_matches_jax():
    genome = sim.random_genome(400, seed=20)
    jf, tf = filters("sorted", [genome], K)
    jd, td = J.DupFilter(1 << 16, K), T.DupFilter(1 << 16, K, device="cpu")
    for lo, hi in ((50, 350), (60, 340), (40, 360), (0, 10)):
        assert td.redundant_or_add(tf, genome[lo:hi]) == \
            jd.redundant_or_add(jf, genome[lo:hi])
    np.testing.assert_array_equal(np.asarray(jd.bits.bits),
                                  td.bits.bits.numpy())


# --------------------------------------------------------------------------
# tests/test_gap.py as parity cases (legacy connect_pairs API)

KG = 21


def _gap_cases():
    g80 = sim.random_genome(1000, seed=80)
    g1, g2 = sim.random_genome(300, seed=81), sim.random_genome(300, seed=82)
    g83 = sim.random_genome(3000, seed=83)
    return {
        "simple": ([g80], [(g80[:100], alphabet.revcomp(g80[300:400]))],
                   400),
        "no_path": ([g1, g2], [(g1[:80], alphabet.revcomp(g2[-80:]))], 300),
        "batch": ([g83], [(g83[s:s + 100],
                           alphabet.revcomp(g83[s + 250:s + 350]))
                          for s in range(0, 2500, 500)], 300),
    }


@pytest.mark.parametrize("case", list(_gap_cases()))
def test_gap_cases_match_jax(case, engine):
    seqs, pairs, max_gap = _gap_cases()[case]
    jf, tf = filters("bloom", seqs, KG)
    both(jf, tf, pairs, KG, legacy=True, max_gap=max_gap)


def test_cascading_filter_matches_jax(engine):
    genome = sim.random_genome(1000, seed=85)
    jf, tf = filters("cascade", [genome], KG, reps=2)
    np.testing.assert_array_equal(np.asarray(jf.levels), tf.levels.numpy())
    got = both(jf, tf, [(genome[:100], alphabet.revcomp(genome[300:400]))],
               KG, legacy=True, max_gap=400)
    assert got[0].reason == "CONNECTED" and got[0].seq == genome[:400]


def test_extend_outward_matches_jax():
    k = 25
    genome = sim.random_genome(1200, seed=55)
    reads = [genome[i:i + 80] for i in range(0, len(genome) - 80, 7)]
    for kind in ("bloom", "cascade", "sorted"):
        jf, tf = filters(kind, reads, k, reps=2)
        seqs = [genome[500:650], None, genome[100:120], genome[900:1000]]
        want = J.extend_outward(jf, seqs, k)
        got = T.extend_outward(tf, seqs, k)
        assert got == want
        assert len(got[0]) > 350
