"""abyss_tpu_torch/parallel/sharded_table.py (the distributed exact
engine) against abyss_tpu's sharded engine on the 8-device CPU mesh
(tests/conftest.py), at every phase boundary through host_table()
(keys, counts, alive, adjacency), mirroring tests/test_sharded_table.py:
the same reads (numpy, from a seed) through both packages, and the port
resumed from abyss_tpu's table state (convert.sharded_table_from_numpy).
Contig lists are identical, in order, to abyss_tpu's sharded run and
set-identical, with coverage, to the port's single-device engine."""

import jax
import numpy as np
import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.core import alphabet
from abyss_tpu.parallel import distributed as jdist
from abyss_tpu.parallel import sharded_table as jst
from abyss_tpu_torch import convert, u64
from abyss_tpu_torch.dbg import hash_dbg as thd
from abyss_tpu_torch.parallel import mesh as tm
from abyss_tpu_torch.parallel import sharded_table as tst

torch.set_num_threads(1)

K = 25


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jdist.make_mesh(8, 1), tm.make_mesh(8, 1, tm.devices("cpu"))


def read_codes(genome, n_reads, read_len=80, seed=1, rc_frac=0.5):
    rng = np.random.default_rng(seed)
    codes = np.full((n_reads, read_len), 4, np.uint8)
    g = alphabet.encode(genome)
    for i in range(n_reads):
        s = rng.integers(0, len(genome) - read_len + 1)
        r = g[s:s + read_len]
        if rng.random() < rc_frac:
            r = alphabet.revcomp_codes(r)
        codes[i] = r
    return codes


def pair_codes(genome, read_len, coverage, error_rate, seed):
    reads = sim.simulate_paired_reads(genome, coverage=coverage,
                                      read_len=read_len,
                                      error_rate=error_rate, seed=seed)
    seqs = [s for pair in zip(reads.reads1, reads.reads2)
            for _, s, _ in pair]
    codes = np.full((len(seqs), read_len), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = alphabet.encode(s)
    return codes


def assert_tables_equal(jt, tt, adjacency=False):
    a, b = jt.host_table(), tt.host_table()
    for f in ("kmers", "counts", "alive", "fwd_counts"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    if a.text is not None:
        np.testing.assert_array_equal(b.text, a.text)
        np.testing.assert_array_equal(b.hr, a.hr)
    if adjacency:
        for d in range(tt.n_dev):
            np.testing.assert_array_equal(tt.nbr[d].numpy(),
                                          np.asarray(jt.nbr)[d])
            np.testing.assert_array_equal(tt.nbr_strand[d].numpy(),
                                          np.asarray(jt.nbr_strand)[d])


@pytest.fixture(scope="module")
def error_reads():
    genome = sim.genome_with_repeats(6000, seed=33, n_repeats=3,
                                     repeat_len=300)
    codes = pair_codes(genome, 80, 30, 0.004, 34)
    half = len(codes) // 2
    return [codes[:half], codes[half:]]


@pytest.fixture(scope="module")
def jax_phases(meshes, error_reads):
    """abyss_tpu's sharded table after each phase (host tables), and its
    per-shard arrays after adjacency (to resume the port from)."""
    jm, _ = meshes
    t = jst.build_sharded_table(jm, error_reads, K)
    out = {"count": t.host_table()}
    jst.apply_kc_sharded(t, 2)
    jst.build_adjacency_sharded(t)
    out["adjacency"] = t.host_table()
    out["nbr"] = np.asarray(t.nbr)
    out["nbr_strand"] = np.asarray(t.nbr_strand)
    out["state"] = {n: np.asarray(getattr(t, n)) for n in (
        "keys", "counts", "alive", "nbr", "nbr_strand", "fwd_counts")}
    out["eroded"] = jst.erode_sharded(t, 3, 1)
    out["erode"] = t.host_table()
    out["trimmed"] = jst.trim_sharded(t, K)
    out["trim"] = t.host_table()
    out["low_cov"] = jst.remove_low_coverage_sharded(t, 6.0)
    out["low-cov"] = t.host_table()
    return out


def _host_equal(a, b):
    for f in ("kmers", "counts", "alive", "fwd_counts"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_phases_match_jax(meshes, error_reads, jax_phases):
    """count -> kc -> adjacency -> erode (e=3, E=1) -> trim -> one
    low-coverage round: the port's table equals abyss_tpu's at every
    boundary, the neighbour ids per shard too; erode and the low-coverage
    round really remove rows."""
    _, tmesh = meshes
    t = tst.build_sharded_table(tmesh, error_reads, K)
    _host_equal(t.host_table(), jax_phases["count"])
    ref = thd.count_kmers(error_reads, K, strand_counts=True, device="cpu")
    assert t.shard_size < ref.n   # genuinely sharded
    tst.apply_kc_sharded(t, 2)
    tst.build_adjacency_sharded(t)
    _host_equal(t.host_table(), jax_phases["adjacency"])
    for d in range(8):
        np.testing.assert_array_equal(t.nbr[d].numpy(), jax_phases["nbr"][d])
        np.testing.assert_array_equal(t.nbr_strand[d].numpy(),
                                      jax_phases["nbr_strand"][d])
    assert tst.erode_sharded(t, 3, 1) == jax_phases["eroded"] > 0
    _host_equal(t.host_table(), jax_phases["erode"])
    assert tst.trim_sharded(t, K) == jax_phases["trimmed"]
    _host_equal(t.host_table(), jax_phases["trim"])
    assert tst.remove_low_coverage_sharded(t, 6.0) == \
        jax_phases["low_cov"] > 0
    _host_equal(t.host_table(), jax_phases["low-cov"])


def test_resume_from_jax_table(meshes, jax_phases):
    """The port resumed from abyss_tpu's table after adjacency
    (convert.sharded_table_from_numpy) erodes, trims and removes the
    low-coverage contigs as abyss_tpu does."""
    _, tmesh = meshes
    st = jax_phases["state"]
    t = convert.sharded_table_from_numpy(tmesh, K, **st)
    assert t.keys[0].dtype == torch.int64 and t.nbr[0].shape[1] == 8
    np.testing.assert_array_equal(u64.to_numpy(t.keys[3]), st["keys"][3])
    assert tst.erode_sharded(t, 3, 1) == jax_phases["eroded"]
    assert tst.trim_sharded(t, K) == jax_phases["trimmed"]
    assert tst.remove_low_coverage_sharded(t, 6.0) == jax_phases["low_cov"]
    _host_equal(t.host_table(), jax_phases["low-cov"])


def test_build_overflow_autoretry(meshes):
    """A tiny initial slack overflows the routing buckets; the batch is
    routed again with doubled slack, and the table is abyss_tpu's."""
    jm, tmesh = meshes
    codes = read_codes(sim.random_genome(3000, seed=71), 512)
    calls = []
    real = tst._bucketize

    def spy(*a):
        out = real(*a)
        calls.append(int(out[1]))
        return out

    tst._bucketize = spy
    try:
        t = tst.build_sharded_table(tmesh, [codes], K, chunk_cap_slack=0.05)
    finally:
        tst._bucketize = real
    assert max(calls) > 0 and calls[-1] == 0     # overflowed, then fit
    ref = jst.build_sharded_table(jm, [codes], K).host_table()
    _host_equal(t.host_table(), ref)


def test_per_device_buffer_bound(meshes, monkeypatch):
    """Every routed buffer of a full sharded assembly is bucketized with
    capacity O(N / D) (the sharded_table module's memory contract), the
    table shards are N / D sized, and the contigs are the port's
    single-device engine's, with coverage."""
    _, tmesh = meshes
    recorded = []
    real = tst._bucketize

    def spy(dest, good, payloads, cap, n_dev, fills):
        recorded.append(int(cap) * int(n_dev))
        return real(dest, good, payloads, cap, n_dev, fills)

    monkeypatch.setattr(tst, "_bucketize", spy)
    genome = sim.genome_with_repeats(7000, seed=72, n_repeats=2,
                                     repeat_len=200)
    codes = read_codes(genome, 517, read_len=97, seed=73)
    contigs, t = tst.assemble_sharded(tmesh, [codes], K, kc=2, erode_cov=2)
    assert contigs and recorded
    N = codes.shape[0] * (codes.shape[1] - K + 1)
    assert max(recorded) <= 8 * 4.0 * N / 8 + 64 * 8
    assert t.shard_size <= N // 8 + 1
    ref, _ = thd.assemble_reads([codes], K, kc=2, erode_cov=2, device="cpu")
    assert sorted(contigs) == sorted(ref)


def test_host_mesh_matches_1d(meshes):
    """The 2-D ("host", "data") mesh gives the 1-D mesh's table after
    every phase, and its contigs."""
    _, tmesh = meshes
    hmesh = tm.make_host_mesh(2, 4, tm.devices("cpu"))
    codes = read_codes(sim.random_genome(2500, seed=35), 600)
    tabs = []
    for m in (tmesh, hmesh):
        t = tst.build_sharded_table(m, [codes], K)
        assert t.n_dev == 8
        tst.apply_kc_sharded(t, 2)
        tst.build_adjacency_sharded(t)
        tst.erode_sharded(t, 2)
        tst.trim_sharded(t, K)
        tabs.append(t)
    a, b = tabs[0].host_table(), tabs[1].host_table()
    _host_equal(a, b)
    assert tst.assemble_final_sharded(tabs[0]) == \
        tst.assemble_final_sharded(tabs[1])


@pytest.fixture(scope="module")
def snp_reads():
    genome = sim.random_genome(8000, seed=71)
    pos = 4000
    alt = "ACGT"[("ACGT".index(genome[pos]) + 1) % 4]
    genome_b = genome[:pos] + alt + genome[pos + 1:]
    return np.concatenate([read_codes(genome, 2400, seed=72),
                           read_codes(genome_b, 1200, seed=73)])


def test_bubble_assembly_matches_jax(meshes, snp_reads, monkeypatch):
    """A heterozygous SNP makes a real bubble: the low-coverage loop,
    the bubble pop and emission run on the mesh (host_table() is never
    called); the popped branches and the contig list, coverage
    included, are abyss_tpu's in order, and the port's single-device
    engine's as sets."""
    jm, tmesh = meshes
    jpops, tpops = [], []
    want, _ = jst.assemble_sharded(jm, [snp_reads], K, kc=2, erode_cov=2,
                                   min_mean_cov=2.5, bubble_len=3 * K,
                                   bubbles_out=jpops)

    def no_merge(self):
        raise AssertionError("host_table() used during the mesh run")

    monkeypatch.setattr(tst.ShardedKmerTable, "host_table", no_merge)
    got, _ = tst.assemble_sharded(tmesh, [snp_reads], K, kc=2, erode_cov=2,
                                  min_mean_cov=2.5, bubble_len=3 * K,
                                  bubbles_out=tpops)
    assert got == want
    assert tpops == jpops and len(tpops) >= 1
    ref_pops = []
    ref, _ = thd.assemble_reads([snp_reads], K, kc=2, erode_cov=2,
                                min_mean_cov=2.5, bubble_len=3 * K,
                                bubbles_out=ref_pops, device="cpu")

    def canon(s):
        return min(s, alphabet.revcomp(s))

    assert sorted((canon(s), c) for s, c in got) == \
        sorted((canon(s), c) for s, c in ref)
    assert sorted(map(canon, tpops)) == sorted(map(canon, ref_pops))
