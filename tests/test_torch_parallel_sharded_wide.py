"""The distributed exact engine of the port at wide k (ntHash-keyed
shards with routed hr/text side arrays), its fingerprint-collision
excision and strict mode on the mesh (the two mesh cases of
tests/test_wide_collision.py), and cycle breaking on a circular genome,
against abyss_tpu on the 8-device CPU mesh (tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.core import alphabet
from abyss_tpu.ops import nthash as jnt
from abyss_tpu.parallel import distributed as jdist
from abyss_tpu.parallel import sharded_table as jst
from abyss_tpu_torch import u64
from abyss_tpu_torch.dbg import hash_dbg as thd
from abyss_tpu_torch.ops import nthash as tnt
from abyss_tpu_torch.parallel import mesh as tm
from abyss_tpu_torch.parallel import sharded_table as tst

from .test_torch_parallel_sharded_table import pair_codes, read_codes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jdist.make_mesh(8, 1), tm.make_mesh(8, 1, tm.devices("cpu"))


def canon(s):
    return min(s, alphabet.revcomp(s))


def test_wide_k_assembly_matches_jax(meshes):
    """k = 49: the table (hr and text words included), then the whole
    mesh phase machine; contigs abyss_tpu's in order, and the port's
    single-device wide engine's as sets with coverage."""
    jm, tmesh = meshes
    genome = sim.genome_with_repeats(6000, seed=55, n_repeats=2,
                                     repeat_len=250)
    codes = pair_codes(genome, 100, 25, 0.003, 56)
    k = 49
    t = tst.build_sharded_table(tmesh, [codes], k)
    assert t.wide and t.text[0].shape[1] == 2
    jt = jst.build_sharded_table(jm, [codes], k)
    a, b = jt.host_table(), t.host_table()
    for f in ("kmers", "counts", "alive", "fwd_counts", "hr", "text"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    want, _ = jst.assemble_sharded(jm, [codes], k, kc=2, erode_cov=2)
    got, _ = tst.assemble_sharded(tmesh, [codes], k, kc=2, erode_cov=2)
    assert got == want and len(got) > 1
    ref, _ = thd.assemble_reads([codes], k, kc=2, erode_cov=2, device="cpu")
    assert sorted((canon(s), c) for s, c in got) == \
        sorted((canon(s), c) for s, c in ref)


@pytest.fixture
def collided(monkeypatch):
    """k = 40 reads of a genome with k-mer B's fingerprint aliased onto
    k-mer A's in both packages' kmer_hashes (tests/test_wide_collision.py's
    planted collision)."""
    k = 40
    genome = sim.random_genome(1500, seed=70)
    reads = [genome[s:s + 80] for s in range(0, len(genome) - 80, 3)]
    codes = np.full((len(reads), 80), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = alphabet.encode(r)
    _, _, c, _ = tnt.kmer_hashes_plain(torch.from_numpy(codes[:1]), k)
    c = u64.to_numpy(c)[0]
    a, b = np.uint64(c[0]), np.uint64(c[30])
    assert a != b
    jorig, torig = jnt.kmer_hashes, tnt.kmer_hashes

    def jpatched(codes_j, kk):
        f, r, cn, v = jorig(codes_j, kk)
        return f, r, jnp.where(cn == b, a, cn), v

    def tpatched(codes_t, kk):
        f, r, cn, v = torig(codes_t, kk)
        ia, ib = u64.s64(int(a)), u64.s64(int(b))
        return f, r, torch.where(cn == ib, ia, cn), v

    monkeypatch.setattr(jnt, "kmer_hashes", jpatched)
    monkeypatch.setattr(tnt, "kmer_hashes", tpatched)
    return k, codes, a


def test_collision_excised_on_mesh(meshes, collided, capfd):
    """The merged row is excised on its owner shard: the host table
    keeps it dead, as abyss_tpu's does, and the same line is logged."""
    jm, tmesh = meshes
    k, codes, a = collided
    host = tst.build_sharded_table(tmesh, [codes], k).host_table()
    port_err = capfd.readouterr().err
    hit = np.searchsorted(host.kmers, a)
    assert host.kmers[hit] == a and not host.alive[hit]
    ref = jst.build_sharded_table(jm, [codes], k).host_table()
    jax_err = capfd.readouterr().err
    np.testing.assert_array_equal(host.kmers, ref.kmers)
    np.testing.assert_array_equal(host.alive, ref.alive)
    np.testing.assert_array_equal(host.text, ref.text)
    assert "fingerprint collision: excised 1 merged row" in port_err
    assert port_err.splitlines()[-1] == jax_err.splitlines()[-1]


def test_collision_raises_on_mesh_in_strict_mode(meshes, collided,
                                                 monkeypatch):
    _, tmesh = meshes
    k, codes, _ = collided
    monkeypatch.setenv("ABYSS_TPU_COLLISION", "raise")
    with pytest.raises(RuntimeError, match="collision"):
        tst.build_sharded_table(tmesh, [codes], k)


def test_circular_genome_matches_jax(meshes):
    """A circular chromosome: pointer doubling never converges on the
    cycle, so its minimum (k-mer, strand) member is found by a second
    ranking pass and the edge into it cut; the contigs are abyss_tpu's
    sharded run's, and the single-device engine's."""
    jm, tmesh = meshes
    genome = sim.random_genome(1500, seed=99)
    codes = read_codes(genome + genome[:80], 900, seed=98)
    got, _ = tst.assemble_sharded(tmesh, [codes], 25, kc=2, erode_cov=2)
    want, _ = jst.assemble_sharded(jm, [codes], 25, kc=2, erode_cov=2)
    assert got == want
    ref, _ = thd.assemble_reads([codes], 25, kc=2, erode_cov=2,
                                device="cpu")
    assert sorted(canon(s) for s, _ in got) == \
        sorted(canon(s) for s, _ in ref)
    assert max(len(s) for s, _ in got) >= 1500
