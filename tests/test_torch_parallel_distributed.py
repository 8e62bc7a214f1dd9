"""abyss_tpu_torch/parallel/distributed.py against abyss_tpu's, on the
8-device CPU mesh (tests/conftest.py), mirroring
tests/test_distributed.py: the same reads (numpy, from a seed) through
both packages, every counter, count, histogram and FASTA byte equal."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abyss_tpu import sim as jsim
from abyss_tpu.dbg import bloom_dbg as jbd
from abyss_tpu.dbg import hash_dbg as jhd
from abyss_tpu.dbg.params import AssemblyParams as JParams
from abyss_tpu.io import read_batches as jread_batches
from abyss_tpu.parallel import distributed as jdist
from abyss_tpu_torch import convert, u64
from abyss_tpu_torch.dbg import bloom_dbg as tbd
from abyss_tpu_torch.dbg import hash_dbg as thd
from abyss_tpu_torch.dbg.params import AssemblyParams as TParams
from abyss_tpu_torch.io import read_batches as tread_batches
from abyss_tpu_torch.ops import nthash as tnt
from abyss_tpu_torch.ops.sorted_filter import build_sorted_filter
from abyss_tpu_torch.parallel import distributed as tdist
from abyss_tpu_torch.parallel import mesh as tm

torch.set_num_threads(1)

K = 21
SIZE = 1 << 16


def make_reads(n, L, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    codes[rng.integers(0, n, 3), rng.integers(0, L, 3)] = 4   # a few Ns
    return codes


@pytest.fixture(scope="module")
def cpu8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return tm.devices("cpu")


def meshes(cpu8, n_data, n_shard):
    return jdist.make_mesh(n_data, n_shard), tm.make_mesh(n_data, n_shard,
                                                          cpu8)


@pytest.mark.parametrize("n_data,n_shard", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_build_counters_match_jax(cpu8, n_data, n_shard):
    """The raw counters of the mesh build, not just its min-counts, equal
    abyss_tpu's for every split of the mesh (two batches streamed)."""
    codes = make_reads(64, 60, 1)
    batches = [codes, codes[:32]]
    jm, tmesh = meshes(cpu8, n_data, n_shard)
    jf = jdist.distributed_filter_build(jm, batches, K, size=SIZE)
    tf = tdist.distributed_filter_build(tmesh, batches, K, size=SIZE)
    assert tf.counters.shape == (SIZE + 1,)
    np.testing.assert_array_equal(tf.counters.numpy(),
                                  np.asarray(jf.counters))
    js = jdist.distributed_filter_build(jm, batches, K, size=SIZE,
                                        sharded=True)
    ts = tdist.distributed_filter_build(tmesh, batches, K, size=SIZE,
                                        sharded=True)
    assert len(ts.shards) == n_shard
    np.testing.assert_array_equal(
        torch.cat(ts.shards).numpy(), np.asarray(jax.device_get(js.counters)))
    q = np.random.default_rng(2).integers(0, 1 << 63, 500).astype(np.uint64)
    np.testing.assert_array_equal(
        ts.count(u64.from_numpy(q)).numpy(),
        np.asarray(js.count(jnp.asarray(q))))


def test_probe_histogram_classify_match_jax(cpu8):
    codes = make_reads(32, 60, 2)
    codes = np.concatenate([codes, codes])
    jm, tmesh = meshes(cpu8, 2, 4)
    jf = jdist.distributed_filter_build(jm, [codes], K, size=SIZE)
    host = np.asarray(jf.counters)[:SIZE]
    jc = jdist.shard_counters(jm, jnp.asarray(host))
    tc = tdist.shard_counters(tmesh, torch.from_numpy(host.copy()))
    jb, tb = jdist.shard_batch(jm, codes), tdist.shard_batch(tmesh, codes)

    counts, valid = jdist.make_probe_step(jm, K, 4, SIZE, 2)(jc, jb)
    tcounts, tvalid = tdist.make_probe_step(tmesh, K, 4, SIZE, 2)(tc, tb)
    np.testing.assert_array_equal(
        tm.gather_rows(tmesh, tcounts, "data").numpy(), np.asarray(counts))
    np.testing.assert_array_equal(
        tm.gather_rows(tmesh, tvalid, "data").numpy(), np.asarray(valid))

    h = jdist.make_histogram_step(jm, K, 4, SIZE, 2)(jc, jb)
    th = tdist.make_histogram_step(tmesh, K, 4, SIZE, 2)(tc, tb)
    np.testing.assert_array_equal(th.numpy(), np.asarray(h))
    assert int(th.sum()) > 0

    lens = np.random.default_rng(3).integers(20, 61, 64).astype(np.int32)
    jl = jax.device_put(lens, jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec("data")))
    tl = tm.scatter_rows(tmesh, torch.from_numpy(lens), "data")
    ja, jfb = jdist.make_classify_step(jm, K, 4, SIZE, 3)(jc, jb, jl)
    ta, tfb = tdist.make_classify_step(tmesh, K, 4, SIZE, 3)(tc, tb, tl)
    np.testing.assert_array_equal(tm.gather_rows(tmesh, ta, "data").numpy(),
                                  np.asarray(ja))
    np.testing.assert_array_equal(tm.gather_rows(tmesh, tfb, "data").numpy(),
                                  np.asarray(jfb))
    assert not np.asarray(ja).all() and np.asarray(ja).any()


def test_streaming_build_matches_jax(cpu8):
    """One batch or two: the same counters in both packages, and
    conservative (>= the true multiplicities) either way."""
    codes = make_reads(64, 60, 4)
    jm, tmesh = meshes(cpu8, 8, 1)
    for batches in ([codes], [codes[:32], codes[32:]]):
        jf = jdist.distributed_filter_build(jm, batches, K, size=SIZE)
        tf = tdist.distributed_filter_build(tmesh, batches, K, size=SIZE)
        np.testing.assert_array_equal(tf.counters.numpy(),
                                      np.asarray(jf.counters))
    canon, valid = tnt.canonical_hashes(torch.from_numpy(codes), K)
    got = tf.count(canon, valid).numpy()
    c = u64.to_numpy(canon)[valid.numpy()]
    uniq, cnt = np.unique(c, return_counts=True)
    true = dict(zip(uniq.tolist(), cnt.tolist()))
    want = np.array([true.get(int(x), 0) for x in u64.to_numpy(canon)
                     .reshape(-1)]).reshape(got.shape)
    want[~valid.numpy()] = 0
    assert (got >= want).all()


def test_count_kmers_matches_jax(cpu8):
    """Mesh k-mer counting in both key spaces equals abyss_tpu's, the
    port's single-device count_kmers and build_sorted_filter; batches
    whose rows do not divide the data axis pad with code 4."""
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 4, size=(24, 60), dtype=np.uint8)
               for _ in range(3)] + [rng.integers(0, 4, size=(13, 60),
                                                  dtype=np.uint8)]
    batches[1][:8] = batches[0][:8]
    jm, tmesh = meshes(cpu8, 4, 2)
    for packed in (None, False):
        jk, jc = jdist.distributed_count_kmers(jm, batches, K, packed=packed)
        tk, tc = tdist.distributed_count_kmers(tmesh, batches, K,
                                               packed=packed)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(tc, jc)
        assert tk.dtype == np.uint64 and tc.dtype == np.int32
    t = thd.count_kmers(batches, K, device="cpu")
    keys, counts = tdist.distributed_count_kmers(tmesh, batches, K)
    np.testing.assert_array_equal(keys, t.kmers)
    np.testing.assert_array_equal(counts, t.counts)
    f = build_sorted_filter(batches, K, threshold=1, device="cpu")
    keys, counts = tdist.distributed_count_kmers(tmesh, batches, K,
                                                 packed=False)
    np.testing.assert_array_equal(keys, u64.to_numpy(f.kmers))
    np.testing.assert_array_equal(counts, f.counts.numpy())


@pytest.fixture(scope="module")
def pass2_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("pass2")
    g = jsim.random_genome(3000, seed=17)
    pr = jsim.simulate_paired_reads(g, coverage=20, read_len=100, seed=18)
    paths = [str(d / "s1.fq"), str(d / "s2.fq")]
    pr.write_fastq(*paths)
    return g, paths


@pytest.fixture(scope="module")
def jax_pass2(cpu8, pass2_reads):
    """abyss_tpu's pass 2 over a replicated and a sharded mesh filter
    (2 x 4 mesh), and the sharded counters."""
    g, paths = pass2_reads
    jm = jdist.make_mesh(2, 4)
    out = {}
    for tag, sharded in (("replicated", False), ("sharded", True)):
        f = jdist.distributed_filter_build(
            jm, (b.codes for b in jread_batches(paths, 512, 128, q=3)), 25,
            threshold=2, size=1 << 18, sharded=sharded)
        buf = io.StringIO()
        jbd.assemble(paths, JParams(k=25, min_cov=2, batch_size=512,
                                    max_read_len=128, filter_mode="bloom"),
                     out=buf, prebuilt_filter=f)
        out[tag] = buf.getvalue()
        if sharded:
            out["counters"] = np.asarray(jax.device_get(f.counters))
    return out


def _port_pass2(paths, f):
    buf = io.StringIO()
    tbd.assemble(paths, TParams(k=25, min_cov=2, batch_size=512,
                                max_read_len=128, filter_mode="bloom"),
                 out=buf, prebuilt_filter=f, device="cpu")
    return buf.getvalue()


def test_sharded_pass2_matches_jax(cpu8, pass2_reads, jax_pass2):
    """Pass 2 (the extension walks) over the mesh-sharded filter, every
    probe a shard-local gather plus a psum, writes abyss_tpu's FASTA
    bytes, and the same unitigs as over the replicated filter."""
    g, paths = pass2_reads
    tmesh = tm.make_mesh(2, 4, cpu8)
    outs = {}
    for tag, sharded in (("replicated", False), ("sharded", True)):
        f = tdist.distributed_filter_build(
            tmesh, (b.codes for b in tread_batches(paths, 512, 128, q=3)),
            25, threshold=2, size=1 << 18, sharded=sharded)
        assert isinstance(f, tdist.ShardedCountingFilter) == sharded
        outs[tag] = _port_pass2(paths, f)
        assert outs[tag] == jax_pass2[tag]
    seqs = {t: sorted(l for l in o.splitlines() if not l.startswith(">"))
            for t, o in outs.items()}
    assert seqs["replicated"] == seqs["sharded"]
    assert sum(map(len, seqs["sharded"])) > 0.9 * len(g)


def test_resume_pass2_from_jax_sharded_counters(cpu8, pass2_reads,
                                                jax_pass2):
    """convert.sharded_filter_from_numpy carries abyss_tpu's sharded
    counters across: pass 2 from them writes abyss_tpu's FASTA."""
    _, paths = pass2_reads
    f = convert.sharded_filter_from_numpy(
        tm.make_mesh(2, 4, tm.devices("cpu")), jax_pass2["counters"], 25,
        threshold=2)
    assert f.size == 1 << 18 and len(f.shards) == 4
    assert _port_pass2(paths, f) == jax_pass2["sharded"]
    assert os.path.exists(paths[0])


def test_sharded_filter_probes_like_a_counting_filter(cpu8):
    """ShardedCountingFilter.count over any split equals the
    CountingBloomFilter of the same counters (the plain version the
    walk kernels' ShardedSolid is held against)."""
    codes = make_reads(48, 60, 5)
    _, tmesh = meshes(cpu8, 2, 4)
    s = tdist.distributed_filter_build(tmesh, [codes], K, size=SIZE,
                                       sharded=True)
    r = tdist.distributed_filter_build(tmesh, [codes], K, size=SIZE)
    canon, valid = tnt.canonical_hashes(torch.from_numpy(codes), K)
    np.testing.assert_array_equal(s.count(canon, valid).numpy(),
                                  r.count(canon, valid).numpy())
    np.testing.assert_array_equal(s.contains_bulk(canon).numpy(),
                                  r.contains(canon).numpy())
    assert s.count(canon).dtype == torch.int32
    assert s.device == torch.device("cpu")
    assert jhd.COVERAGE_MAX == thd.COVERAGE_MAX
