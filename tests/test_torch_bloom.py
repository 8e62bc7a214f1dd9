"""The port's Bloom filters (ops/bloom.py) against abyss_tpu's, on the
cases of tests/test_bloom.py: the same hashes go into both, and the
counting filter's counters must be bit-identical in each of its three
update modes ("scatter", "sort", "pallas"; abyss_tpu runs "scatter",
which its own tests hold equal to the others), the cascading filter's
levels and the bit filter's bits too.  Filters written to .npz by
either package are read by the other.  Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abyss_tpu.core import alphabet
from abyss_tpu.ops import bloom as jb
from abyss_tpu.ops import nthash as jnt
from abyss_tpu.ops import sort_join as jsj
from abyss_tpu_torch import u64
from abyss_tpu_torch.ops import bloom as tb
from abyss_tpu_torch.ops import sort_join as tsj

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

MODES = ("scatter", "sort", "pallas")


def rnd(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def kmer_canon(seq, k):
    """(canon uint64, valid bool) numpy arrays of seq's k-windows."""
    _, _, canon, valid = jnt.kmer_hashes(alphabet.encode(seq)[None], k)
    return np.asarray(canon)[0], np.asarray(valid)[0]


def T(a):
    """numpy -> port tensor (uint64 as int64 bits)."""
    return u64.from_numpy(a) if a.dtype == np.uint64 else torch.from_numpy(a)


def counting_pair(size, k, mode, **kw):
    jf = jb.CountingBloomFilter.create(size, k, **kw)
    tf = tb.CountingBloomFilter.create(size, k, device="cpu", **kw)
    tf.update_mode = mode
    return jf, tf


def same_counters(jf, tf):
    np.testing.assert_array_equal(tf.counters.numpy(), np.asarray(jf.counters))


@pytest.mark.parametrize("mode", MODES)
def test_insert_contains_roundtrip(mode):
    k = 21
    jf, tf = counting_pair(1 << 16, k, mode, num_hashes=4, threshold=2)
    canon, valid = kmer_canon(rnd(300, 3), k)
    jf = jf.insert(jnp.asarray(canon), jnp.asarray(valid))
    tf.insert(T(canon), T(valid))
    same_counters(jf, tf)
    counts = tf.count(T(canon)).numpy()
    np.testing.assert_array_equal(counts, np.asarray(jf.count(canon)))
    assert (counts >= 1).all()
    jf = jf.insert(jnp.asarray(canon), jnp.asarray(valid))
    tf.insert(T(canon), T(valid))
    same_counters(jf, tf)
    assert tf.contains(T(canon)).all()


@pytest.mark.parametrize("mode", MODES)
def test_absent_kmers_mostly_absent(mode):
    k = 21
    jf, tf = counting_pair(1 << 18, k, mode, num_hashes=4, threshold=1)
    canon, valid = kmer_canon(rnd(500, 4), k)
    jf = jf.insert(jnp.asarray(canon), jnp.asarray(valid))
    tf.insert(T(canon), T(valid))
    same_counters(jf, tf)
    other, _ = kmer_canon(rnd(500, 104), k)
    hit = tf.contains(T(other)).numpy()
    np.testing.assert_array_equal(hit, np.asarray(jf.contains(other)))
    assert hit.mean() < 0.02


@pytest.mark.parametrize("mode", MODES)
def test_duplicate_multiplicity_in_single_batch(mode):
    k = 5
    jf, tf = counting_pair(1 << 14, k, mode, num_hashes=3, threshold=3)
    canon, valid = kmer_canon("ACGTA" * 4, k)
    jf = jf.insert(jnp.asarray(canon), jnp.asarray(valid))
    tf.insert(T(canon), T(valid))
    same_counters(jf, tf)
    counts = tf.count(T(canon)).numpy()
    for u, c in zip(*np.unique(canon, return_counts=True)):
        assert (counts[canon == u] >= c).all()


@pytest.mark.parametrize("mode", MODES)
def test_batch_order_invariance(mode):
    k = 11
    rng = np.random.default_rng(5)
    canon, valid = kmer_canon(rnd(400, 5), k)
    perm = rng.permutation(canon.shape[0])
    jf, tf = counting_pair(1 << 16, k, mode)
    jf = jf.insert(jnp.asarray(canon), jnp.asarray(valid))
    tf.insert(T(canon[perm]), T(valid[perm]))
    same_counters(jf, tf)


@pytest.mark.parametrize("mode", MODES)
def test_counts_match_exact_counts(mode):
    """On a collision-free filter, conservative min-count == exact count."""
    k = 17
    canon, valid = kmer_canon(rnd(2000, 6), k)
    jf, tf = counting_pair(1 << 22, k, mode, num_hashes=4)
    jf = jf.insert(jnp.asarray(canon), jnp.asarray(valid))
    tf.insert(T(canon), T(valid))
    same_counters(jf, tf)
    counts = tf.count(T(canon)).numpy()
    exact = dict(zip(*[a.tolist() for a in np.unique(canon,
                                                     return_counts=True)]))
    assert all(n == exact[int(c)] for c, n in zip(canon, counts))


@pytest.mark.parametrize("mode", MODES)
def test_streaming_and_insert_counts(mode):
    """Three streamed chunks, then insert_counts with explicit counts and
    a mask: counters equal abyss_tpu's after each."""
    k = 13
    canon, valid = kmer_canon(rnd(600, 7), k)
    jf, tf = counting_pair(1 << 16, k, mode)
    n = canon.shape[0]
    for lo in range(0, n, n // 3 + 1):
        hi = min(lo + n // 3 + 1, n)
        jf = jf.insert(jnp.asarray(canon[lo:hi]), jnp.asarray(valid[lo:hi]))
        tf.insert(T(canon[lo:hi]), T(valid[lo:hi]))
        same_counters(jf, tf)
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 300, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    jf = jf.insert_counts(jnp.asarray(canon), jnp.asarray(counts),
                          jnp.asarray(mask))
    tf.insert_counts(T(canon), T(counts), T(mask))
    same_counters(jf, tf)
    assert int(tf.counters.max()) == 255          # saturated


def test_masked_lanes_are_noops():
    k = 9
    canon = np.array([123456789, 987654321], dtype=np.uint64)
    mask = np.array([True, False])
    jf, tf = counting_pair(1 << 14, k, "scatter")
    jf = jf.insert(jnp.asarray(canon), jnp.asarray(mask))
    tf.insert(T(canon), T(mask))
    same_counters(jf, tf)
    assert tf.count(T(canon)).tolist() == [1, 0]
    assert tf.count(T(canon), T(mask)).tolist() == [1, 0]


def test_bit_filter_and_window():
    k = 9
    canon, valid = kmer_canon(rnd(200, 8), k)
    jf = jb.BitBloomFilter.create(1 << 16, k, num_hashes=4)
    tf = tb.BitBloomFilter.create(1 << 16, k, num_hashes=4, device="cpu")
    assert not tf.contains(T(canon)).any()
    jf = jf.insert(jnp.asarray(canon), jnp.asarray(valid))
    tf.insert(T(canon), T(valid))
    np.testing.assert_array_equal(tf.bits.numpy(), np.asarray(jf.bits))
    assert tf.contains(T(canon)).all()
    jw = jb.BitBloomFilter.create(1 << 16, k).insert_window(
        jnp.asarray(canon), 1000, 40000, jnp.asarray(valid))
    tw = tb.BitBloomFilter.create(1 << 16, k, device="cpu").insert_window(
        T(canon), 1000, 40000, T(valid))
    np.testing.assert_array_equal(tw.bits.numpy(), np.asarray(jw.bits))
    np.testing.assert_array_equal(tw.union(tf).bits.numpy(),
                                  np.asarray(jw.union(jf).bits))
    np.testing.assert_array_equal(tw.intersect(tf).bits.numpy(),
                                  np.asarray(jw.intersect(jf).bits))
    assert tw.popcount == jw.popcount


def test_recommended_sizes():
    for budget in (9 << 20, 1 << 22, 16 << 20, 2 << 30):
        assert tb.recommended_sizes(budget) == jb.recommended_sizes(budget)


def test_cascading_levels_semantics():
    """One insert promotes one level; contains == seen >= depth times."""
    k = 9
    canon = np.array([0x1234567, 0xABCDEF01, 0x55AA55AA], dtype=np.uint64)
    f = tb.CascadingBloomFilter.create(1 << 16, k, depth=3, device="cpu")
    c = T(canon)
    assert f.count(c).tolist() == [0, 0, 0]
    assert f.insert(c[:1]).count(c).tolist() == [1, 0, 0]
    assert f.insert(c[:2]).count(c).tolist() == [2, 1, 0]
    assert f.insert(c).count(c).tolist() == [3, 2, 1]
    assert f.contains(c).tolist() == [True, False, False]
    assert f.insert(c[:1]).count(c[:1]).tolist() == [3]   # saturation
    j = jb.CascadingBloomFilter.create(1 << 16, k, depth=3)
    for part in (canon[:1], canon[:2], canon, canon[:1]):
        j = j.insert(jnp.asarray(part))
    np.testing.assert_array_equal(f.levels.numpy(), np.asarray(j.levels))


def test_cascading_batch_matches_jax_and_sequential():
    """A batch with duplicate keys gives abyss_tpu's levels, and the same
    levels as inserting the keys one at a time."""
    k = 11
    canon, valid = kmer_canon(rnd(300, 5), k)
    canon = canon[valid]
    batch = np.concatenate([canon, canon[::2], canon[::4]])  # mults 1-3
    j = jb.CascadingBloomFilter.create(1 << 16, k, depth=3).insert(
        jnp.asarray(batch))
    f1 = tb.CascadingBloomFilter.create(1 << 16, k, depth=3, device="cpu")
    f1.insert(T(batch))
    np.testing.assert_array_equal(f1.levels.numpy(), np.asarray(j.levels))
    f2 = tb.CascadingBloomFilter.create(1 << 16, k, depth=3, device="cpu")
    for h in T(batch):
        f2.insert(h[None])
    assert torch.equal(f1.levels, f2.levels)


def test_cascading_windowed_union_matches_single_shot():
    """Window-sharded cascade builds OR-merge to the single-shot filter,
    and each shard equals abyss_tpu's."""
    k = 11
    canon, valid = kmer_canon(rnd(400, 21), k)
    canon = np.concatenate([canon[valid], canon[valid][::2]])
    size = 1 << 14
    single = tb.CascadingBloomFilter.create(size, k, num_hashes=1, depth=2,
                                            device="cpu").insert(T(canon))
    merged = None
    for i in range(4):
        lo, hi = i * size // 4, (i + 1) * size // 4
        shard = tb.CascadingBloomFilter.create(
            size, k, num_hashes=1, depth=2, device="cpu").insert_window(
                T(canon), lo, hi)
        jshard = jb.CascadingBloomFilter.create(
            size, k, num_hashes=1, depth=2).insert_window(
                jnp.asarray(canon), lo, hi)
        np.testing.assert_array_equal(shard.levels.numpy(),
                                      np.asarray(jshard.levels))
        merged = shard if merged is None else tb.union(merged, shard)
    assert torch.equal(single.levels, merged.levels)
    with pytest.raises(ValueError):
        tb.CascadingBloomFilter.create(size, k, num_hashes=4,
                                       device="cpu").insert_window(
            T(canon[:1]), 0, 100)


def test_union_intersect_and_npz_both_ways(tmp_path):
    """union/intersect of each kind equal abyss_tpu's; each package reads
    the .npz files the other writes."""
    k = 9
    ca, va = kmer_canon(rnd(300, 31), k)
    cb, vb = kmer_canon(rnd(300, 32), k)
    size = 1 << 12
    jpairs = []
    for make_j, make_t in (
            (lambda: jb.CountingBloomFilter.create(size, k, 3, 2),
             lambda: tb.CountingBloomFilter.create(size, k, 3, 2, "cpu")),
            (lambda: jb.BitBloomFilter.create(size, k, 3),
             lambda: tb.BitBloomFilter.create(size, k, 3, "cpu")),
            (lambda: jb.CascadingBloomFilter.create(size, k, 3, depth=2),
             lambda: tb.CascadingBloomFilter.create(size, k, 3, depth=2,
                                                    device="cpu"))):
        ja = make_j().insert(jnp.asarray(ca), jnp.asarray(va)).insert(
            jnp.asarray(ca))
        jbb = make_j().insert(jnp.asarray(cb), jnp.asarray(vb))
        ta = make_t().insert(T(ca), T(va)).insert(T(ca))
        tbb = make_t().insert(T(cb), T(vb))
        jpairs.append((jb.union(ja, jbb), tb.union(ta, tbb)))
        jpairs.append((jb.intersect(ja, jbb), tb.intersect(ta, tbb)))
    arrays = {jb.CountingBloomFilter: "counters", jb.BitBloomFilter: "bits",
              jb.CascadingBloomFilter: "levels"}
    for n, (jf, tf) in enumerate(jpairs):
        name = arrays[type(jf)]
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)))
        jpath, tpath = str(tmp_path / f"j{n}.npz"), str(tmp_path / f"t{n}.npz")
        jb.save_filter(jpath, jf)
        tb.save_filter(tpath, tf)
        from_j, from_t = tb.load_filter(jpath, "cpu"), jb.load_filter(tpath)
        assert type(from_t) is type(jf)
        assert type(from_j).__name__ == type(jf).__name__
        for got in (getattr(from_j, name).numpy(),
                    np.asarray(getattr(from_t, name))):
            np.testing.assert_array_equal(got, np.asarray(getattr(jf, name)))
        for attr in ("k", "num_hashes", "threshold"):
            assert getattr(from_j, attr, None) == getattr(jf, attr, None)
        with np.load(jpath) as zj, np.load(tpath) as zt:
            assert sorted(zj.files) == sorted(zt.files)


def test_dense_gather_and_scatter_max_by_sorting():
    """The merge forms of update_mode="sort" equal abyss_tpu's."""
    rng = np.random.default_rng(9)
    dense = rng.integers(0, 256, 5000).astype(np.uint8)
    idx = rng.integers(0, 5000, 20000).astype(np.int32)
    vals = rng.integers(0, 256, 20000).astype(np.uint8)
    np.testing.assert_array_equal(
        tsj.dense_gather_u8(T(dense), T(idx)).numpy(), dense[idx])
    np.testing.assert_array_equal(
        tsj.dense_gather_u8(T(dense), T(idx)).numpy(),
        np.asarray(jsj.dense_gather_u8(jnp.asarray(dense), jnp.asarray(idx))))
    ref = dense.copy()
    np.maximum.at(ref, idx, vals)
    got = tsj.dense_scatter_max_u8(T(dense), T(idx), T(vals)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(jsj.dense_scatter_max_u8(
        jnp.asarray(dense), jnp.asarray(idx), jnp.asarray(vals))))
