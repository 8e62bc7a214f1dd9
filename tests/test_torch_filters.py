"""The port's filters against the JAX package's: the sorted k-mer
counter and its queries (both sides of the packed/exact switch), the
open-addressing probe table, and the visited bit Bloom filter."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from abyss_tpu.ops import bloom as jbloom
from abyss_tpu.ops import hash_probe as jhp
from abyss_tpu.ops import nthash as jnt
from abyss_tpu.ops import sort_join as jsj
from abyss_tpu.ops import sorted_filter as jsf
from abyss_tpu_torch import u64
from abyss_tpu_torch.ops import bloom as tbloom
from abyss_tpu_torch.ops import hash_probe as thp
from abyss_tpu_torch.ops import nthash as tnt
from abyss_tpu_torch.ops import sort_join as tsj
from abyss_tpu_torch.ops import sorted_filter as tsf

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

K = 15


def read_batches(seed, n=4, B=48, L=90):
    """Reads drawn from a small genome (so k-mers repeat), with N codes
    and padded rows."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    out = []
    for _ in range(n):
        starts = rng.integers(0, 600 - L, B)
        codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
        codes[rng.random((B, L)) < 0.01] = 4
        codes[0, L // 3:] = 4
        out.append(codes)
    return out


def build_both(batches, threshold=2, reduce_every=12 << 20):
    jc = jsf.SortedKmerCounter(K, threshold, reduce_every=reduce_every)
    tc = tsf.SortedKmerCounter(K, threshold, reduce_every=reduce_every)
    for b in batches:
        _, _, canon, valid = jnt.kmer_hashes(jnp.asarray(b), K)
        jc.add(canon, valid)
        tcanon, tvalid = tnt.canonical_hashes(torch.from_numpy(b), K)
        tc.add(tcanon, tvalid)
    return jc.finalize(), tc.finalize()


def queries(jf, seed, n=3000):
    """Table keys, random misses with the high bit set, and misses that
    share a table key's 40-bit prefix (packed-probe false joins)."""
    rng = np.random.default_rng(seed)
    table = np.asarray(jf.kmers)
    hits = rng.choice(table, n // 3)
    misses = rng.integers(0, 1 << 63, n // 3, dtype=np.uint64) | \
        np.uint64(1 << 63)
    twins = rng.choice(table, n // 3) ^ np.uint64(1 << 5)
    return np.concatenate([hits, misses, twins])


@pytest.mark.parametrize("reduce_every", [12 << 20, 1000])
def test_counter_finalize_identical(reduce_every):
    """One reduce, and many reduces with the singleton stash."""
    jf, tf = build_both(read_batches(1), reduce_every=reduce_every)
    assert jf.n == tf.n > 0
    np.testing.assert_array_equal(u64.to_numpy(tf.kmers), np.asarray(jf.kmers))
    np.testing.assert_array_equal(tf.counts.numpy(), np.asarray(jf.counts))
    np.testing.assert_array_equal(u64.to_numpy(tf.packed),
                                  np.asarray(jf.packed))


def test_counter_clamps_at_counter_max():
    codes = np.zeros((1, 40), np.uint8)     # one k-mer, 26 times a batch
    batches = [codes] * 1300                # 33,800 occurrences
    jf, tf = build_both(batches, reduce_every=5000)
    assert int(np.asarray(jf.counts)[0]) == tsf.COUNTER_MAX
    np.testing.assert_array_equal(tf.counts.numpy(), np.asarray(jf.counts))


def test_empty_counter():
    jc = jsf.SortedKmerCounter(K)
    tc = tsf.SortedKmerCounter(K)
    assert jc.finalize().n == tc.finalize("cpu").n == 0


def test_count_and_contains_identical():
    jf, tf = build_both(read_batches(2))
    q = queries(jf, 3)
    mask = np.random.default_rng(4).random(len(q)) < 0.8
    jq, tq = jnp.asarray(q), u64.from_numpy(q)
    for jm, tm in ((None, None), (jnp.asarray(mask), torch.from_numpy(mask))):
        np.testing.assert_array_equal(tf.count(tq, tm).numpy(),
                                      np.asarray(jf.count(jq, jm)))
        np.testing.assert_array_equal(tf.contains(tq, tm).numpy(),
                                      np.asarray(jf.contains(jq, jm)))
        np.testing.assert_array_equal(tf.count_bulk(tq, tm).numpy(),
                                      np.asarray(jf.count_bulk(jq, jm)))
        np.testing.assert_array_equal(tf.contains_bulk(tq, tm).numpy(),
                                      np.asarray(jf.contains_bulk(jq, jm)))
        np.testing.assert_array_equal(
            tf.count_bulk(tq, tm, exact=True).numpy(),
            np.asarray(jf.count_bulk(jq, jm, exact=True)))


def test_packed_probe_false_joins_match():
    """The 40-bit prefix probe joins a key's prefix twin; the exact join
    does not — and each port path answers as its JAX counterpart."""
    jf, tf = build_both(read_batches(5))
    q = queries(jf, 6)
    twins = slice(2 * (len(q) // 3), None)
    tq = u64.from_numpy(q)
    packed = tf.count_bulk(tq).numpy()
    exact = tf.count_bulk(tq, exact=True).numpy()
    assert (packed[twins] > 0).all() and (exact[twins] == 0).all()
    np.testing.assert_array_equal(
        packed, np.asarray(jsj.join_counts_packed(jf.packed, jnp.asarray(q))))


@pytest.mark.parametrize("threshold", [0, 1, 2, 3, 40])
def test_join_solid_packed_with_prefix_groups(threshold):
    """Table rows that share a 40-bit prefix (with counts above and below
    the threshold, in either order) and queries that hit, twin or miss
    them: the port's searched solid bit equals the JAX package's join."""
    rng = np.random.default_rng(threshold)
    base = np.unique(rng.integers(0, 1 << 63, 400, dtype=np.uint64)
                     | (rng.integers(0, 2, 400).astype(np.uint64) << 63))
    base &= ~np.uint64((1 << 24) - 1)
    keys = np.sort(np.concatenate([base | np.uint64(5),
                                   base[::2] | np.uint64(900),
                                   base[::3] | np.uint64(77777)]))
    counts = rng.integers(1, 6, len(keys)).astype(np.int32)
    counts[::7] = 40000                       # clamped to 0x7FFF
    packed_j = jsj.pack_table(jnp.asarray(keys), jnp.asarray(counts))
    packed_t = tsj.pack_table(u64.from_numpy(keys), torch.from_numpy(counts))
    np.testing.assert_array_equal(u64.to_numpy(packed_t),
                                  np.asarray(packed_j))
    q = np.concatenate([keys, base | np.uint64(12345),
                        rng.integers(0, 1 << 63, 300, dtype=np.uint64)])
    got = tsj.join_solid_packed(packed_t, u64.from_numpy(q), threshold)
    want = jsj.join_solid_packed(packed_j, jnp.asarray(q), threshold)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < len(q) or threshold == 0


def test_solid_prefixes_attached_to_filter():
    """contains_bulk builds the solid rows' prefixes once per filter and
    answers from them as the JAX package's packed join does."""
    jf, tf = build_both(read_batches(12))
    assert tf.solid_prefixes is None
    q = queries(jf, 13)
    tq, jq = u64.from_numpy(q), jnp.asarray(q)
    np.testing.assert_array_equal(tf.contains_bulk(tq).numpy(),
                                  np.asarray(jf.contains_bulk(jq)))
    prefixes = tf.solid_prefixes
    np.testing.assert_array_equal(
        prefixes.numpy(), tsj.solid_prefixes(tf.packed, tf.threshold).numpy())
    np.testing.assert_array_equal(tf.contains_bulk(tq[::2]).numpy(),
                                  np.asarray(jf.contains_bulk(jq[::2])))
    assert tf.solid_prefixes is prefixes


def test_bulk_switch_to_exact_join(monkeypatch):
    """At PACKED_MAX_QUERIES (2^23, sorted_filter.py:95-98) and above the
    bulk queries take the exact join; checked here with the switch
    lowered so the batch stays small."""
    assert tsf.PACKED_MAX_QUERIES == 1 << 23
    jf, tf = build_both(read_batches(7))
    q = queries(jf, 8)
    tq, jq = u64.from_numpy(q), jnp.asarray(q)
    monkeypatch.setattr(tsf, "PACKED_MAX_QUERIES", len(q))
    np.testing.assert_array_equal(
        tf.count_bulk(tq).numpy(),
        np.asarray(jf.count_bulk(jq, exact=True)))
    np.testing.assert_array_equal(
        tf.contains_bulk(tq).numpy(),
        np.asarray(jf.count_bulk(jq, exact=True) >= jf.threshold))
    monkeypatch.setattr(tsf, "PACKED_MAX_QUERIES", len(q) + 1)
    np.testing.assert_array_equal(tf.contains_bulk(tq).numpy(),
                                  np.asarray(jf.contains_bulk(jq)))


def test_join_counts_randomized_vs_jax():
    rng = np.random.default_rng(0)
    table = np.unique(rng.integers(0, 1 << 63, 3000, dtype=np.uint64)
                      | (rng.integers(0, 2, 3000, dtype=np.uint64) << 63))
    counts = rng.integers(1, 1000, len(table)).astype(np.int32)
    q = np.concatenate([rng.choice(table, 2000),
                        rng.integers(0, 1 << 63, 2000, dtype=np.uint64)])
    rng.shuffle(q)
    got = tsj.join_counts(u64.from_numpy(table), torch.from_numpy(counts),
                          u64.from_numpy(q))
    want = jsj.join_counts(jnp.asarray(table), jnp.asarray(counts),
                           jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_probe_identical():
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(0, 1 << 63, 5000, dtype=np.uint64)
                     | (rng.integers(0, 2, 5000, dtype=np.uint64) << 63))
    tab_j, tab_t = jhp.build(keys), thp.build(keys)
    np.testing.assert_array_equal(tab_t, tab_j)
    q = np.concatenate([keys[::3], rng.integers(0, 1 << 64, 3000,
                                                dtype=np.uint64)])
    np.testing.assert_array_equal(
        u64.to_numpy(thp.mix64(u64.from_numpy(q))),
        np.asarray(jhp.mix64(jnp.asarray(q))))
    got = thp.ProbeSet(u64.from_numpy(tab_t)).contains(u64.from_numpy(q))
    want = jhp.ProbeSet(jnp.asarray(tab_j)).contains(jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[:len(keys[::3])].all()


def test_solid_table_attached_to_filter():
    jf, tf = build_both(read_batches(10))
    tab = thp.solid_table(tf)
    assert tf.solid_tab is tab and thp.solid_table(tf) is tab
    np.testing.assert_array_equal(u64.to_numpy(tab),
                                  np.asarray(jhp.solid_table(jf)))


def test_bit_bloom_filter_identical():
    size, k, H = 1 << 12, 25, 4
    jv = jbloom.BitBloomFilter.create(size, k, H)
    tv = tbloom.BitBloomFilter.create(size, k, H, device="cpu")
    rng = np.random.default_rng(11)
    for i in range(3):
        canon = rng.integers(0, 1 << 63, 700, dtype=np.uint64) | \
            (rng.integers(0, 2, 700, dtype=np.uint64) << 63)
        mask = rng.random(700) < 0.7
        jv = jv.insert(jnp.asarray(canon), jnp.asarray(mask))
        assert tv.insert(u64.from_numpy(canon), torch.from_numpy(mask)) is tv
        np.testing.assert_array_equal(tv.bits.numpy(), np.asarray(jv.bits))
    assert tv.bits[size].item() == 0 and tv.popcount == jv.popcount
    probe = np.concatenate([canon, rng.integers(0, 1 << 64, 500,
                                                dtype=np.uint64)])
    np.testing.assert_array_equal(
        tv.contains(u64.from_numpy(probe)).numpy(),
        np.asarray(jv.contains(jnp.asarray(probe))))


def test_recommended_sizes_and_pow2_check():
    for budget in (1 << 22, 16 << 20, 64 << 20, 123456789):
        assert tbloom.recommended_sizes(budget) == \
            jbloom.recommended_sizes(budget)
    with pytest.raises(ValueError):
        tbloom.BitBloomFilter.create(1000, 25, device="cpu")
