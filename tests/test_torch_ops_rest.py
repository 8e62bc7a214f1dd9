"""The rest of the port's ops against abyss_tpu's, on the CPU: the
spaced-seed masks and masked ntHash (ops/nthash: the golden file of
tests/test_nthash.py and random batches under kmer_pair_mask and
qr_seed_pair masks), the bitonic-merge joins and join_contains
(ops/sort_join, on the cases of tests/test_sorted_filter.py),
build_sorted_filter (ops/sorted_filter) and the general running scan
with reverse= (ops/scan).  Tolerance: exact equality."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abyss_tpu.ops import nthash as jn
from abyss_tpu.ops import scan as js
from abyss_tpu.ops import sort_join as jsj
from abyss_tpu.ops import sorted_filter as jsf
from abyss_tpu_torch import u64
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.ops import nthash as tn
from abyss_tpu_torch.ops import scan as ts
from abyss_tpu_torch.ops import sort_join as tsj
from abyss_tpu_torch.ops import sorted_filter as tsf

torch.set_num_threads(1)

MASK_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                           "maskhash_golden.json")


def _u(t):
    return u64.to_numpy(t)


def test_spaced_seed_patterns_match_jax():
    for k, K in ((24, 8), (31, 11), (40, 12), (64, 20)):
        assert tn.kmer_pair_mask(k, K) == jn.kmer_pair_mask(k, K)
        assert tn.mask_runs(tn.kmer_pair_mask(k, K)) == \
            jn.mask_runs(jn.kmer_pair_mask(k, K))
        if K >= 11:
            assert tn.qr_seed_pair(k, K) == jn.qr_seed_pair(k, K)
            assert tn.mask_runs(tn.qr_seed_pair(k, K)) == \
                jn.mask_runs(jn.qr_seed_pair(k, K))
    for n in (11, 13, 31):
        assert tn.qr_seed(n) == jn.qr_seed(n)
    assert tn.mask_runs("1001100") == ((1, 3), (5, 7))


def test_masked_hashes_match_golden():
    with open(MASK_GOLDEN) as f:
        cases = json.load(f)["cases"]
    for case in cases:
        codes = torch.from_numpy(alphabet.encode(case["seq"])[None, :])
        _, _, canon, _ = tn.masked_kmer_hashes(codes, case["mask"])
        want = np.array([int(x) for x in case["masked"]], dtype=np.uint64)
        np.testing.assert_array_equal(_u(canon)[0][:len(want)], want)


@pytest.mark.parametrize("mask", [jn.kmer_pair_mask(40, 12),
                                  jn.qr_seed_pair(40, 13), "1" * 25,
                                  "0" + "1" * 23 + "0"],
                         ids=["pair", "qr_pair", "solid", "ends"])
def test_masked_hashes_match_jax(mask):
    rng = np.random.default_rng(len(mask) + mask.count("0"))
    codes = rng.integers(0, 4, size=(16, 90), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[3, 60:] = 4
    want = jn.masked_kmer_hashes(jnp.asarray(codes), mask)
    got = tn.masked_kmer_hashes(torch.from_numpy(codes), mask)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(_u(g), np.asarray(w))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if "0" not in mask:     # a solid mask is the plain k-mer hash
        plain = tn.kmer_hashes_plain(torch.from_numpy(codes), len(mask))
        for a, b in zip(plain, got):
            assert torch.equal(a, b)


def _table_queries(rng, M, N):
    table = np.unique(rng.integers(0, 2 << 61, size=max(M, 1),
                                   dtype=np.uint64))[:M]
    table.sort()
    counts = rng.integers(1, 1000, size=len(table)).astype(np.int32)
    q = rng.integers(0, 2 << 61, size=N, dtype=np.uint64)
    if len(table):
        q[:N // 2] = rng.choice(table, size=N // 2)
    return table, counts, q


def test_merge_joins_match_jax():
    """join_counts_merge and join_solid_merge on the shapes of
    tests/test_sorted_filter.py (pow2 padding, empty table, tiny and
    lopsided sizes), and high-bit keys that need the unsigned order."""
    rng = np.random.default_rng(17)
    for M, N in [(4000, 3000), (1, 1), (257, 1), (1, 300), (0, 64),
                 (1024, 1024)]:
        table, counts, q = _table_queries(rng, M, N)
        for hi in (False, True):
            if hi:      # set bit 63: unsigned order differs from signed
                table = np.sort(table | np.uint64(1 << 63))
                q = q | np.uint64(1 << 63)
            jt = jsj.pack_table(jnp.asarray(table), jnp.asarray(counts))
            tt = tsj.pack_table(u64.from_numpy(table),
                                torch.from_numpy(counts))
            np.testing.assert_array_equal(_u(tt), np.asarray(jt))
            tq = u64.from_numpy(q)
            want = np.asarray(jsj.join_counts_merge(jt, jnp.asarray(q)))
            got = tsj.join_counts_merge(tt, tq)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=(M, N))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(
                got.numpy(), tsj.join_counts_packed(tt, tq).numpy())
            for thr in (1, 2, 500):
                want = np.asarray(jsj.join_solid_merge(jt, jnp.asarray(q),
                                                       thr))
                got = tsj.join_solid_merge(tt, tq, thr)
                np.testing.assert_array_equal(got.numpy(), want)


def test_join_contains_matches_jax():
    rng = np.random.default_rng(0)
    table, counts, q = _table_queries(rng, 3000, 4000)
    for thr in (1, 300, 999):
        want = np.asarray(jsj.join_contains(
            jnp.asarray(table), jnp.asarray(counts), jnp.asarray(q), thr))
        got = tsj.join_contains(u64.from_numpy(table),
                                torch.from_numpy(counts),
                                u64.from_numpy(q), thr)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,threshold", [(21, 2), (15, 1), (31, 3)])
def test_build_sorted_filter_matches_jax(k, threshold):
    rng = np.random.default_rng(k)
    seq = rng.integers(0, 4, size=1500).astype(np.uint8)
    batches = [rng.integers(0, 4, size=(32, 80), dtype=np.uint8),
               np.tile(seq[:600], (3, 1)), seq[None]]
    batches[0][rng.random(batches[0].shape) < 0.02] = 4
    want = jsf.build_sorted_filter(batches, k, threshold=threshold)
    got = tsf.build_sorted_filter(batches, k, threshold=threshold,
                                  device="cpu")
    np.testing.assert_array_equal(_u(got.kmers), np.asarray(want.kmers))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(_u(got.packed), np.asarray(want.packed))
    assert (got.k, got.threshold) == (want.k, want.threshold)


def test_running_scans_match_jax():
    rng = np.random.default_rng(0)
    for n in (1, 3, 128, 4097):
        x = rng.integers(0, 1000, size=n).astype(np.int64)
        t = torch.from_numpy(x)
        for rev in (False, True):
            for jf, tf in ((js.running_max, ts.running_max),
                           (js.running_min, ts.running_min),
                           (js.running_sum, ts.running_sum)):
                np.testing.assert_array_equal(
                    tf(t, reverse=rev).numpy(),
                    np.asarray(jf(jnp.asarray(x), reverse=rev)))
            np.testing.assert_array_equal(
                ts.running(t, torch.bitwise_xor, 0, rev).numpy(),
                np.asarray(js.running(jnp.asarray(x), jnp.bitwise_xor, 0,
                                      rev)))
