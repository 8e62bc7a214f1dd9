"""abyss_tpu_torch.u64: unsigned 64-bit semantics on int64 tensors, held
against numpy uint64 on random words with the high bit set."""

import numpy as np
import pytest
import torch

from abyss_tpu_torch import u64

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def words(seed, n=4000):
    """Random uint64 words: about half with bit 63 set, plus the edge
    values 0, 1, 2^63-1, 2^63 and the all-ones sentinel."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    w[rng.random(n) < 0.5] |= np.uint64(1 << 63)
    edges = np.array([0, 1, (1 << 63) - 1, 1 << 63, 0xFFFFFFFFFFFFFFFF],
                     np.uint64)
    return np.concatenate([w, edges, w[:50]])  # duplicates too


def test_numpy_roundtrip_keeps_bits():
    w = words(0)
    t = u64.from_numpy(w)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(u64.to_numpy(t), w)
    assert u64.from_numpy(np.array([ALL_ONES]))[0].item() == u64.ALL_ONES


@pytest.mark.parametrize("value", [0, 1, (1 << 63) - 1, 1 << 63,
                                   (1 << 64) - 1, 0x9E3779B97F4A7C15])
def test_s64_bit_pattern(value):
    got = np.array([u64.s64(value)], np.int64).view(np.uint64)[0]
    assert int(got) == value


def test_flip_maps_unsigned_order_to_signed():
    w = words(1)
    f = u64.flip(u64.from_numpy(w))
    order = np.argsort(w, kind="stable")
    assert (np.diff(f.numpy()[order]) >= 0).all()
    # the sentinel sorts last after the flip
    assert u64.flip(torch.tensor([u64.ALL_ONES])).item() == (1 << 63) - 1


@pytest.mark.parametrize("n", [0, 1, 27, 30, 31, 33, 63])
def test_srl_is_logical(n):
    w = words(2)
    got = u64.to_numpy(u64.srl(u64.from_numpy(w), n))
    np.testing.assert_array_equal(got, w >> np.uint64(n))


def test_compares_and_min():
    a, b = words(3), words(4)
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    np.testing.assert_array_equal(u64.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(u64.ule(ta, tb).numpy(), a <= b)
    np.testing.assert_array_equal(u64.to_numpy(u64.umin(ta, tb)),
                                  np.minimum(a, b))


def test_sort_and_searchsorted():
    w = words(5)
    vals, idx = u64.usort(u64.from_numpy(w))
    np.testing.assert_array_equal(u64.to_numpy(vals), np.sort(w))
    np.testing.assert_array_equal(w[idx.numpy()], np.sort(w))
    table = np.unique(w)
    q = np.concatenate([words(6, 500), table[::7]])
    got = u64.usearchsorted(u64.from_numpy(table), u64.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(table, q))


def test_wrapping_arithmetic_matches_uint64():
    a, b = words(7), words(8)
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(u64.to_numpy(ta * tb), a * b)
        np.testing.assert_array_equal(u64.to_numpy(ta + tb), a + b)
    np.testing.assert_array_equal(u64.to_numpy(ta << 17),
                                  a << np.uint64(17))
    np.testing.assert_array_equal(u64.to_numpy(ta ^ tb), a ^ b)
