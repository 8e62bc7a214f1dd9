"""The port's FM-index (align/fmindex.py) against abyss_tpu's, on the
CPU: every field of FMIndex.build (bwt, C, occ_ck, sa_vals, sa_mask,
sa_rank) identical on the host branch and on the device branch (forced
at small size by lowering _DEVICE_MIN in both modules for the test), the
suffix arrays of texts with long repeats, count and locate on the cases
of tests/test_small_tools.py::test_fmindex_count_locate, and the
unique terminal sentinel that prefix doubling needs.  The 3 Mbp build of
tests/test_small_tools.py is not repeated here: chip_smoke.py's `tools`
phase builds the 4.6 Mbp genome's index on the card.  Tolerance: exact
equality."""

import numpy as np
import pytest
import torch

from abyss_tpu.align import fmindex as jfm
from abyss_tpu_torch import sim
from abyss_tpu_torch.align import fmindex as tfm
from abyss_tpu_torch.core import alphabet

torch.set_num_threads(1)

FIELDS = ("bwt", "C", "occ_ck", "sa_vals", "sa_mask", "sa_rank")


@pytest.fixture(params=["host", "device"])
def branch(request, monkeypatch):
    if request.param == "device":
        monkeypatch.setattr(jfm, "_DEVICE_MIN", 1)
        monkeypatch.setattr(tfm, "_DEVICE_MIN", 1)
    return request.param


def _texts():
    g = sim.random_genome(2000, seed=115)
    yield "random_2000", alphabet.encode(g)
    yield "acgt_x3", alphabet.encode("ACGTACGTACGT")
    yield "repeats", alphabet.encode(g[:300] * 3 + g[300:700] + g[:300])
    yield "poly_a", alphabet.encode("A" * 97 + "C")
    yield "one_base", alphabet.encode("G")


@pytest.mark.parametrize("name,codes", list(_texts()),
                         ids=[n for n, _ in _texts()])
def test_build_matches_jax(branch, name, codes):
    a = jfm.FMIndex.build(codes)
    b = tfm.FMIndex.build(codes, device="cpu")
    for f in FIELDS:
        want, got = getattr(a, f), getattr(b, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (b.sa_rate, b.n) == (a.sa_rate, a.n)


def test_suffix_arrays_match_jax():
    """Both of the port's builders against both of abyss_tpu's, on texts
    of sentinel-terminated codes 1..4."""
    rng = np.random.default_rng(6)
    for n in (2, 50, 777):
        for alphabet_size in (1, 4):
            text = np.concatenate([rng.integers(1, alphabet_size + 1, n),
                                   [0]]).astype(np.int64)
            want = jfm._suffix_array_host(text)
            np.testing.assert_array_equal(jfm._suffix_array_device(text),
                                          want)
            np.testing.assert_array_equal(tfm._suffix_array_host(text), want)
            np.testing.assert_array_equal(
                tfm._suffix_array_device(text, "cpu"), want)
            # it is the suffix array
            suffixes = [tuple(text[i:]) for i in range(len(text))]
            assert list(want) == sorted(range(len(text)),
                                        key=lambda i: suffixes[i])


def test_device_suffix_array_needs_a_unique_terminal_sentinel():
    with pytest.raises(AssertionError, match="sentinel"):
        tfm._suffix_array_device(np.array([1, 0, 2, 0]), "cpu")
    with pytest.raises(AssertionError, match="sentinel"):
        tfm._suffix_array_device(np.array([1, 2, 3]), "cpu")


def test_count_and_locate(branch):
    genome = sim.random_genome(2000, seed=115)
    codes = alphabet.encode(genome)
    fm = tfm.FMIndex.build(codes, device="cpu")
    ref = jfm.FMIndex.build(codes)
    rng = np.random.default_rng(116)
    for _ in range(10):
        p = int(rng.integers(0, 1950))
        pat = codes[p:p + 40]
        assert fm.count(pat) >= 1
        assert p in fm.locate(pat)
        assert fm.backward_search(pat) == ref.backward_search(pat)
        assert fm.locate(pat) == ref.locate(pat)
    other = alphabet.encode(sim.random_genome(40, seed=117))
    assert fm.count(other) == 0
    fm2 = tfm.FMIndex.build(alphabet.encode("ACGTACGTACGT"), device="cpu")
    assert fm2.count(alphabet.encode("ACGT")) == 3
    assert fm2.locate(alphabet.encode("ACGT")) == [0, 4, 8]


def test_build_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.FMIndex.build(alphabet.encode("ACGT"))
