"""The port's Konnector against abyss_tpu's on error-laden reads, on
the CPU: pairs whose BFS levels race for hash slots, under both search
engines and on the sorted and counting-Bloom filters; the device
search's pulled sides, edges, cost, fail, meets and ncom on one chunk,
the port fed the JAX call's own inputs; and a chunk whose frozen
stores overflow and regrow.  Results must be equal field for field.
"""

import numpy as np
import pytest
import torch

from abyss_tpu import sim
from abyss_tpu.core import alphabet
from abyss_tpu.gap import konnector as J
from abyss_tpu.gap import konnector_dev as JD
from abyss_tpu_torch import convert
from abyss_tpu_torch.gap import konnector_dev as TD
from tests.test_torch_konnector import KG, both, engine, filters  # noqa: F401

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# error-laden reads: hash-slot races inside BFS levels, many chunks


def _error_pairs(seed, n_pairs, glen=3000, frag=350, err=0.01):
    rng = np.random.default_rng(seed)
    g = sim.random_genome(glen, seed=seed)
    g = g + g[500:900] + sim.random_genome(300, seed=seed + 1)  # a repeat
    pairs, reads = [], []
    for _ in range(n_pairs):
        s = int(rng.integers(0, len(g) - frag))
        f = np.frombuffer(g[s:s + frag].encode(), np.uint8).copy()
        errs = rng.random(frag) < err
        f[errs] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                                errs.sum())]
        f = f.tobytes().decode()
        if rng.random() < 0.5:
            f = alphabet.revcomp(f)
        pairs.append((f[:100], alphabet.revcomp(f[-100:])))
        reads += [f[:100], f[-100:]]
    return reads, pairs


@pytest.mark.parametrize("kind,threshold", [("sorted", 2), ("bloom", 2),
                                            ("sorted", 1)])
def test_error_laden_pairs_match_jax(kind, threshold, engine):
    reads, pairs = _error_pairs(7, 160)
    jf, tf = filters(kind, reads, KG, threshold=threshold)
    got = both(jf, tf, pairs[:64], KG, {"max_paths": 4}, chunk=32)
    assert len({r.reason for r in got}) >= 2


def test_device_search_matches_jax(monkeypatch):
    """konnector_dev.search on one chunk, the port fed the JAX call's
    own inputs: pulled sides, edges, cost, fail, meets and ncom."""
    reads, pairs = _error_pairs(8, 120)
    pairs = pairs[:60]
    jf, _ = filters("sorted", reads, KG, threshold=2)
    calls = []
    real = JD.search

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, out))
        return out

    monkeypatch.setattr(JD, "search", spy)
    J.connect_pairs_full(jf, pairs, KG, J.ConnectPairsParams(max_paths=3))
    assert len(calls) == 1
    args, want = calls[0]
    tf, _ = convert.from_numpy_state(np.array(jf.kmers),
                                     np.array(jf.counts), KG,
                                     jf.threshold, device="cpu")
    got = TD.search(tf, *args[1:])
    assert want is not None and got is not None
    Fw, Rw, cw_, fw, mw, nw = want
    Fg, Rg, cg, fg, mg, ng = got
    for a, b in ((Fw, Fg), (Rw, Rg)):
        for f in ("pair", "canon", "depth", "words", "e_child", "e_parent"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)).astype(np.int64)
                if f != "canon" and f != "words" else getattr(a, f),
                np.asarray(getattr(b, f)).astype(np.int64)
                if f != "canon" and f != "words" else getattr(b, f),
                err_msg=f)
    np.testing.assert_array_equal(cw_, cg)
    np.testing.assert_array_equal(fw, fg)
    np.testing.assert_array_equal(nw, ng)
    assert mw == mg and len(mg) > 0


def test_device_search_regrow_matches_jax(monkeypatch):
    """A chunk whose frozen stores overflow: the port's regrow path (grow
    + replayed merge) must give the JAX package's answer."""
    grown = []
    real = TD._grow_side
    monkeypatch.setattr(TD, "_grow_side",
                        lambda *a, **kw: grown.append(1) or real(*a, **kw))
    reads, pairs = _error_pairs(9, 100, glen=6000, frag=600)
    jf, tf = filters("sorted", reads, KG, threshold=1)
    both(jf, tf, pairs, KG, {"max_paths": 3, "max_frag": 900}, chunk=100)
    assert grown
