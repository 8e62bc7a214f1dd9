"""The port's extension engine against the JAX package's, lane by lane,
on the tests/test_extend.py graphs.

Both sides walk the same solid set, built from the same sequences: a
sorted filter probed through the walk table (ext.walk_filter) as the
assembler does, or the counting Bloom filter of tests/test_extend.py's
make_filter (2^18 counters, 4 hashes, threshold 1).  Per-lane status,
length, buffer and head hashes must be identical after fast_extend,
and depths after branch_depths; the stitched walks of extend_forward
must be identical too."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from abyss_tpu.dbg import extend as jext
from abyss_tpu.ops import bloom as jbloom
from abyss_tpu.ops import nthash as jnt
from abyss_tpu.ops import sorted_filter as jsf
from abyss_tpu_torch import u64
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.dbg import extend as text
from abyss_tpu_torch.ops import bloom as tbloom
from abyss_tpu_torch.ops import nthash as tnt
from abyss_tpu_torch.ops import sorted_filter as tsf

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

K = 11


def rnd(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def filters(seqs, k=K, bloom=False):
    """(JAX walk filter, port walk filter) over all k-mers of seqs: the
    sorted filters' walk tables, or (bloom) tests/test_extend.py's
    counting Bloom filter in each package, their counters held equal."""
    if bloom:
        jf = jbloom.CountingBloomFilter.create(1 << 18, k, num_hashes=4,
                                               threshold=1)
        tf = tbloom.CountingBloomFilter.create(1 << 18, k, num_hashes=4,
                                               threshold=1, device="cpu")
        jadd, tadd = None, tf.insert
    else:
        jc = jsf.SortedKmerCounter(k, 1)
        tc = tsf.SortedKmerCounter(k, 1)
        jadd, tadd = jc.add, tc.add
    for s in seqs:
        codes = alphabet.encode(s)[None]
        _, _, canon, valid = jnt.kmer_hashes(jnp.asarray(codes), k)
        if bloom:
            jf = jf.insert(canon, valid)
        else:
            jadd(canon, valid)
        tcanon, tvalid = tnt.canonical_hashes(torch.from_numpy(codes), k)
        tadd(tcanon, tvalid)
    if bloom:
        np.testing.assert_array_equal(tf.counters.numpy(),
                                      np.asarray(jf.counters))
        return jf, tf
    return jext.walk_filter(jc.finalize()), text.walk_filter(tc.finalize())


def case_linear():
    seq = rnd(60, 1)
    return [seq], [seq[:K]], K, {}


def case_chunked():
    seq = rnd(400, 2)
    return [seq], [seq[:K]], K, dict(chunk=64)


def case_fork():
    common = rnd(40, 3)
    return [common + rnd(30, 4), common + rnd(30, 5)], [common[:K]], 5, {}


def case_join():
    common = rnd(40, 6)
    a = rnd(30, 7) + common
    return [a, rnd(30, 8) + common], [a[:K]], 5, {}


def case_false_positive_branch():
    seq = rnd(60, 9)
    pos = 30
    spur = seq[pos - K + 1:pos] + ("A" if seq[pos] != "A" else "C")
    return [seq, spur], [seq[:K]], 8, {}


def case_cycle():
    core = rnd(50, 10)
    return [core + core[:K]], [core[:K]], 5, dict(chunk=32)


def case_many_paths():
    seqs = [rnd(80, 20 + i) for i in range(16)]
    return seqs, [s[:K] for s in seqs], 5, {}


CASES = [case_linear, case_chunked, case_fork, case_join,
         case_false_positive_branch, case_cycle, case_many_paths]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_extend_forward_identical(case):
    check_extend_forward(case, bloom=False)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_extend_forward_identical_bloom(case):
    check_extend_forward(case, bloom=True)


def check_extend_forward(case, bloom):
    seqs, seeds, trim, kw = case()
    jf, tf = filters(seqs, bloom=bloom)
    seed_codes = np.stack([alphabet.encode(s) for s in seeds])
    jbuf, jlen, jst = jext.extend_forward(jf, seed_codes, K, trim=trim, **kw)
    tbuf, tlen, tst = text.extend_forward(tf, seed_codes, K, trim=trim, **kw)
    np.testing.assert_array_equal(tst, np.asarray(jst))
    np.testing.assert_array_equal(tlen, np.asarray(jlen))
    np.testing.assert_array_equal(tbuf, np.asarray(jbuf))


def _same_state(ts, js):
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.length.numpy(), np.asarray(js.length))
    np.testing.assert_array_equal(ts.buf.numpy(), np.asarray(js.buf))
    np.testing.assert_array_equal(u64.to_numpy(ts.f), np.asarray(js.f))
    np.testing.assert_array_equal(u64.to_numpy(ts.r), np.asarray(js.r))
    np.testing.assert_array_equal(ts.has_prev.numpy(),
                                  np.asarray(js.has_prev))


@pytest.mark.parametrize("max_steps", [1, 7, 200])
@pytest.mark.parametrize("warm", [False, True])
def test_fast_extend_and_resolve_lane_state(max_steps, warm):
    check_lane_state(max_steps, warm, bloom=False)


@pytest.mark.parametrize("max_steps,warm", [(7, False), (200, True)])
def test_fast_extend_and_resolve_lane_state_bloom(max_steps, warm):
    check_lane_state(max_steps, warm, bloom=True)


def check_lane_state(max_steps, warm, bloom):
    """Lanes stopping at forks, joins, dead ends and the step budget,
    with and without the warm-restart predecessor."""
    common = rnd(40, 3)
    seqs = [common + rnd(30, 4), common + rnd(30, 5),
            rnd(30, 7) + common[5:], rnd(90, 30)]
    jf, tf = filters(seqs, bloom=bloom)
    seeds = np.stack([alphabet.encode(s[1:K + 1]) for s in seqs])
    prev = np.stack([alphabet.encode(s[0]) for s in seqs])[:, 0] \
        if warm else None
    buf_len = K + 1 + 64
    js = jext.init_state(seeds, buf_len, K, prev_base=prev)
    ts = text.init_state(seeds, buf_len, K, "cpu", prev_base=prev)
    _same_state(ts, js)
    js = jext.fast_extend(jf, js, K, max_steps)
    ts = text.fast_extend(tf, ts, K, max_steps)
    _same_state(ts, js)
    js = jext._resolve(jf, js, K, 5, 16)
    ts = text._resolve(tf, ts, K, 5, 16)
    _same_state(ts, js)


@pytest.mark.parametrize("depth,width", [(3, 4), (8, 16), (11, 2)])
def test_branch_depths_identical(depth, width):
    check_branch_depths(depth, width, bloom=False)


@pytest.mark.parametrize("depth,width", [(8, 16), (11, 2)])
def test_branch_depths_identical_bloom(depth, width):
    check_branch_depths(depth, width, bloom=True)


def check_branch_depths(depth, width, bloom):
    common = rnd(40, 12)
    seqs = [common + rnd(20, 13), common + rnd(5, 14), rnd(50, 15)]
    jf, tf = filters(seqs, bloom=bloom)
    rng = np.random.default_rng(16)
    roots = np.stack(
        [alphabet.encode(s[i:i + K]) for s in seqs for i in (0, 10, 25)]
        + [rng.integers(0, 4, K).astype(np.uint8) for _ in range(7)])
    jr = jnt.hash_base(jnp.asarray(roots), K)
    tr = tnt.hash_base(torch.from_numpy(roots), K)
    jd = jext.branch_depths(jf, jnp.asarray(roots), jr, K, depth, width)
    td = text.branch_depths(tf, torch.from_numpy(roots), tr, K, depth,
                            width)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td.numpy().max() > 0
    np.testing.assert_array_equal(
        text.lookahead_ok(tf, roots, K, depth, width),
        jext.lookahead_ok(jf, roots, K, depth, width))


def test_successor_decision_and_schedule():
    rng = np.random.default_rng(17)
    depths = rng.integers(0, 10, (200, 4))
    present = rng.random((200, 4)) < 0.6
    for trim in (0, 1, 8, 25):
        assert text.doubling_schedule(trim) == jext.doubling_schedule(trim)
        tc, tb = text.successor_decision(depths, present, trim)
        jc, jb = jext.successor_decision(depths, present, trim)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tb, jb)


def test_first_revisit():
    a = np.array([5, 3, 9, 3, 5], np.uint64)
    assert text._first_revisit(a) == jext._first_revisit(a) == 3
    assert text._first_revisit(a[:3]) == -1
