"""The walk kernels' fourth solidity test, `ShardedSolid` (csrc/walk.cuh),
on the CPU: g++ builds it into csrc/host_harness.cpp (there is no nvcc
here), and its answers, the walk bodies and the look-ahead bodies over
a counting filter split into shards must equal the plain versions over
parallel/distributed.ShardedCountingFilter (count, contains,
dbg/extend.fast_extend_plain, branch_depths_plain), bit for bit."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from abyss_tpu_torch import convert, sim, u64
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.dbg import extend as text
from abyss_tpu_torch.ops import kernels
from abyss_tpu_torch.ops import nthash as tnt
from abyss_tpu_torch.parallel import distributed as tdist
from abyss_tpu_torch.parallel import mesh as tm

from .test_torch_kernel_host import (assert_same, branch_roots,
                                     build_harness, ptr, sequential_probes,
                                     walk_filter)

torch.set_num_threads(1)

P_, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@pytest.fixture(scope="module")
def harness():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = build_harness()
    lib.sharded_solid_host.restype = None
    lib.sharded_solid_host.argtypes = [P_, I64, P_, P_, I64, I, I, I, I]
    lib.walk_sharded_host.restype = None
    lib.walk_sharded_host.argtypes = [P_, I64, I64, P_, P_, P_, P_, P_, P_,
                                      P_, I64, I, I, I, I, I, I64]
    lib.branch_sharded_host.restype = None
    lib.branch_sharded_host.argtypes = [P_, I64, I, P_, P_, P_, I64, I, I,
                                        I, I, I, I, I, P_, P_]
    return lib


def sharded(counters: np.ndarray, n_shard: int, k: int, num_hashes: int,
            threshold: int) -> tdist.ShardedCountingFilter:
    """A ShardedCountingFilter of n_shard shards on a (1 x n_shard) CPU
    mesh, from the global counters [size]."""
    mesh = tm.make_mesh(1, n_shard, [torch.device("cpu")] * n_shard)
    return convert.sharded_filter_from_numpy(mesh, counters, k, threshold,
                                             num_hashes)


def solid_args(f: tdist.ShardedCountingFilter):
    """(kept arrays, ShardedSolid arguments) of the harness for f: the
    shards' host addresses, size, log2(shard_len), k, H, threshold."""
    addrs = np.array([s.data_ptr() for s in f.shards], np.uint64)
    return addrs, [ptr(addrs), f.size, f.shard_len.bit_length() - 1, f.k,
                   f.num_hashes, f.threshold]


@pytest.mark.parametrize("n_shard,num_hashes", [(2, 4), (4, 3), (8, 5)])
def test_sharded_solid_counts_like_the_filter(harness, n_shard,
                                              num_hashes):
    """Random counters (0-4) in shards of a 2^12 filter and random keys,
    among them keys whose hashes land in different shards: the body's
    test at every threshold 0-5 equals ShardedCountingFilter.count's
    min-count against it (so it pins the count), and the count equals
    the unsharded CountingBloomFilter's."""
    rng = np.random.default_rng(n_shard * 10 + num_hashes)
    size, k = 1 << 12, 25
    counters = rng.integers(0, 5, size=size).astype(np.uint8)
    q = rng.integers(0, 1 << 63, size=4000).astype(np.uint64)
    q[:10] = [0, 1, 2, 3, (1 << 63) - 1, 1 << 62, 7, 255, 256, 12345]
    qt = u64.from_numpy(q)
    idx = tdist._indices(qt, k, num_hashes, size).numpy()
    spread = (idx // (size // n_shard))
    assert (spread.min(axis=1) != spread.max(axis=1)).sum() > 100
    sums = set()
    for thr in range(6):
        f = sharded(counters, n_shard, k, num_hashes, thr)
        count = f.count(qt).numpy()
        full, _ = convert.counting_filter_from_numpy(
            np.concatenate([counters, [0]]).astype(np.uint8), k, thr,
            num_hashes, device="cpu")
        np.testing.assert_array_equal(count, full.count(qt).numpy())
        keep, args = solid_args(f)
        got = np.zeros(len(q), np.uint8)
        harness.sharded_solid_host(ptr(q), len(q), ptr(got), *args)
        np.testing.assert_array_equal(got.astype(bool), count >= thr)
        np.testing.assert_array_equal(got.astype(bool),
                                      f.contains(qt).numpy())
        sums.add(int(got.sum()))
    assert len(sums) >= 4 and len(q) in sums   # thresholds 0-5 differ


def sharded_walk_filter(seqs, k, min_cov, n_shard):
    """walk_filter(bloom=True)'s counting filter, split into shards."""
    cbf = walk_filter(seqs, k, min_cov=min_cov, bloom=True)
    return sharded(cbf.counters.numpy()[:cbf.size], n_shard, cbf.k,
                   cbf.num_hashes, cbf.threshold)


@pytest.mark.parametrize("max_steps,n_shard", [(300, 2), (40, 4)])
def test_walk_sharded_body_matches_plain(harness, max_steps, n_shard):
    """Lanes seeded from reads of a genome with repeats and errors: the
    body's lanes equal fast_extend_plain's over the sharded filter
    (tips, bubbles and repeats stop them in several ways)."""
    k = 25
    genome = sim.genome_with_repeats(3000, seed=3, n_repeats=2,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=4)
    seqs = [seq for _, seq, _ in pr.reads1 + pr.reads2]
    wf = sharded_walk_filter(seqs, k, 2, n_shard)
    rng = np.random.default_rng(5)
    picks = rng.choice(len(seqs), size=96, replace=False)
    seeds = np.stack([alphabet.encode(seqs[i][10:10 + k]) for i in picks])
    st0 = text.init_state(seeds, k + 200, k, "cpu")
    s = dict(buf=st0.buf.numpy().copy(), length=st0.length.numpy().copy(),
             f=u64.to_numpy(st0.f).copy(), r=u64.to_numpy(st0.r).copy(),
             status=st0.status.numpy().copy(),
             has_prev=st0.has_prev.numpy().astype(np.uint8))
    seed = u64.to_numpy(st0.seed_canon).copy()
    keep, args = solid_args(wf)
    P, BUF = s["buf"].shape
    harness.walk_sharded_host(
        ptr(s["buf"]), P, BUF, ptr(s["length"]), ptr(s["f"]), ptr(s["r"]),
        ptr(s["status"]), ptr(seed), ptr(s["has_prev"]), *args, k, max_steps)
    launched = dict(kernels.launches)
    st = text.fast_extend(wf, st0._replace(buf=st0.buf.clone()), k,
                          max_steps)
    assert kernels.launches == launched    # CPU: plain version
    assert len(set(st.status.tolist())) >= 3
    assert_same(s, st)


@pytest.mark.parametrize("k,max_depth,width,n_shard", [
    (25, 25, 16, 2), (11, 30, 4, 4), (11, 11, 2, 8)])
def test_branch_sharded_body_matches_plain(harness, k, max_depth, width,
                                           n_shard):
    """The look-ahead body's depths over the sharded filter equal
    branch_depths_plain's, and its probes the sequential count."""
    seqs, roots = branch_roots(k, max_depth)
    wf = sharded_walk_filter(seqs, k, 1, n_shard)
    N = roots.shape[0]
    t = torch.from_numpy(roots)
    hashes = tnt.hash_base(t, k)
    f0, r0 = u64.to_numpy(hashes[0]).copy(), u64.to_numpy(hashes[1]).copy()
    keep, args = solid_args(wf)
    depth = np.zeros(N, np.int32)
    probes = np.zeros(N, np.int64)
    harness.branch_sharded_host(ptr(roots), N, k, ptr(f0), ptr(r0), *args,
                                max_depth, width, max(max_depth - k, 0),
                                ptr(depth), ptr(probes))
    plain = text.branch_depths(wf, t, hashes, k, max_depth, width).numpy()
    assert len(set(plain.tolist())) >= 3
    np.testing.assert_array_equal(depth, plain)
    seq, _ = sequential_probes(wf, t, hashes, k, max_depth, width)
    np.testing.assert_array_equal(probes, seq.numpy())


def test_sharded_wrappers_refuse_cpu_shards():
    """On CPU tensors the walk wrappers raise for a sharded filter and
    count nothing; extend dispatches it to the kernels on a card."""
    k = 5
    st = text.init_state(np.zeros((4, k), np.uint8), k + 8, k, "cpu")
    f = sharded(np.zeros(1024, np.uint8), 2, k, 4, 2)
    assert text._kernel_solid("fast_extend", f) is f
    launched = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.walk(f, st.buf, st.length, st.f, st.r, st.status,
                     st.seed_canon, st.has_prev, k, 10)
    with pytest.raises(ValueError):
        kernels.branch(f, st.buf[:, :k].contiguous(), st.f, st.r, k, 5, 4)
    assert kernels.launches == launched
    assert {"walk_sharded", "branch_sharded"} <= set(kernels.launches)
