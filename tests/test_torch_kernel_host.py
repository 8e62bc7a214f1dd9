"""The CUDA kernels' own arithmetic, checked on the CPU.

There is no nvcc here, so g++ compiles the kernels' per-thread bodies
(csrc/nthash.cuh, csrc/walk.cuh) into csrc/host_harness.cpp, which loops
them over the grids nthash.cu and walk.cu launch.  The results must be
bit-identical to the plain PyTorch versions the kernels replace on the
card: ops/nthash.kmer_hashes_plain, dbg/extend.fast_extend_plain and
dbg/extend.branch_depths_plain."""

import ctypes
import os
import shutil

import numpy as np
import pytest
import torch

from abyss_tpu_torch import sim, u64
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.dbg import extend as text
from abyss_tpu_torch.native import build_library
from abyss_tpu_torch.ops import kernels
from abyss_tpu_torch.ops import nthash as tnt
from abyss_tpu_torch.ops import sorted_filter as tsf

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

P_ = ctypes.c_void_p
I64 = ctypes.c_int64


@pytest.fixture(scope="module")
def harness():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src = os.path.join(kernels.CSRC, "host_harness.cpp")
    so = build_library(
        "host_harness", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"],
        [src], deps=[os.path.join(kernels.CSRC, h)
                     for h in ("nthash.cuh", "walk.cuh")])
    lib = ctypes.CDLL(so)
    lib.nthash_host.restype = None
    lib.nthash_host.argtypes = [P_, I64, I64, ctypes.c_int, P_, P_, P_, P_]
    lib.branch_host.restype = None
    lib.branch_host.argtypes = [P_, I64, ctypes.c_int, P_, P_, P_, I64,
                                ctypes.c_int, ctypes.c_int, P_, P_, P_,
                                ctypes.c_int, P_, P_]
    lib.walk_host.restype = None
    lib.walk_host.argtypes = [P_, I64, I64, P_, P_, P_, P_, P_, P_, P_, I64,
                              ctypes.c_int, I64]
    return lib


def ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def reads(seed, B, L):
    """uint8 [B, L]: random bases, N codes (4 and 9), padded rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[1, L // 2:] = 4
    codes[2] = 4
    codes[3, L // 3] = 9
    return codes


@pytest.mark.parametrize("k,L", [(5, 160), (25, 700), (31, 512), (96, 160),
                                 (1, 3)])
def test_nthash_body_matches_plain(harness, k, L):
    """Rows longer than one tile (TILE = 512 windows) and shorter; k from
    1 to 96."""
    codes = reads(k + L, 5, L)
    W = L - k + 1
    canon = np.zeros((5, W), np.uint64)
    valid = np.zeros((5, W), np.uint8)
    fwd = np.zeros((5, W), np.uint64)
    rev = np.zeros((5, W), np.uint64)
    harness.nthash_host(ptr(codes), 5, L, k, ptr(canon), ptr(valid),
                        ptr(fwd), ptr(rev))
    pf, pr, pc, pv = tnt.kmer_hashes_plain(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(valid.astype(bool), pv.numpy())
    np.testing.assert_array_equal(canon, u64.to_numpy(pc))
    np.testing.assert_array_equal(fwd, u64.to_numpy(pf))
    np.testing.assert_array_equal(rev, u64.to_numpy(pr))


def walk_filter(seqs, k, min_cov=1):
    ctr = tsf.SortedKmerCounter(k, min_cov)
    for s in seqs:
        codes = torch.from_numpy(alphabet.encode(s)[None])
        ctr.add(*tnt.canonical_hashes(codes, k))
    return text.walk_filter(ctr.finalize("cpu"))


def harness_walk(harness, wf, st, k, max_steps):
    """Run walk_host on numpy copies of a CPU state; returns the copies."""
    s = dict(buf=st.buf.numpy().copy(), length=st.length.numpy().copy(),
             f=u64.to_numpy(st.f).copy(), r=u64.to_numpy(st.r).copy(),
             status=st.status.numpy().copy(),
             has_prev=st.has_prev.numpy().astype(np.uint8))
    seed = u64.to_numpy(st.seed_canon).copy()
    tab = u64.to_numpy(wf.tab).copy()
    P, BUF = s["buf"].shape
    harness.walk_host(ptr(s["buf"]), P, BUF, ptr(s["length"]), ptr(s["f"]),
                      ptr(s["r"]), ptr(s["status"]), ptr(seed),
                      ptr(s["has_prev"]), ptr(tab), len(tab) - 8, k,
                      max_steps)
    return s


def assert_same(s, st):
    np.testing.assert_array_equal(s["status"], st.status.numpy())
    np.testing.assert_array_equal(s["length"], st.length.numpy())
    np.testing.assert_array_equal(s["buf"], st.buf.numpy())
    np.testing.assert_array_equal(s["f"], u64.to_numpy(st.f))
    np.testing.assert_array_equal(s["r"], u64.to_numpy(st.r))
    np.testing.assert_array_equal(s["has_prev"].astype(bool),
                                  st.has_prev.numpy())


def rnd(n, seed):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.mark.parametrize("max_steps", [1, 7, 200])
@pytest.mark.parametrize("warm", [False, True])
def test_walk_body_matches_plain_on_forks(harness, max_steps, warm):
    """Forks, joins, a dead end and a cycle; lanes stop at every status."""
    k = 11
    common = rnd(40, 3)
    core = rnd(50, 10)
    seqs = [common + rnd(30, 4), common + rnd(30, 5),
            rnd(30, 7) + common[5:], rnd(90, 30), core + core[:k]]
    wf = walk_filter(seqs, k)
    seeds = np.stack([alphabet.encode(s[1:k + 1]) for s in seqs])
    prev = np.stack([alphabet.encode(s[0]) for s in seqs])[:, 0] \
        if warm else None
    st = text.init_state(seeds, k + 1 + 64, k, "cpu", prev_base=prev)
    s = harness_walk(harness, wf, st, k, max_steps)
    st = text.fast_extend(wf, st, k, max_steps)
    assert_same(s, st)


@pytest.mark.parametrize("max_steps,buf_extra", [(64, 64), (500, 300)])
def test_walk_body_matches_plain_on_reads(harness, max_steps, buf_extra):
    """Lanes seeded from simulated reads of a genome with repeats and
    errors: tips, bubbles and repeats stop them NEED_F / NEED_B, and a
    short buffer stops the rest CHUNK_LIMIT."""
    k = 25
    genome = sim.genome_with_repeats(3000, seed=3, n_repeats=2,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=4)
    seqs = [seq for _, seq, _ in pr.reads1 + pr.reads2]
    wf = walk_filter(seqs, k, min_cov=2)
    rng = np.random.default_rng(5)
    picks = rng.choice(len(seqs), size=96, replace=False)
    seeds = np.stack([alphabet.encode(seqs[i][10:10 + k]) for i in picks])
    st = text.init_state(seeds, k + buf_extra, k, "cpu")
    launched = kernels.launches["walk"]
    s = harness_walk(harness, wf, st, k, max_steps)
    st = text.fast_extend(wf, st, k, max_steps)
    assert kernels.launches["walk"] == launched    # CPU: plain version
    assert len(set(st.status.tolist())) >= 3
    assert_same(s, st)


def harness_branch(harness, wf, roots, k, max_depth, width):
    """(depth, probes) of branch_host on numpy roots."""
    N = roots.shape[0]
    f0, r0 = tnt.hash_base(torch.from_numpy(roots), k)
    f0, r0 = u64.to_numpy(f0).copy(), u64.to_numpy(r0).copy()
    tab = u64.to_numpy(wf.tab).copy()
    H = max(max_depth - k, 0)
    fs = np.zeros(2 * width * N, np.uint64)
    rs = np.zeros_like(fs)
    hist = np.zeros(max(2 * width * H * N, 1), np.uint8)
    depth = np.zeros(N, np.int32)
    probes = np.zeros(N, np.int64)
    harness.branch_host(ptr(roots), N, k, ptr(f0), ptr(r0), ptr(tab),
                        len(tab) - 8, max_depth, width, ptr(fs), ptr(rs),
                        ptr(hist), H, ptr(depth), ptr(probes))
    return depth, probes


@pytest.mark.parametrize("k,max_depth,width", [
    (25, 25, 16), (25, 5, 16), (11, 11, 2), (11, 30, 4), (11, 40, 16)])
def test_branch_body_matches_plain(harness, k, max_depth, width):
    """Roots inside reads and one base off them (tips and bubbles of
    read errors), some with an N, and roots near the genome's end (every
    depth up to max_depth); depths past k need the frontier's appended
    bases (max_depth > k)."""
    genome = sim.genome_with_repeats(3000, seed=6, n_repeats=2,
                                     repeat_len=150)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=7)
    seqs = [seq for _, seq, _ in pr.reads1 + pr.reads2]
    # every read k-mer solid: error k-mers make tips and bubbles, and
    # the genome's own k-mers reach its very end
    wf = walk_filter(seqs + [genome], k, min_cov=1)
    rng = np.random.default_rng(8)
    roots = [alphabet.encode(seqs[i][20:20 + k])
             for i in rng.choice(len(seqs), 150, replace=False)]
    # roots d bases before the genome's end reach depth about d
    g = alphabet.encode(genome)
    roots += [g[len(g) - k - d:len(g) - d] for d in range(max_depth + 2)]
    roots = np.stack(roots)
    roots[:150:3, -1] = (roots[:150:3, -1] + 1) % 4
    roots[5, 3] = 4
    depth, probes = harness_branch(harness, wf, roots, k, max_depth, width)
    t = torch.from_numpy(roots)
    launched = kernels.launches["branch"]
    plain = text.branch_depths(wf, t, tnt.hash_base(t, k), k, max_depth,
                               width).numpy()
    assert kernels.launches["branch"] == launched    # CPU: plain version
    assert len(set(plain.tolist())) >= 3
    np.testing.assert_array_equal(depth, plain)
    # a probe at least for each step run, at most 4 per frontier k-mer
    assert (probes >= np.minimum(depth + 1, max_depth)).all()
    assert (probes <= 4 * width * max_depth).all()


def test_walk_wrappers_refuse_cpu_tensors():
    """On CPU tensors the walk kernels' wrappers raise and count
    nothing."""
    k = 5
    st = text.init_state(np.zeros((4, k), np.uint8), k + 8, k, "cpu")
    tab = torch.full((1024 + 8,), -1, dtype=torch.int64)
    launched = kernels.launches["walk"]
    with pytest.raises(ValueError):
        kernels.walk(tab, st.buf, st.length, st.f, st.r, st.status,
                     st.seed_canon, st.has_prev, k, 10)
    assert kernels.launches["walk"] == launched
    launched = kernels.launches["branch"]
    with pytest.raises(ValueError):
        kernels.branch(tab, st.buf[:, :k].contiguous(), st.f, st.r, k, 5, 4)
    assert kernels.launches["branch"] == launched
