"""The CUDA kernels' own arithmetic, checked on the CPU.

There is no nvcc here, so g++ compiles the kernels' per-thread bodies
(csrc/nthash.cuh, csrc/walk.cuh, csrc/scatter_max.cuh) into
csrc/host_harness.cpp, which loops them over the grids nthash.cu,
walk.cu and scatter_max.cu launch.  The results must be bit-identical
to the plain PyTorch versions the kernels replace on the card:
ops/nthash.kmer_hashes_plain, dbg/extend.fast_extend_plain and
dbg/extend.branch_depths_plain (in the walk table and in a counting
Bloom filter), and ops/scatter_max.scatter_max_u8_plain."""

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
from abyss_tpu_torch.ops import bloom as tbloom
from abyss_tpu_torch.ops import kernels
from abyss_tpu_torch.ops import nthash as tnt
from abyss_tpu_torch.ops import scatter_max as tsm
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
    return build_harness()


def build_harness():
    """Build csrc/host_harness.cpp with g++ and bind its functions."""
    src = os.path.join(kernels.CSRC, "host_harness.cpp")
    so = build_library(
        "host_harness", ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"],
        [src], deps=[os.path.join(kernels.CSRC, h)
                     for h in ("nthash.cuh", "walk.cuh", "scatter_max.cuh")])
    lib = ctypes.CDLL(so)
    lib.nthash_host.restype = None
    lib.nthash_host.argtypes = [P_, I64, I64, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, P_, P_, P_, P_]
    lib.branch_host.restype = None
    lib.branch_host.argtypes = [P_, I64, ctypes.c_int, P_, P_, P_, I64,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                P_, P_]
    lib.walk_host.restype = None
    lib.walk_host.argtypes = [P_, I64, I64, P_, P_, P_, P_, P_, P_, P_, I64,
                              ctypes.c_int, I64]
    I = ctypes.c_int
    lib.branch_bloom_host.restype = None
    lib.branch_bloom_host.argtypes = [P_, I64, I, P_, P_, P_, I64, I, I, I,
                                      I, I, I, P_, P_]
    lib.walk_bloom_host.restype = None
    lib.walk_bloom_host.argtypes = [P_, I64, I64, P_, P_, P_, P_, P_, P_, P_,
                                    I64, I, I, I, I, I64]
    lib.scatter_max_host.restype = None
    lib.scatter_max_host.argtypes = [P_, I64, P_, P_, I64]
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


def harness_nthash(harness, codes, k, layout, strands=True):
    """(canon, valid, fwd, rev) of nthash_host on numpy codes in a layout
    (rows, seg); fwd/rev None unless `strands`."""
    B, L = codes.shape
    W = L - k + 1
    canon = np.zeros((B, W), np.uint64)
    valid = np.zeros((B, W), np.uint8)
    fwd = np.zeros((B, W), np.uint64) if strands else None
    rev = np.zeros((B, W), np.uint64) if strands else None
    harness.nthash_host(ptr(codes), B, L, k, *layout, ptr(canon), ptr(valid),
                        ptr(fwd) if strands else None,
                        ptr(rev) if strands else None)
    return canon, valid, fwd, rev


def assert_nthash_plain(codes, k, canon, valid, fwd, rev):
    """The kernel's outputs (numpy, fwd/rev may be None) equal
    kmer_hashes_plain's everywhere, invalid windows too."""
    pf, pr, pc, pv = tnt.kmer_hashes_plain(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(valid.astype(bool), pv.numpy())
    np.testing.assert_array_equal(canon, u64.to_numpy(pc))
    if fwd is not None:
        np.testing.assert_array_equal(fwd, u64.to_numpy(pf))
        np.testing.assert_array_equal(rev, u64.to_numpy(pr))


@pytest.mark.parametrize("k,L", [(5, 160), (25, 700), (31, 512), (96, 160),
                                 (1, 3)])
def test_nthash_body_matches_plain(harness, k, L):
    """Rows of one window to several hundred, packed or tiled as the
    wrapper picks; k from 1 to 96."""
    codes = reads(k + L, 5, L)
    layout = kernels.nthash_layout(5, L, k, kernels.nthash_geometry(harness),
                                   H100_SMS)
    assert_nthash_plain(codes, k, *harness_nthash(harness, codes, k, layout))


# (B, L, k) of the layout cases: hash_base's [N, k] rows (W = 1), rows
# of a few windows, one padded sequence of 2^m bases
# (kmer_hashes_padded, a row spread over several blocks), the main
# path's padded reads, rows of two tiles (the second ragged), k past a
# strip with W not a multiple of it, and a k whose bases take a block
# past 48 KB of shared memory
NTHASH_SHAPES = {"rows_k31": (70, 31, 31), "rows_k1": (9, 1, 1),
                 "short_w10": (50, 40, 31), "b1_len64": (1, 64, 31),
                 "b1_len2048": (1, 2048, 31), "b1_len4096": (1, 4096, 31),
                 "main": (41, 512, 31),
                 "two_tiles": (3, 5000, 25), "k96": (6, 300, 96),
                 "k40_w18": (5, 57, 40), "k9000": (2, 9100, 9000)}


def layout_codes(B, L, seed):
    """uint8 [B, L] codes for the layout cases: random bases with 2% N
    codes (4 and 9), and rows that are: 150 bases padded to L, all
    padding, padding first, a run of 70 N codes inside, a random length
    padded."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = rng.choice(np.array([4, 9], np.uint8))
    special = [lambda r: r.__setitem__(slice(150, None), 4),
               lambda r: r.__setitem__(slice(None), 4),
               lambda r: r.__setitem__(slice(None, L // 3), 4),
               lambda r: r.__setitem__(slice(L // 4, L // 4 + 70), 9)]
    for row, fill in zip(codes, special):
        fill(row)
    for row in codes[len(special):]:
        row[rng.integers(0, L + 1):] = 4
    return codes


# multiprocessors of the card the layout choice is tested for
H100_SMS = 132


def nthash_layouts(B, L, k, geometry, sms=H100_SMS):
    """The wrapper's layout on a card of `sms` multiprocessors and two
    tile layouts: tiles of TILE windows, and of 37 (a segment that is not
    a multiple of a strip)."""
    W = L - k + 1
    threads, strip, _ = geometry
    return {"picked": kernels.nthash_layout(B, L, k, geometry, sms),
            "tile": (1, min(W, threads * strip)), "tile37": (1, min(W, 37))}


@pytest.mark.parametrize("layout", ["picked", "tile", "tile37"])
@pytest.mark.parametrize("shape", list(NTHASH_SHAPES))
def test_nthash_body_layouts(harness, shape, layout):
    """Every layout case in the wrapper's layout and in tile layouts, with
    strips that are all padding, partly padding, or hold interior N
    codes; the tile37 runs without fwd/rev, as the counting path asks."""
    B, L, k = NTHASH_SHAPES[shape]
    geometry = kernels.nthash_geometry(harness)
    lay = nthash_layouts(B, L, k, geometry)[layout]
    codes = layout_codes(B, L, seed=B * L + k)
    out = harness_nthash(harness, codes, k, lay, strands=layout != "tile37")
    assert_nthash_plain(codes, k, *out)


# (B, L, k) of the ntHash launches the pe pipeline adds after stage 1:
# the mapper's index chunks (one row of 2^18 codes, contigs separated
# by code 4), its read batches trimmed to 160 columns, RResolver's read
# batches and its r-mer windows at r = 91 (default_r of 150 bp reads);
# the card's batches have 16384 rows, fewer here
PE_SHAPES = {"index_chunk": (1, 1 << 18, 32), "reads160": (300, 160, 32),
             "rmer_reads": (64, 256, 91), "rmer_windows": (50, 91, 91)}


def pe_codes(name, seed):
    """uint8 codes of a PE_SHAPES shape as the pipeline makes them: the
    index chunk holds contigs of 100-5000 bases with a separator after
    each, padded at the end; reads are 150 bases with rare N codes,
    padded, the last rows all padding (a batch's tail); windows are
    whole."""
    B, L, k = PE_SHAPES[name]
    rng = np.random.default_rng(seed)
    if name == "index_chunk":
        parts, n = [], 0
        while n < L - 3000:
            c = rng.integers(0, 4, int(rng.integers(100, 5000)), np.uint8)
            parts += [c, np.full(1, 4, np.uint8)]
            n += len(c) + 1
        codes = np.full((1, L), 4, np.uint8)
        big = np.concatenate(parts)[:L]
        codes[0, :len(big)] = big
        return codes
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.002] = 4
    if name != "rmer_windows":
        codes[:, 150:] = 4
        codes[-5:] = 4
    return codes


@pytest.mark.parametrize("layout", ["picked", "tile", "tile37"])
@pytest.mark.parametrize("shape", list(PE_SHAPES))
def test_nthash_body_pe_shapes(harness, shape, layout):
    """The pe pipeline's new ntHash shapes, in the wrapper's layout and in
    tile layouts, bit for bit against the plain version (with the strand
    hashes the mapper and RResolver ask for, except in tile37)."""
    B, L, k = PE_SHAPES[shape]
    lay = nthash_layouts(B, L, k, kernels.nthash_geometry(harness))[layout]
    codes = pe_codes(shape, seed=L + k)
    out = harness_nthash(harness, codes, k, lay, strands=layout != "tile37")
    assert_nthash_plain(codes, k, *out)


@pytest.mark.parametrize("B,L,k,layout", [
    (4096, 31, 31, (256, 1)), (4096, 512, 31, (8, 482)),
    (4096, 40, 31, (204, 10)), (3, 512, 31, (3, 482)),
    (1, 64, 31, (1, 34)), (1, 1024, 31, (1, 512)), (1, 2048, 31, (1, 512)),
    (1, 16384, 31, (1, 512)), (1, 1 << 21, 31, (1, 4096)),
    (8, 5000, 25, (1, 512)), (40, 5000, 25, (1, 1024)),
    (132, 5000, 25, (1, 4096)), (8, 3000, 2900, (2, 101)),
    (1, 1 << 18, 32, (1, 1024)), (16384, 160, 32, (28, 129)),
    (16384, 256, 91, (23, 166)), (5000, 91, 91, (90, 1))])
def test_nthash_layout_choice(B, L, k, layout):
    """Short rows are packed several to a block; long rows are tiled, in
    smaller tiles (down to a warp's 32 strips) while the grid has fewer
    blocks than the card has multiprocessors."""
    geom = (256, 16, 8192)
    assert kernels.nthash_layout(B, L, k, geom, H100_SMS) == layout


def walk_filter(seqs, k, min_cov=1, bloom=False):
    """The walk filter of seqs' k-mers: the sorted filter's walk table,
    or (bloom=True) a counting Bloom filter small enough that false
    positives make extra branches (a few percent on the read sets)."""
    if bloom:
        f = tbloom.CountingBloomFilter.create(1 << 17, k, 3, min_cov, "cpu")
        add = f.insert
    else:
        ctr = tsf.SortedKmerCounter(k, min_cov)
        add = ctr.add
    for s in seqs:
        codes = torch.from_numpy(alphabet.encode(s)[None])
        add(*tnt.canonical_hashes(codes, k))
    return f if bloom else text.walk_filter(ctr.finalize("cpu"))


def solid_args(wf):
    """The harness's solidity arguments for a walk filter (the numpy
    arrays are returned too, to keep them alive)."""
    if isinstance(wf, tbloom.CountingBloomFilter):
        counters = wf.counters.numpy().copy()
        return counters, [ptr(counters), wf.size, wf.k, wf.num_hashes,
                          wf.threshold]
    tab = u64.to_numpy(wf.tab).copy()
    return tab, [ptr(tab), len(tab) - 8]


def harness_walk(harness, wf, st, k, max_steps):
    """Run walk_host (walk_bloom_host for a counting filter) on numpy
    copies of a CPU state; returns the copies."""
    s = dict(buf=st.buf.numpy().copy(), length=st.length.numpy().copy(),
             f=u64.to_numpy(st.f).copy(), r=u64.to_numpy(st.r).copy(),
             status=st.status.numpy().copy(),
             has_prev=st.has_prev.numpy().astype(np.uint8))
    seed = u64.to_numpy(st.seed_canon).copy()
    keep, args = solid_args(wf)
    fn = harness.walk_bloom_host if isinstance(
        wf, tbloom.CountingBloomFilter) else harness.walk_host
    P, BUF = s["buf"].shape
    fn(ptr(s["buf"]), P, BUF, ptr(s["length"]), ptr(s["f"]), ptr(s["r"]),
       ptr(s["status"]), ptr(seed), ptr(s["has_prev"]), *args, k, max_steps)
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
    check_walk_on_forks(harness, max_steps, warm, bloom=False)


@pytest.mark.parametrize("max_steps", [1, 7, 200])
@pytest.mark.parametrize("warm", [False, True])
def test_walk_bloom_body_matches_plain_on_forks(harness, max_steps, warm):
    check_walk_on_forks(harness, max_steps, warm, bloom=True)


def check_walk_on_forks(harness, max_steps, warm, bloom):
    """Forks, joins, a dead end and a cycle; lanes stop at every status."""
    k = 11
    common = rnd(40, 3)
    core = rnd(50, 10)
    seqs = [common + rnd(30, 4), common + rnd(30, 5),
            rnd(30, 7) + common[5:], rnd(90, 30), core + core[:k]]
    wf = walk_filter(seqs, k, bloom=bloom)
    seeds = np.stack([alphabet.encode(s[1:k + 1]) for s in seqs])
    prev = np.stack([alphabet.encode(s[0]) for s in seqs])[:, 0] \
        if warm else None
    st = text.init_state(seeds, k + 1 + 64, k, "cpu", prev_base=prev)
    s = harness_walk(harness, wf, st, k, max_steps)
    st = text.fast_extend(wf, st, k, max_steps)
    assert_same(s, st)


@pytest.mark.parametrize("max_steps,buf_extra", [(64, 64), (500, 300)])
def test_walk_body_matches_plain_on_reads(harness, max_steps, buf_extra):
    check_walk_on_reads(harness, max_steps, buf_extra, bloom=False)


@pytest.mark.parametrize("max_steps,buf_extra", [(64, 64), (500, 300)])
def test_walk_bloom_body_matches_plain_on_reads(harness, max_steps,
                                                buf_extra):
    check_walk_on_reads(harness, max_steps, buf_extra, bloom=True)


@pytest.mark.parametrize("bloom", [False, True], ids=["table", "bloom"])
def test_walk_body_odd_lane_count(harness, bloom):
    """37 lanes, not a multiple of the 4 lanes a warp walks (WALK_GROUP
    = 8 members each), and lanes of one warp stopping at different
    steps."""
    st0, st = check_walk_on_reads(harness, 300, 200, bloom, lanes=37)
    steps = (st.length - st0.length).numpy() + (st.status.numpy() != 0)
    assert any(len(set(steps[w:w + 4])) > 1 for w in range(0, 37, 4))


def check_walk_on_reads(harness, max_steps, buf_extra, bloom, lanes=96):
    """Lanes seeded from simulated reads of a genome with repeats and
    errors: tips, bubbles and repeats stop them NEED_F / NEED_B, and a
    short buffer stops the rest CHUNK_LIMIT.  Returns the state before
    and after."""
    k = 25
    genome = sim.genome_with_repeats(3000, seed=3, n_repeats=2,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=4)
    seqs = [seq for _, seq, _ in pr.reads1 + pr.reads2]
    wf = walk_filter(seqs, k, min_cov=2, bloom=bloom)
    rng = np.random.default_rng(5)
    picks = rng.choice(len(seqs), size=lanes, replace=False)
    seeds = np.stack([alphabet.encode(seqs[i][10:10 + k]) for i in picks])
    st0 = text.init_state(seeds, k + buf_extra, k, "cpu")
    launched = dict(kernels.launches)
    s = harness_walk(harness, wf, st0, k, max_steps)
    st = text.fast_extend(wf, st0._replace(buf=st0.buf.clone()), k,
                          max_steps)
    assert kernels.launches == launched    # CPU: plain version
    assert len(set(st.status.tolist())) >= 3
    assert_same(s, st)
    return st0, st


def harness_branch(harness, wf, roots, k, max_depth, width):
    """(depth, probes) of branch_host on numpy roots."""
    N = roots.shape[0]
    f0, r0 = tnt.hash_base(torch.from_numpy(roots), k)
    f0, r0 = u64.to_numpy(f0).copy(), u64.to_numpy(r0).copy()
    keep, args = solid_args(wf)
    fn = harness.branch_bloom_host if isinstance(
        wf, tbloom.CountingBloomFilter) else harness.branch_host
    depth = np.zeros(N, np.int32)
    probes = np.zeros(N, np.int64)
    fn(ptr(roots), N, k, ptr(f0), ptr(r0), *args, max_depth, width,
       max(max_depth - k, 0), ptr(depth), ptr(probes))
    return depth, probes


def sequential_probes(wf, roots, hashes, k, max_depth, width):
    """What a sequential look-ahead tests: each step scans its frontier's
    children in (parent, base) order up to and including the W-th solid
    one, or all 4 of each parent when fewer are solid.  Returns (probes
    int64 [N], splits): splits counts the steps at which the W-th solid
    child has a solid sibling after it, which the frontier drops though
    it keeps an earlier child of the same parent.  branch_depths_plain's
    steps, counted."""
    f0, r0 = hashes
    N, W = f0.shape[0], width
    dev = f0.device
    codes = roots[:, None, :].expand(N, W, k)
    f = f0[:, None].expand(N, W)
    r = r0[:, None].expand(N, W)
    alive = torch.zeros((N, W), dtype=torch.bool, device=dev)
    alive[:, 0] = True
    probes = torch.zeros(N, dtype=torch.int64, device=dev)
    splits = 0
    bases = torch.arange(4, device=dev)
    appended = torch.arange(4, dtype=torch.uint8, device=dev)[
        None, None, :, None].expand(N, W, 4, 1)
    for _ in range(max_depth):
        fc, rc = tnt.roll_right(f[..., None], r[..., None], k,
                                codes[:, :, 0, None], bases[None, None, :])
        solid = wf.contains(u64.umin(fc, rc)) & alive[..., None]
        child_alive = solid.reshape(N, W * 4)
        cum = child_alive.cumsum(dim=1)
        full = cum[:, -1] >= W
        at = (cum >= W).to(torch.uint8).argmax(dim=1)   # the W-th solid
        probes += torch.where(full, at + 1, 4 * alive.sum(dim=1))
        after = at[:, None] + torch.arange(1, 4, device=dev)
        later = child_alive.gather(1, torch.clamp(after, max=4 * W - 1))
        same_parent = after // 4 == (at // 4)[:, None]
        splits += int((full & (later & same_parent).any(dim=1)).sum())
        child_codes = torch.cat(
            [codes[:, :, None, 1:].expand(N, W, 4, k - 1), appended],
            dim=-1).reshape(N, W * 4, k)
        order = torch.argsort((~child_alive).to(torch.uint8), dim=1,
                              stable=True)[:, :W]
        codes = child_codes.gather(1, order[..., None].expand(N, W, k))
        f = fc.reshape(N, W * 4).gather(1, order)
        r = rc.reshape(N, W * 4).gather(1, order)
        alive = child_alive.gather(1, order)
    return probes, splits


@pytest.mark.parametrize("k,max_depth,width", [
    (25, 25, 16), (25, 5, 16), (11, 11, 2), (11, 30, 4), (11, 40, 16)])
def test_branch_body_matches_plain(harness, k, max_depth, width):
    check_branch(harness, k, max_depth, width, bloom=False)


@pytest.mark.parametrize("k,max_depth,width", [
    (25, 25, 16), (11, 11, 2), (11, 30, 4)])
def test_branch_bloom_body_matches_plain(harness, k, max_depth, width):
    check_branch(harness, k, max_depth, width, bloom=True)


@pytest.mark.parametrize("bloom", [False, True], ids=["table", "bloom"])
@pytest.mark.parametrize("k,max_depth,width", [
    (11, 20, 1), (11, 20, 2), (11, 20, 3), (11, 30, 24), (11, 30, 40)])
def test_branch_body_frontier_widths(harness, k, max_depth, width, bloom):
    """Width 1; widths 2 and 3, where a step's W-th solid child falls
    inside a parent's four children with a solid sibling after it; and
    frontiers wider than a round's 8 slots and than the group of
    BRANCH_GROUP = 32 members, searched in several rounds a step."""
    splits = check_branch(harness, k, max_depth, width, bloom)
    if width in (2, 3):
        assert splits > 0


def branch_roots(k, max_depth):
    """(walk filter inputs, roots) of the look-ahead cases: roots inside
    reads and one base off them (tips and bubbles of read errors), one
    with an N, and roots d bases before the genome's end for every
    d <= max_depth + 1."""
    genome = sim.genome_with_repeats(3000, seed=6, n_repeats=2,
                                     repeat_len=150)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=7)
    seqs = [seq for _, seq, _ in pr.reads1 + pr.reads2]
    rng = np.random.default_rng(8)
    roots = [alphabet.encode(seqs[i][20:20 + k])
             for i in rng.choice(len(seqs), 150, replace=False)]
    g = alphabet.encode(genome)
    roots += [g[len(g) - k - d:len(g) - d] for d in range(max_depth + 2)]
    roots = np.stack(roots)
    roots[:150:3, -1] = (roots[:150:3, -1] + 1) % 4
    roots[5, 3] = 4
    # every read k-mer solid: error k-mers make tips and bubbles, and
    # the genome's own k-mers reach its very end
    return seqs + [genome], roots


def check_branch(harness, k, max_depth, width, bloom):
    """The harness's depths equal branch_depths_plain's on branch_roots,
    which reach at least 3 depths; depths past k need the frontier's
    appended bases (max_depth > k).  Its probes equal the sequential
    count; returns that count's splits."""
    seqs, roots = branch_roots(k, max_depth)
    wf = walk_filter(seqs, k, min_cov=1, bloom=bloom)
    depth, probes = harness_branch(harness, wf, roots, k, max_depth, width)
    t = torch.from_numpy(roots)
    hashes = tnt.hash_base(t, k)
    launched = dict(kernels.launches)
    plain = text.branch_depths(wf, t, hashes, k, max_depth, width).numpy()
    assert kernels.launches == launched    # CPU: plain version
    assert len(set(plain.tolist())) >= 3
    np.testing.assert_array_equal(depth, plain)
    seq, splits = sequential_probes(wf, t, hashes, k, max_depth, width)
    np.testing.assert_array_equal(probes, seq.numpy())
    return splits


def test_walk_wrappers_refuse_cpu_tensors():
    """On CPU tensors the walk kernels' wrappers raise and count
    nothing, with the walk table and with a counting Bloom filter."""
    k = 5
    st = text.init_state(np.zeros((4, k), np.uint8), k + 8, k, "cpu")
    tab = torch.full((1024 + 8,), -1, dtype=torch.int64)
    cbf = tbloom.CountingBloomFilter.create(1024, k, device="cpu")
    launched = dict(kernels.launches)
    for solid in (tab, cbf):
        with pytest.raises(ValueError):
            kernels.walk(solid, st.buf, st.length, st.f, st.r, st.status,
                         st.seed_canon, st.has_prev, k, 10)
        with pytest.raises(ValueError):
            kernels.branch(solid, st.buf[:, :k].contiguous(), st.f, st.r, k,
                           5, 4)
    assert kernels.launches == launched


@pytest.mark.parametrize("n,Q,offset", [(1 << 12, 5000, 0),
                                        ((1 << 12) + 1, 20000, 0),
                                        ((1 << 10) + 1, 3000, 3),
                                        (5, 40, 1)])
def test_scatter_max_body_matches_plain(harness, n, Q, offset):
    """Random updates, many to one counter, values below and above the
    counters, indices past the power-of-two size (the sink slot and
    beyond) and negative ones; the counter array starting at every byte
    offset of its word (as a row of a cascade's levels does)."""
    rng = np.random.default_rng(n + Q)
    S = tsm.pow2_size(n)
    idx = rng.integers(-2, n + 3, size=Q).astype(np.int64)
    idx[: Q // 4] = rng.integers(0, 4, size=Q // 4)
    val = rng.integers(0, 256, size=Q).astype(np.uint8)
    base = rng.integers(0, 200, size=n + offset).astype(np.uint8)
    got = base.copy()
    harness.scatter_max_host(ptr(got[offset:]), S, ptr(idx), ptr(val), Q)
    ref = torch.from_numpy(base.copy())
    tsm.scatter_max_u8_plain(ref[offset:], torch.from_numpy(idx),
                             torch.from_numpy(val))
    np.testing.assert_array_equal(got, ref.numpy())
    assert (got[offset + S:] == base[offset + S:]).all()   # sink untouched
    assert (got[:offset] == base[:offset]).all()


def scatter_case(name, seed):
    """(counters, idx, val) numpy arrays of a scatter-max case, for a
    counter array of n = 2^12 + 1 slots (the last the sink):
      words_set    every word already non-zero (a swap must keep
                   the other bytes);
      one_word     every update to the 4 bytes of one word, values 0-255
                   (on the card, threads race on its swap);
      one_byte     every update to one byte, values 0-255;
      val255       values 255 on words that hold other bytes;
      all_dropped  every index negative or past the power-of-two size;
      short        fewer updates than a block has threads;
      ragged       a stream that is not a multiple of a block's threads."""
    rng = np.random.default_rng(seed)
    n = (1 << 12) + 1
    Q = {"short": 100, "ragged": 3 * 2048 + 777}.get(name, 5000)
    counters = rng.integers(0, 3, size=n).astype(np.uint8)
    idx = rng.integers(0, n - 1, size=Q).astype(np.int64)
    val = rng.integers(0, 256, size=Q).astype(np.uint8)
    if name == "words_set":
        counters = rng.integers(1, 100, size=n).astype(np.uint8)
    elif name == "one_word":
        idx = rng.integers(8, 12, size=Q).astype(np.int64)
    elif name == "one_byte":
        idx[:] = 13
    elif name == "val255":
        val[rng.random(Q) < 0.5] = 255
        idx %= 64
    elif name == "all_dropped":
        idx = rng.integers(n - 1, n + 50, size=Q).astype(np.int64)
        idx[::3] = -rng.integers(1, 5, size=len(idx[::3]))
    return counters, idx, val


SCATTER_CASES = ["words_set", "one_word", "one_byte", "val255",
                 "all_dropped", "short", "ragged"]


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("name", SCATTER_CASES)
def test_scatter_max_body_cases(harness, name, offset):
    """Each scatter case on a counter array at byte offset 0, 1 or 3 of
    its word (a cascade's level rows start anywhere)."""
    counters, idx, val = scatter_case(name, seed=len(name) + offset)
    n = counters.shape[0]
    S = tsm.pow2_size(n)
    base = np.concatenate([np.full(offset, 7, np.uint8), counters,
                           np.full(3, 7, np.uint8)])
    got = base.copy()
    harness.scatter_max_host(ptr(got[offset:]), S, ptr(idx), ptr(val),
                             len(idx))
    ref = torch.from_numpy(base.copy())
    tsm.scatter_max_u8_plain(ref[offset:offset + n], torch.from_numpy(idx),
                             torch.from_numpy(val))
    np.testing.assert_array_equal(got, ref.numpy())
    if name == "all_dropped":
        np.testing.assert_array_equal(got, base)


def test_scatter_max_wrapper_refuses_cpu_tensors():
    launched = kernels.launches["scatter_max"]
    with pytest.raises(ValueError):
        kernels.scatter_max(torch.zeros(9, dtype=torch.uint8),
                            torch.zeros(3, dtype=torch.int64),
                            torch.zeros(3, dtype=torch.uint8))
    assert kernels.launches["scatter_max"] == launched
