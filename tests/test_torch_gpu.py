"""The CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA GPU with nvcc (they build the kernels from
csrc/); without one they skip.  Run them on the card with

    python -m pytest tests/test_torch_gpu.py -q --noconftest

(`--noconftest`: tests/conftest.py imports jax, which the port's
machine need not have.)
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from abyss_tpu_torch import convert, sim, u64
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.dbg import extend as ext
from abyss_tpu_torch.ops import bloom as tbloom
from abyss_tpu_torch.ops import hash_probe as thp
from abyss_tpu_torch.ops import kernels
from abyss_tpu_torch.ops import nthash
from abyss_tpu_torch.ops import scatter_max as tsm
from abyss_tpu_torch.ops import sorted_filter as tsf
from abyss_tpu_torch.parallel import distributed as tdist
from abyss_tpu_torch.parallel import mesh as tm
from abyss_tpu_torch.utils import trace
from tests import test_torch_kernel_host as host

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [1, 5, 25, 31, 96])
def test_nthash_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(64, 700), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[1, 300:] = 4
    codes[2, 50] = 9
    t = torch.from_numpy(codes).to(cuda)
    launched = kernels.launches["nthash"]
    fwd, rev, canon, valid = nthash.kmer_hashes(t, k)
    assert kernels.launches["nthash"] == launched + 1
    pf, pr, pc, pv = nthash.kmer_hashes_plain(t, k)
    for a, b in ((fwd, pf), (rev, pr), (canon, pc), (valid, pv)):
        assert torch.equal(a, b)


def test_nthash_kernel_refuses_bad_input(cuda):
    with pytest.raises(TypeError):
        kernels.nthash(torch.zeros((2, 40), dtype=torch.int32, device=cuda),
                       5)
    with pytest.raises(ValueError):
        kernels.nthash(torch.zeros((2, 40), dtype=torch.uint8, device=cuda),
                       41)


@pytest.mark.parametrize("layout", ["picked", "tile", "tile37"])
@pytest.mark.parametrize("shape", list(host.NTHASH_SHAPES))
def test_nthash_kernel_layouts(cuda, shape, layout):
    """The host tests' layout cases on the card: packed and tiled blocks,
    strips of padding, part padding and interior N codes."""
    B, L, k = host.NTHASH_SHAPES[shape]
    geometry = kernels.nthash_lib().geometry
    codes = host.layout_codes(B, L, seed=B * L + k)
    t = torch.from_numpy(codes).to(cuda)
    lay = host.nthash_layouts(B, L, k, geometry,
                              kernels.device_sms(t.device.index))[layout]
    launched = kernels.launches["nthash"]
    strands = layout != "tile37"
    canon, valid, fwd, rev = kernels.nthash_launch(t, k, strands, lay)
    assert kernels.launches["nthash"] == launched + 1
    pf, pr, pc, pv = nthash.kmer_hashes_plain(t, k)
    assert torch.equal(canon, pc) and torch.equal(valid, pv)
    if strands:
        assert torch.equal(fwd, pf) and torch.equal(rev, pr)


def test_nthash_kernel_refuses_bad_layout(cuda):
    """A layout the kernel cannot take (several rows a block that are
    not whole rows) launches nothing and raises."""
    t = torch.zeros((8, 100), dtype=torch.uint8, device=cuda)
    launched = kernels.launches["nthash"]
    with pytest.raises(RuntimeError):
        kernels.nthash_launch(t, 31, False, (2, 35))
    assert kernels.launches["nthash"] == launched


def walk_filter(seqs, k, min_cov, bloom, cuda):
    """The sorted filter's walk table of seqs' k-mers, or (bloom) a
    counting Bloom filter of them small enough to have false positives,
    or (bloom="cascade") a depth-2 cascading Bloom filter as small, the
    k-mers inserted 3 - min_cov times; returns it and the suffix of the
    kernels' launch count."""
    if bloom == "cascade":
        f = tbloom.CascadingBloomFilter.create(1 << 16, k, 3, 2, cuda)
        for _ in range(3 - min_cov):
            for s in seqs:
                f.insert(*nthash.canonical_hashes(
                    torch.from_numpy(alphabet.encode(s)[None]).to(cuda), k))
        return f, "_cascade"
    if bloom == "sharded":
        # the counting filter's counters split into 4 shards of a
        # (1 x 4) mesh of this card (parallel/distributed)
        f, _ = walk_filter(seqs, k, min_cov, True, cuda)
        mesh = tm.make_mesh(1, 4, [cuda] * 4)
        return convert.sharded_filter_from_numpy(
            mesh, f.counters[:f.size].cpu().numpy(), k, f.threshold,
            f.num_hashes), "_sharded"
    if bloom:
        f = tbloom.CountingBloomFilter.create(1 << 17, k, 3, min_cov, cuda)
        add = f.insert
    else:
        ctr = tsf.SortedKmerCounter(k, min_cov)
        add = ctr.add
    for s in seqs:
        add(*nthash.canonical_hashes(
            torch.from_numpy(alphabet.encode(s)[None]).to(cuda), k))
    if bloom:
        return f, "_bloom"
    return ext.walk_filter(ctr.finalize(cuda)), ""


@pytest.mark.parametrize("max_steps", [1, 50, 2000])
def test_walk_kernel_matches_plain(cuda, max_steps):
    check_walk(cuda, max_steps, bloom=False)


@pytest.mark.parametrize("max_steps", [1, 50, 2000])
def test_walk_bloom_kernel_matches_plain(cuda, max_steps):
    check_walk(cuda, max_steps, bloom=True)


@pytest.mark.parametrize("max_steps", [1, 50, 2000])
def test_walk_cascade_kernel_matches_plain(cuda, max_steps):
    check_walk(cuda, max_steps, bloom="cascade")


@pytest.mark.parametrize("max_steps", [1, 50, 2000])
def test_walk_sharded_kernel_matches_plain(cuda, max_steps):
    check_walk(cuda, max_steps, bloom="sharded")


@pytest.mark.parametrize("bloom", [False, True], ids=["table", "bloom"])
def test_walk_kernel_odd_lane_count(cuda, bloom):
    """37 lanes, not a multiple of the 4 lanes a warp walks, and lanes
    of one warp stopping at different steps."""
    st0, a = check_walk(cuda, 300, bloom, lanes=37)
    steps = (a.length - st0.length).cpu().numpy() + \
        (a.status.cpu().numpy() != 0)
    assert any(len(set(steps[w:w + 4])) > 1 for w in range(0, 37, 4))


def test_walk_kernel_refuses_k_beyond_rings(cuda):
    """k >= 4096: a lane's rings of bases would not fit a block's shared
    memory, and the wrapper raises before it launches."""
    k = 4096
    st = ext.init_state(np.zeros((2, k), np.uint8), k + 8, k, cuda)
    tab = torch.full((1024 + 8,), -1, dtype=torch.int64, device=cuda)
    launched = dict(kernels.launches)
    with pytest.raises(ValueError):
        kernels.walk(tab, st.buf, st.length, st.f, st.r, st.status,
                     st.seed_canon, st.has_prev, k, 10)
    assert kernels.launches == launched


def walk_reads():
    genome = sim.genome_with_repeats(5000, seed=3, n_repeats=3,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=4)
    return [s for _, s, _ in pr.reads1 + pr.reads2]


def check_walk(cuda, max_steps, bloom, lanes=300, wf=None):
    """Kernel and plain walks agree on every state field (on `wf`, a
    walk table of walk_reads' k-mers, if given); returns the state
    before and the kernel's after."""
    k = 25
    seqs = walk_reads()
    if wf is None:
        wf, variant = walk_filter(seqs, k, 2, bloom, cuda)
    else:
        variant = ""
    seeds = np.stack([alphabet.encode(s[:k]) for s in seqs[:lanes]])
    st0 = ext.init_state(seeds, k + 400, k, cuda,
                         prev_base=np.zeros(len(seeds), np.uint8))
    fields = ("buf", "length", "f", "r", "status", "has_prev")
    a = st0._replace(**{n: getattr(st0, n).clone() for n in fields})
    b = st0._replace(**{n: getattr(st0, n).clone() for n in fields})
    launched = kernels.launches["walk" + variant]
    a = ext.fast_extend(wf, a, k, max_steps)
    assert kernels.launches["walk" + variant] == launched + 1
    b = ext.fast_extend_plain(wf, b, k, max_steps)
    for n in fields:
        assert torch.equal(getattr(a, n), getattr(b, n)), n
    return st0, a


def test_solid_table_matches_host_build(cuda):
    """The walk table built on the card from a filter counted from reads
    equals the numpy build of the same solid keys, every slot and the
    size; the walk kernel on it matches the plain walk."""
    ctr = tsf.SortedKmerCounter(25, 2)
    for s in walk_reads():
        ctr.add(*nthash.canonical_hashes(
            torch.from_numpy(alphabet.encode(s)[None]).to(cuda), 25))
    filt = ctr.finalize(cuda)
    tab = thp.solid_table(filt)
    assert tab.device.type == "cuda" and filt.solid_tab is tab
    solid = u64.to_numpy(filt.kmers)[filt.counts.cpu().numpy() >= 2]
    assert 0 < len(solid) < filt.n
    np.testing.assert_array_equal(u64.to_numpy(tab), thp.build(solid))
    check_walk(cuda, 2000, False, wf=thp.ProbeSet(tab))


@pytest.mark.parametrize("n,size", [(1 << 22, None), (20000, 1 << 12)])
def test_build_device_matches_host_build_at_scale(cuda, n, size):
    """Millions of random keys (the bids of a slot race in the card's
    atomics), and a size that forces doublings."""
    keys = np.random.default_rng(n).integers(0, 1 << 64, n, dtype=np.uint64)
    want = thp.build(keys, size)
    got = thp.build_device(u64.from_numpy(keys, cuda), size)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(u64.to_numpy(got), want)


@pytest.mark.parametrize("max_depth,width", [(25, 16), (5, 16), (40, 4)])
def test_branch_kernel_matches_plain(cuda, max_depth, width):
    check_branch(cuda, max_depth, width, bloom=False)


@pytest.mark.parametrize("max_depth,width", [(25, 16), (5, 16), (40, 4)])
def test_branch_bloom_kernel_matches_plain(cuda, max_depth, width):
    check_branch(cuda, max_depth, width, bloom=True)


@pytest.mark.parametrize("max_depth,width", [(25, 16), (5, 16), (40, 4)])
def test_branch_cascade_kernel_matches_plain(cuda, max_depth, width):
    check_branch(cuda, max_depth, width, bloom="cascade")


@pytest.mark.parametrize("max_depth,width", [(25, 16), (5, 16), (40, 4)])
def test_branch_sharded_kernel_matches_plain(cuda, max_depth, width):
    check_branch(cuda, max_depth, width, bloom="sharded")


@pytest.mark.parametrize("bloom", [False, True, "cascade"],
                         ids=["table", "bloom", "cascade"])
@pytest.mark.parametrize("k,max_depth,width", [
    (11, 20, 1), (11, 20, 2), (11, 20, 3), (11, 30, 24), (11, 30, 40),
    (11, 30, 200), (11, 400, 16)])
def test_branch_kernel_frontier_widths(cuda, k, max_depth, width, bloom):
    """The host tests' look-ahead cases on the card: width 1, widths 2
    and 3 (the W-th solid child inside a parent's children), widths
    wider than a round and than a group; and frontiers too large for
    shared memory (a width of 200, or 389 appended bases), which live
    in device-memory scratch.  Depths equal the plain version's, probes the g++
    harness's and the sequential count."""
    seqs, roots = host.branch_roots(k, max_depth)
    wf, variant = walk_filter(seqs, k, 1, bloom, cuda)
    t = torch.from_numpy(roots).to(cuda)
    hashes = nthash.hash_base(t, k)
    probes = torch.zeros(len(roots), dtype=torch.int64, device=cuda)
    launched = kernels.launches["branch" + variant]
    d = kernels.branch(ext._kernel_solid("branch", wf), t, *hashes, k,
                       max_depth, width, probes)
    assert kernels.launches["branch" + variant] == launched + 1
    assert torch.equal(d, ext.branch_depths_plain(wf, t, hashes, k,
                                                  max_depth, width))
    seq, _ = host.sequential_probes(wf, t, hashes, k, max_depth, width)
    assert torch.equal(probes, seq)
    if shutil.which("g++") is not None:
        hw = host.walk_filter(seqs, k, min_cov=1, bloom=bloom)
        _, hp = host.harness_branch(host.build_harness(), hw, roots, k,
                                    max_depth, width)
        assert np.array_equal(probes.cpu().numpy(), hp)


def check_branch(cuda, max_depth, width, bloom):
    k = 25
    genome = sim.genome_with_repeats(5000, seed=5, n_repeats=3,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=6)
    seqs = [s for _, s, _ in pr.reads1 + pr.reads2] + [genome]
    wf, variant = walk_filter(seqs, k, 1, bloom, cuda)
    g = alphabet.encode(genome)
    roots = np.stack([alphabet.encode(s[30:30 + k]) for s in seqs[:500]]
                     + [g[len(g) - k - d:len(g) - d] for d in range(45)])
    t = torch.from_numpy(roots).to(cuda)
    hashes = nthash.hash_base(t, k)
    launched = kernels.launches["branch" + variant]
    d = ext.branch_depths(wf, t, hashes, k, max_depth, width)
    assert kernels.launches["branch" + variant] == launched + 1
    assert torch.equal(d, ext.branch_depths_plain(wf, t, hashes, k,
                                                  max_depth, width))


@pytest.mark.parametrize("n,Q", [((1 << 20) + 1, 1 << 20), (1 << 12, 1 << 18),
                                 (5, 1000)])
def test_scatter_max_kernel_matches_plain(cuda, n, Q):
    """Random updates (a quarter of them to 4 counters, so swaps
    collide), indices past the power-of-two size and negative ones."""
    rng = np.random.default_rng(n)
    idx = rng.integers(-2, n + 3, size=Q).astype(np.int64)
    idx[: Q // 4] = rng.integers(0, 4, size=Q // 4)
    idx = torch.from_numpy(idx).to(cuda)
    val = torch.from_numpy(rng.integers(0, 256, size=Q).astype(
        np.uint8)).to(cuda)
    base = torch.from_numpy(rng.integers(0, 200, size=n).astype(
        np.uint8)).to(cuda)
    launched = kernels.launches["scatter_max"]
    got, ok = tsm.scatter_max_u8(base.clone(), idx, val)
    assert ok is True
    assert kernels.launches["scatter_max"] == launched + 1
    ref, _ = tsm.scatter_max_u8_plain(base.clone(), idx, val)
    assert torch.equal(got, ref)
    # a counter array that starts inside a word (a cascade's level row)
    levels = base.clone()
    tsm.scatter_max_u8(levels[1:], idx, val)
    plain = base.clone()
    tsm.scatter_max_u8_plain(plain[1:], idx, val)
    assert torch.equal(levels, plain)


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("name", host.SCATTER_CASES)
def test_scatter_max_kernel_cases(cuda, name, offset):
    """The host tests' scatter cases on the card: words already set, one
    word and one byte raced by many threads, 255s, all dropped, short
    and ragged streams, counters at byte offsets 0, 1 and 3."""
    counters, idx, val = host.scatter_case(name, seed=len(name) + offset)
    n = counters.shape[0]
    base = torch.from_numpy(np.concatenate([
        np.full(offset, 7, np.uint8), counters,
        np.full(3, 7, np.uint8)])).to(cuda)
    idx, val = torch.from_numpy(idx).to(cuda), torch.from_numpy(val).to(cuda)
    got = base.clone()
    tsm.scatter_max_u8(got[offset:offset + n], idx, val)
    ref = base.clone()
    tsm.scatter_max_u8_plain(ref[offset:offset + n], idx, val)
    assert torch.equal(got, ref)


def test_counting_filter_insert_on_card_matches_cpu(cuda):
    """A counting filter's inserts on the card (scatter-max kernel) give
    the CPU's counters in every update mode."""
    rng = np.random.default_rng(7)
    canon = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=200000,
                                          dtype=np.int64))
    canon[1000:30000] = canon[:29000].clone()    # repeated keys
    mask = torch.from_numpy(rng.random(200000) < 0.9)
    ref = tbloom.CountingBloomFilter.create(1 << 18, 31, 4, 2, "cpu")
    ref.insert(canon, mask).insert(canon[:50000])
    for mode in tbloom.UPDATE_MODES:
        f = tbloom.CountingBloomFilter.create(1 << 18, 31, 4, 2, cuda)
        f.update_mode = mode
        f.insert(canon.to(cuda), mask.to(cuda)).insert(canon[:50000].to(cuda))
        assert torch.equal(f.counters.cpu(), ref.counters), mode


# -------------------------------------------------- the pe pipeline's stages

@pytest.mark.parametrize("layout", ["picked", "tile", "tile37"])
@pytest.mark.parametrize("shape", list(host.PE_SHAPES) + ["reads160_full"])
def test_nthash_kernel_pe_shapes(cuda, shape, layout):
    """The pe pipeline's new ntHash shapes on the card (the mapper's
    index chunk and read batches, RResolver's reads and windows at
    r = 91; reads160_full at the card's 16384 rows), bit for bit against
    the plain version."""
    full = shape == "reads160_full"
    name = "reads160" if full else shape
    codes = host.pe_codes(name, seed=7)
    if full:
        codes = np.tile(codes, (-(-16384 // codes.shape[0]), 1))[:16384]
    B, L = codes.shape
    k = host.PE_SHAPES[name][2]
    t = torch.from_numpy(np.ascontiguousarray(codes)).to(cuda)
    lay = host.nthash_layouts(B, L, k, kernels.nthash_lib().geometry,
                              kernels.device_sms(t.device.index))[layout]
    strands = layout != "tile37"
    canon, valid, fwd, rev = kernels.nthash_launch(t, k, strands, lay)
    pf, pr, pc, pv = nthash.kmer_hashes_plain(t, k)
    assert torch.equal(canon, pc) and torch.equal(valid, pv)
    if strands:
        assert torch.equal(fwd, pf) and torch.equal(rev, pr)


def _contigs(seed, n=12):
    """Random contigs of 300-4000 bases, one repeating a stretch of the
    first (tied votes)."""
    rng = np.random.default_rng(seed)
    cs = [(str(i), alphabet.decode(rng.integers(0, 4, int(m)).astype(
        np.uint8))) for i, m in enumerate(rng.integers(300, 4000, n))]
    cs.append(("rep", cs[0][1][50:700] + cs[1][1][:200]))
    return cs


def _reads(contigs, B, L, seed):
    """[B, L] codes of 150-base reads from the contigs, either strand, 1%
    substitutions, a share unmapped or all padding."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, np.uint8)
    for i in range(B):
        if rng.random() < 0.05:
            continue
        s = alphabet.encode(contigs[rng.integers(len(contigs))][1])
        st = int(rng.integers(0, max(len(s) - 150, 1)))
        r = s[st:st + 150].copy()
        if rng.random() < 0.05:
            r = rng.integers(0, 4, len(r)).astype(np.uint8)
        err = rng.random(len(r)) < 0.01
        r[err] = (r[err] + 1) % 4
        if rng.random() < 0.5:
            r = alphabet.revcomp_codes(r)
        codes[i, :len(r)] = r
    return codes


def test_vote_on_card_matches_cpu(cuda):
    """The mapper's vote (index and read-batch ntHash launches, the row
    join, the key sort and run-length argmaxes) on the card gives the
    CPU's outputs."""
    from abyss_tpu_torch.align import mapper
    contigs = _contigs(3)
    codes = mapper._trim_pad_columns(_reads(contigs, 2048, 256, 4), 32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        ix = mapper.KmerIndex.build(contigs, 32, dev)
        launched = kernels.launches["nthash"]
        got = mapper._vote_kernel(ix, torch.from_numpy(codes).to(dev), 32)
        if dev.type == "cuda":
            assert kernels.launches["nthash"] == launched + 1
        out.append([t.cpu() for t in got])
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert (out[1][1] >= 2).float().mean() > 0.8


def test_map_library_on_card_matches_cpu(cuda, tmp_path):
    """pe's mapping of one library (the index, the vote and the
    decision of 16,384-read batches, the one copy down a batch, the
    columnar fixmate) on the card gives the CPU's histogram, in its
    insertion order, and the CPU's PairLinks in order: 16,666 pairs of
    2 x 150 bp on 40 contigs of a 200 kbp genome, every fifth first
    read with a 3-base deletion (chained over two diagonals)."""
    from abyss_tpu_torch.align import mapper
    from abyss_tpu_torch.pipeline import pe
    genome = sim.random_genome(200_000, seed=31)
    cuts = [0] + sorted(np.random.default_rng(32).choice(
        np.arange(1000, 199_000), 39, replace=False).tolist()) + [200_000]
    target = str(tmp_path / "t.fa")
    with open(target, "w") as f:
        for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
            seq = genome[a:b + 60]
            if i % 3 == 1:
                seq = alphabet.revcomp(seq)
            f.write(f">{i} {len(seq)} 0\n{seq}\n")
    pr = sim.simulate_paired_reads(genome, coverage=25, read_len=150,
                                   fragment_mean=500, fragment_sd=50,
                                   error_rate=0.003, seed=33)
    pr.reads1[::5] = [(n, q[:70] + q[73:], x[3:])
                      for n, q, x in pr.reads1[::5]]
    files = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    pr.write_fastq(*files)
    assert len(pr.reads1) >= 16_384
    out, chained = [], []
    for dev in ("cuda", "cpu"):
        p = pe.PipelineParams(name="m", verbose=0, device=dev)
        with trace.recording() as records:
            hist, links = pe._map_library(p, target, files, p.align_k)
        out.append((hist.to_text(), list(hist.counts.items()),
                    [dataclasses.astuple(x) for x in links]))
        chained.append(trace.counter_totals(records)["align.chained"])
    assert out[0] == out[1]
    assert chained[0] == chained[1] > 0
    assert sum(n for _, n in out[0][1]) > 10_000 and len(out[0][2]) > 100


def test_mle_on_card_matches_cpu(cuda):
    """The batched MLE scan (float64) on the card gives the CPU's
    distances and pair counts on 200 groups in several (T, n) buckets."""
    from abyss_tpu_torch.align import distance_est as de
    from abyss_tpu_torch.core.histogram import Histogram
    rng = np.random.default_rng(42)
    frags = [int(x) for x in rng.normal(420, 45, 4000).astype(int) if x > 0]
    pmf = de.PMF.from_histogram(Histogram.of(frags))
    first, last = -(len(pmf.probs) - 1), len(pmf.probs) - 1
    groups = []
    for g in range(200):
        n = int(rng.integers(10, 400))
        spans = rng.normal(420, 45, n).astype(int) - int(
            rng.integers(-80, 400))
        groups.append((("u%d" % g, 0, "v%d" % g, 0), [int(s) for s in spans],
                       int(rng.integers(300, 3000)),
                       int(rng.integers(300, 3000))))
    gpu = de.estimate_distances_device(groups, pmf, first, last, device=cuda)
    cpu = de.estimate_distances_device(groups, pmf, first, last, device="cpu")
    assert gpu == cpu
    for key, samples, l0, l1 in groups[:20]:
        assert gpu[key] == de.maximum_likelihood_estimate(
            samples, pmf, l0, l1, first, last)


@pytest.mark.parametrize("LA,LB", [(40, 37), (300, 280)])
def test_nw_batch_on_card_matches_cpu(cuda, LA, LB):
    from abyss_tpu_torch.align import nw
    rng = np.random.default_rng(LA)
    a = rng.integers(0, 4, (64, LA), dtype=np.uint8)
    b = rng.integers(0, 4, (64, LB), dtype=np.uint8)
    for i in range(64):      # BAD padding after a random length
        a[i, rng.integers(0, LA + 1):] = alphabet.BAD
        b[i, rng.integers(0, LB + 1):] = alphabet.BAD
    b[:32, :LA // 2] = a[:32, :LA // 2]
    got = nw.nw_batch(torch.from_numpy(a).to(cuda),
                      torch.from_numpy(b).to(cuda))
    assert got.is_cuda
    assert torch.equal(got.cpu(), nw.nw_batch(torch.from_numpy(a),
                                              torch.from_numpy(b)))


def test_rmer_filter_on_card_matches_cpu(cuda):
    """RResolver's r-mer filter (ntHash at r = 91 on read batches, the
    bit filter's inserts) on the card holds the CPU's bits, and its
    window probe gives the CPU's answers."""
    from abyss_tpu_torch.graph import rresolver
    contigs = _contigs(5)
    batches = [_reads(contigs, 1024, 256, s) for s in (6, 7)]
    gpu = rresolver.build_rmer_filter(batches, r=91, size=1 << 22,
                                      device=cuda)
    cpu = rresolver.build_rmer_filter(batches, r=91, size=1 << 22,
                                      device="cpu")
    assert gpu.bits.is_cuda and torch.equal(gpu.bits.cpu(), cpu.bits)
    win = torch.from_numpy(np.ascontiguousarray(batches[0][:, 10:101]))
    hits = []
    for f, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
        _, _, c, v = nthash.kmer_hashes(win.to(dev), 91)
        hits.append(f.contains(c, v)[:, 0].cpu())
    assert torch.equal(*hits) and hits[0].any()


def exact_reads(seed=3, n=800, L=150, glen=4000, err=0.004):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, glen).astype(np.uint8)
    reads = []
    for _ in range(n):
        p = rng.integers(0, glen - L)
        r = g[p:p + L].copy()
        bad = rng.random(L) < err
        r[bad] = (r[bad] + rng.integers(1, 4, bad.sum())) % 4
        reads.append(3 - r[::-1] if rng.random() < 0.5 else r)
    return np.array(reads, np.uint8)


@pytest.mark.parametrize("k", [21, 40, 96])
def test_kmer_hashes_alt_on_card_matches_cpu(cuda, k):
    codes = torch.from_numpy(exact_reads(k, n=64))
    want = nthash.kmer_hashes_alt(codes, k)
    got = nthash.kmer_hashes_alt(codes.to(cuda), k)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k,strand", [(25, True), (31, True), (32, True),
                                      (64, False), (96, True)])
def test_exact_engine_on_card_matches_cpu(cuda, k, strand):
    """count (the wide path through the ntHash kernel), adjacency,
    erode, trim, the low-coverage loop, bubbles and emission on the
    card: every table array and every contig equal to the CPU's."""
    from abyss_tpu_torch.dbg import hash_dbg
    reads = exact_reads(k)
    batches = [reads[:300], reads[300:]]
    out = {}
    for dev in ("cpu", "cuda"):
        launched = kernels.launches["nthash"]
        bubbles = []
        contigs, t = hash_dbg.assemble_reads(
            batches, k, kc=2, erode_cov=None, erode_strand=None,
            auto_params=True, min_mean_cov=None, bubbles_out=bubbles,
            device=dev)
        if dev == "cuda":
            assert (kernels.launches["nthash"] > launched) == (k > 32)
        out[dev] = (contigs, bubbles, [
            None if getattr(t, n) is None else np.asarray(getattr(t, n))
            for n in ("kmers", "counts", "alive", "nbr", "hr", "text",
                      "fwd_counts", "cs")])
    assert out["cuda"][:2] == out["cpu"][:2]
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert len(out["cpu"][0]) > 0


def test_chain_programs_on_card_match_cpu(cuda):
    """_full_rank on chains and cycles, and the trim / erode rounds and
    the chain sort of a real table, on the card and on the CPU."""
    from abyss_tpu_torch.dbg import chain_ops, hash_dbg
    # chains and cycles of several lengths over a random permutation
    rng = np.random.default_rng(1)
    perm = rng.permutation(3000)
    nxt = np.full(3000, -1, np.int64)
    ends = np.cumsum(rng.choice([2, 3, 7, 40, 300], 200))
    for a, b in zip(np.concatenate([[0], ends]), ends[ends <= 3000]):
        seg = perm[a:b]
        nxt[seg[:-1]] = seg[1:]
        if rng.random() < 0.4:
            nxt[seg[-1]] = seg[0]
    nxt = torch.from_numpy(nxt)
    for a, b in zip(chain_ops._full_rank(nxt.to(cuda)),
                    chain_ops._full_rank(nxt)):
        assert torch.equal(a.cpu(), b)
    t = hash_dbg.count_kmers([exact_reads(5)], 25, device="cpu")
    hash_dbg.apply_coverage_threshold(t, 2)
    hash_dbg.compact(t)
    hash_dbg.build_adjacency(t)
    res = {}
    for dev in ("cpu", "cuda"):
        t.device = dev
        d = chain_ops.DeviceDBG(t)
        nxt = d._nxt()
        outdeg, indeg = d._deg_ov()
        weak = d.counts_d < 4
        ov_s, start, cnt = chain_ops._chains_sorted_dev(nxt, d.alive_d)
        a = int(cnt)
        res[dev] = [x.cpu() for x in (
            nxt, *chain_ops._trim_round_impl(nxt, outdeg, indeg, d.alive_d,
                                             d.counts_d, 25, 5),
            *chain_ops._erode_round_impl(nxt, indeg, d.alive_d, weak),
            ov_s[:a], start[:a])]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.equal(a, b)


def test_hash_insert_on_card_matches_cpu(cuda):
    """ops/hash_probe.insert with racing duplicate keys and crowded
    windows: the same tables and failure count on the card as on the
    CPU (the highest lane wins a slot on both)."""
    from abyss_tpu_torch.ops import hash_probe as hp
    rng = np.random.default_rng(2)
    pool = rng.integers(-(1 << 62), 1 << 62, 300)
    for size, n in ((64, 3000), (1 << 14, 200000)):
        keys = torch.from_numpy(rng.choice(pool, n))
        vals = torch.arange(n, dtype=torch.int64)
        live = torch.from_numpy(rng.random(n) < 0.8)
        tab = torch.full((size + hp.B,), -1, dtype=torch.int64)
        vtab = torch.full((size + hp.B,), -1, dtype=torch.int32)
        want = hp.insert(tab, vtab, keys, vals, live)
        got = hp.insert(tab.to(cuda), vtab.to(cuda), keys.to(cuda),
                        vals.to(cuda), live.to(cuda))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("k,K", [(14, 40), (16, 32), (31, 80)])
def test_paired_dbg_on_card_matches_cpu(cuda, k, K):
    """The paired DBG (packed and wide, the zero gap at K = 2k) on the
    card and the CPU: the same contigs; the wide mode launches ntHash."""
    from abyss_tpu_torch.dbg import paired_dbg
    reads = exact_reads(k)
    batches = [reads[:300], reads[300:]]
    launched = kernels.launches["nthash"]
    got = paired_dbg.assemble_pairs(batches, k, K, device="cuda")
    assert (kernels.launches["nthash"] > launched) == (k > 16)
    assert got == paired_dbg.assemble_pairs(batches, k, K, device="cpu")
    assert got


def test_paired_packed_graph_on_card_matches_cpu(cuda, monkeypatch):
    """The packed pair engine at the README's k = 16, span 96 on 100 kbp
    of 2 x 250 bp pairs at 40x: the same contigs on the card as on the
    CPU, and the phases after the count (the probe, then the graph
    phases: links, trim rounds, chain order, emission) peak under the
    count, so that the graph on the card never sets the job's peak."""
    from abyss_tpu_torch.dbg import paired_dbg
    genome = sim.genome_with_repeats(100_000, seed=21, n_repeats=2,
                                     repeat_len=700)
    pr = sim.simulate_paired_reads(genome, coverage=40, read_len=250,
                                   fragment_mean=600, fragment_sd=60,
                                   error_rate=0.005, seed=22)
    reads = np.stack([alphabet.encode(s)
                      for _, s, _ in pr.reads1 + pr.reads2])
    batches = [reads[i:i + 4096] for i in range(0, len(reads), 4096)]
    peaks = {}

    def measured(name):
        fn = getattr(paired_dbg, name)

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            peaks[name] = max(peaks.get(name, 0),
                              torch.cuda.max_memory_allocated())
            return out
        monkeypatch.setattr(paired_dbg, name, run)

    for name in ("count_pairs", "build_pair_adjacency", "_pair_links",
                 "_pair_trim_round", "_pair_chain_order",
                 "_emit_packed_chains"):
        measured(name)
    got = paired_dbg.assemble_pairs(batches, 16, 96, device="cuda")
    monkeypatch.undo()
    assert got == paired_dbg.assemble_pairs(batches, 16, 96, device="cpu")
    assert len(got) > 10
    count = peaks.pop("count_pairs")
    assert max(peaks.values()) < count, (count, peaks)


@pytest.mark.parametrize("engine", ["device", "host"])
def test_konnector_on_card_matches_cpu(cuda, engine, monkeypatch):
    """connect_pairs_full on error-laden pairs, on the sorted filter
    under both engines and on a cascading Bloom filter: the same results
    on the card as on the CPU."""
    from abyss_tpu_torch.gap import konnector
    monkeypatch.setenv("ABYSS_TPU_KONNECTOR", engine)
    genome = sim.genome_with_repeats(6000, seed=7, n_repeats=3,
                                     repeat_len=300)
    pr = sim.simulate_paired_reads(genome, coverage=15, read_len=100,
                                   error_rate=0.005, seed=8)
    pairs = [(a[1], b[1]) for a, b in zip(pr.reads1, pr.reads2)][:300]
    seqs = [s for _, s, _ in pr.reads1 + pr.reads2]
    out = {}
    for dev in ("cpu", "cuda"):
        ctr = tsf.SortedKmerCounter(21, 2)
        casc = tbloom.CascadingBloomFilter.create(1 << 20, 21, depth=2,
                                                  device=dev)
        for s in seqs:
            c = torch.from_numpy(alphabet.encode(s)[None]).to(dev)
            ctr.add(*nthash.canonical_hashes(c, 21))
            casc.insert(*nthash.canonical_hashes(c, 21))
        out[dev] = [[dataclasses.astuple(r) for r in
                     konnector.connect_pairs_full(f, pairs, 21, chunk=128)]
                    for f in (ctr.finalize(dev), casc)]
    assert out["cuda"] == out["cpu"]
    assert any(r[2] == "FOUND_PATH" for r in out["cpu"][0])


@pytest.mark.parametrize("size", [1000, 1 << 20])
def test_plc_insert_on_card_matches_cpu(cuda, size):
    """PLCArray.insert on the card (threefry on the device, the write by
    the scatter-max kernel) gives the CPU's counters byte for byte."""
    from abyss_tpu_torch.ops import plc
    rng = np.random.default_rng(size)
    arrays = [plc.PLCArray(size, seed=4, device=d) for d in ("cpu", cuda)]
    launched = kernels.launches["scatter_max"]
    for _ in range(40):
        idx = rng.integers(0, size, size=5000)
        idx[:500] = 7                   # one cell, 40 increments
        for a in arrays:
            a.insert(idx)
    assert kernels.launches["scatter_max"] == launched + 40
    assert torch.equal(arrays[1].counters.cpu(), arrays[0].counters)
    assert int(arrays[0].counters.max()) > 32


def test_device_suffix_array_on_card_matches_cpu(cuda):
    from abyss_tpu_torch.align import fmindex
    g = sim.genome_with_repeats(200_000, seed=3, n_repeats=4,
                                repeat_len=700)
    text = np.concatenate([alphabet.encode(g).astype(np.int64) + 1, [0]])
    sa = fmindex._suffix_array_device(text, cuda)
    np.testing.assert_array_equal(sa, fmindex._suffix_array_device(text,
                                                                   "cpu"))
    assert np.array_equal(np.sort(sa), np.arange(len(text)))


def test_sharded_filter_across_cards(cuda):
    """Shards on two cards: the walk kernel launched on the first reads
    the second's shard by peer access (or raises where it cannot), and
    agrees with the plain walk."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    k = 25
    genome = sim.random_genome(3000, seed=9)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.01, seed=10)
    seqs = [s for _, s, _ in pr.reads1 + pr.reads2]
    f, _ = walk_filter(seqs, k, 2, True, cuda)
    mesh = tm.make_mesh(1, 2, [torch.device("cuda", 0),
                               torch.device("cuda", 1)])
    wf = convert.sharded_filter_from_numpy(
        mesh, f.counters[:f.size].cpu().numpy(), k, f.threshold,
        f.num_hashes)
    seeds = np.stack([alphabet.encode(s[:k]) for s in seqs[:200]])
    st0 = ext.init_state(seeds, k + 300, k, torch.device("cuda", 0))
    fields = ("buf", "length", "f", "r", "status", "has_prev")
    a = st0._replace(**{n: getattr(st0, n).clone() for n in fields})
    b = st0._replace(**{n: getattr(st0, n).clone() for n in fields})
    if not torch.cuda.can_device_access_peer(0, 1):
        with pytest.raises(RuntimeError, match="cannot read the shard"):
            ext.fast_extend(wf, a, k, 300)
        return
    a = ext.fast_extend(wf, a, k, 300)
    b = ext.fast_extend_plain(wf, b, k, 300)
    for n in fields:
        assert torch.equal(getattr(a, n), getattr(b, n)), n


@pytest.mark.parametrize("k", [25, 40])
def test_mesh_engines_on_card_match_cpu(cuda, k):
    """On a mesh of four copies of the card and of the CPU: the sharded
    exact engine's contigs, the mesh counting filter's counters (the
    load step's ntHash and scatter-max kernels), and the sharded
    filter's probes agree."""
    from abyss_tpu_torch.parallel import sharded_table as tst
    genome = sim.genome_with_repeats(6000, seed=12, n_repeats=2,
                                     repeat_len=200)
    pr = sim.simulate_paired_reads(genome, coverage=20, read_len=100,
                                   error_rate=0.003, seed=13)
    seqs = [s for _, s, _ in pr.reads1 + pr.reads2]
    codes = np.full((len(seqs), 100), 4, np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = alphabet.encode(s)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        devs = [dev] * 4
        contigs, _ = tst.assemble_sharded(tm.make_mesh(4, 1, devs), [codes],
                                          k, erode_cov=None,
                                          erode_strand=None, auto_params=True)
        launched = dict(kernels.launches)
        f = tdist.distributed_filter_build(tm.make_mesh(2, 2, devs), [codes],
                                           k, size=1 << 16, sharded=True)
        if dev.type == "cuda":
            assert kernels.launches["scatter_max"] == \
                launched["scatter_max"] + 4
        canon, valid = nthash.canonical_hashes(
            torch.from_numpy(codes).to(dev), k)
        out[dev.type] = (contigs, torch.cat(f.shards).cpu(),
                         f.count(canon, valid).cpu())
    assert out["cuda"][0] == out["cpu"][0] and len(out["cpu"][0]) > 0
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert torch.equal(out["cuda"][2], out["cpu"][2])
