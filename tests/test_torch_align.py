"""The port's mapper, DistanceEst and Needleman-Wunsch against abyss_tpu,
on the CPU: the same inputs, made from a seed with numpy, through the
JAX function and its counterpart in abyss_tpu_torch.  Integer outputs
must be equal, with no tolerance: the row join, the k-mer index, the
vote, the alignments and the fixmate histograms, the distance
estimates of the batched MLE scan, the batched NW scores and the
multiple-alignment consensus that reaches them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abyss_tpu.align import dialign as jdialign
from abyss_tpu.align import distance_est as jde
from abyss_tpu.align import fixmate as jfixmate
from abyss_tpu.align import mapper as jmapper
from abyss_tpu.align import nw as jnw
from abyss_tpu.core.histogram import Histogram as JHistogram
from abyss_tpu.ops import sort_join as jsj
from abyss_tpu_torch import convert, u64
from abyss_tpu_torch.align import dialign as tdialign
from abyss_tpu_torch.align import distance_est as tde
from abyss_tpu_torch.align import fixmate as tfixmate
from abyss_tpu_torch.align import mapper as tmapper
from abyss_tpu_torch.align import nw as tnw
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.core.histogram import Histogram as THistogram
from abyss_tpu_torch.ops import sort_join as tsj

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

K = 32          # pe's default seed length (align_k, l=)
READ_LEN = 100
L = 128         # the batch width: reads padded with code 4


def rnd(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


# ---------------------------------------------------------------- join_rows

@pytest.mark.parametrize("M,N,dup,seed", [(1, 50, 0.0, 1), (300, 2000, 0.3, 2),
                                          (5000, 700, 0.05, 3),
                                          (64, 64, 0.9, 4)])
def test_join_rows_matches_jax(M, N, dup, seed):
    """Sorted table keys over the whole uint64 range (the top bit set in
    half of them), a share of them repeated (the index's duplicate
    k-mers), queries that hit, miss, or equal the all-ones padding
    sentinel."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64 - 1, size=M, dtype=np.uint64)
    rep = rng.random(M) < dup
    keys[1:][rep[1:]] = keys[:-1][rep[1:]]
    keys = np.sort(keys)
    keys[-1] = np.uint64(2**64 - 1)
    keys = np.sort(keys)
    hits = keys[rng.integers(0, M, N)]
    miss = rng.integers(0, 2**64 - 1, size=N, dtype=np.uint64)
    q = np.where(rng.random(N) < 0.5, hits, miss)
    want = np.asarray(jsj.join_rows(jnp.asarray(keys), jnp.asarray(q)))
    got = tsj.join_rows(u64.from_numpy(keys), u64.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == -1).any() and (want >= 0).any()


def test_join_rows_empty_table():
    q = np.arange(5, dtype=np.uint64)
    got = tsj.join_rows(torch.zeros(0, dtype=torch.int64), u64.from_numpy(q))
    assert got.dtype == torch.int32 and (got == -1).all()
    want = np.asarray(jsj.join_rows(jnp.zeros(0, jnp.uint64), jnp.asarray(q)))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ index and vote

@pytest.fixture(scope="module")
def contigs():
    """Contigs of 200-3000 bases, one shorter than k, one that repeats a
    400-base stretch of the first (seeds that tie between two contigs)
    and one that holds it twice (duplicate k-mers within a contig)."""
    rng = np.random.default_rng(11)
    cs = [(str(i), rnd(rng, int(n)))
          for i, n in enumerate(rng.integers(200, 3000, 8))]
    cs.append(("short", rnd(rng, K - 5)))
    rep = cs[0][1][100:500]
    cs.append(("rep", rnd(rng, 150) + rep + rnd(rng, 150)))
    cs.append(("twice", rep + rnd(rng, 80) + rep))
    return cs


def sample_reads(contigs, n, seed):
    """[n, L] codes and lengths: reads from random contigs, either
    strand, with substitutions, a 3-base insertion or deletion in some,
    some random (unmapped), some rows all padding."""
    rng = np.random.default_rng(seed)
    long_ = [s for _, s in contigs if len(s) > READ_LEN + 10]
    codes = np.full((n, L), 4, np.uint8)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        kind = rng.random()
        if kind < 0.05:
            continue                       # all padding
        if kind < 0.12:
            seq = rnd(rng, READ_LEN)       # unmapped
        else:
            s = long_[rng.integers(len(long_))]
            st = int(rng.integers(0, len(s) - READ_LEN - 5))
            seq = s[st:st + READ_LEN + 3]
            if kind < 0.25:                # 3-base deletion
                seq = seq[:45] + seq[48:]
            elif kind < 0.38:              # 3-base insertion
                seq = seq[:50] + "GTA" + seq[50:]
            seq = seq[:READ_LEN]
            c = list(seq)
            for j in np.nonzero(rng.random(READ_LEN) < 0.01)[0]:
                c[j] = "ACGT"[("ACGT".index(c[j]) + 1) % 4]
            seq = "".join(c)
            if rng.random() < 0.5:
                seq = alphabet.revcomp(seq)
        codes[i, :len(seq)] = alphabet.encode(seq)
        lengths[i] = len(seq)
    return codes, lengths


@pytest.fixture(scope="module")
def indexes(contigs):
    return (jmapper.KmerIndex.build(contigs, K),
            tmapper.KmerIndex.build(contigs, K, device="cpu"))


def index_arrays(ix, port):
    conv = u64.to_numpy if port else np.asarray
    arrays = [conv(ix.hashes)] + [
        (t.numpy() if port else np.asarray(t))
        for t in (ix.contig, ix.pos, ix.is_fwd, ix.first_row)]
    return arrays, ix.names, ix.lengths


def test_kmer_index_build_matches_jax(indexes):
    jix, tix = indexes
    (ja, jn, jl), (ta, tn, tl) = index_arrays(jix, False), \
        index_arrays(tix, True)
    assert (tn, tl) == (jn, jl) and "short" not in tn
    for j, t in zip(ja, ta):
        np.testing.assert_array_equal(t, j)
    assert tix.hashes.dtype == torch.int64 and tix.contig.dtype == torch.int32


def test_kmer_index_build_across_chunks(monkeypatch, contigs):
    """Index chunks of 512 bases: windows near every chunk boundary."""
    monkeypatch.setattr(jmapper.KmerIndex, "CHUNK", 512)
    monkeypatch.setattr(tmapper.KmerIndex, "CHUNK", 512)
    j = index_arrays(jmapper.KmerIndex.build(contigs, K), False)
    t = index_arrays(tmapper.KmerIndex.build(contigs, K, device="cpu"), True)
    for a, b in zip(j[0], t[0]):
        np.testing.assert_array_equal(b, a)


def test_kmer_index_from_numpy(indexes):
    jix, tix = indexes
    (arrays, names, lengths) = index_arrays(jix, False)
    ix = convert.kmer_index_from_numpy(K, *arrays, names, lengths,
                                       device="cpu")
    for a, b in zip(index_arrays(ix, True)[0], index_arrays(tix, True)[0]):
        np.testing.assert_array_equal(a, b)


VOTE_NAMES = ("best_key", "best_count", "second_count", "qstart", "qend",
              "second_key", "qstart2", "qend2")


@pytest.mark.parametrize("seed", [21, 22])
def test_vote_kernel_matches_jax(indexes, contigs, seed):
    jix, tix = indexes
    codes, _ = sample_reads(contigs, 96, seed)
    codes = tmapper._trim_pad_columns(codes, K)
    arrays = (jix.hashes, jix.contig, jix.pos, jix.is_fwd, jix.first_row)
    want = [np.asarray(x) for x in jmapper._vote_kernel(
        arrays, (jnp.asarray(codes),), K)]
    got = [x.numpy() for x in tmapper._vote_kernel(
        tix, torch.from_numpy(codes), K)]
    for name, w, g in zip(VOTE_NAMES, want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    best_key, count, second = want[0], want[1], want[2]
    # the reads make every case: misses, both strands, ties between two
    # keys (the repeat), a second key on a near diagonal (the indels)
    assert (best_key < 0).any()
    strands = (best_key[best_key >= 0] >> 22) & 1
    assert set(strands.tolist()) == {0, 1}
    assert ((second == count) & (count > 0)).any()
    assert ((want[5] >= 0) & (want[5] >> 23 == best_key >> 23)
            & (want[5] != best_key) & (count > 0)).any()


def test_vote_kernel_tied_runs(indexes, contigs):
    """Reads wholly inside the stretch that three contigs share (four
    copies): their runs tie, and both libraries' argmax takes the first
    maximum, the run of the smallest key."""
    jix, tix = indexes
    rep = contigs[0][1][100:500]
    codes = np.full((8, L), 4, np.uint8)
    for i in range(8):
        seq = rep[40 * i:40 * i + READ_LEN]
        if i % 2:
            seq = alphabet.revcomp(seq)
        codes[i, :len(seq)] = alphabet.encode(seq)
    codes = tmapper._trim_pad_columns(codes, K)
    arrays = (jix.hashes, jix.contig, jix.pos, jix.is_fwd, jix.first_row)
    want = [np.asarray(x) for x in jmapper._vote_kernel(
        arrays, (jnp.asarray(codes),), K)]
    got = [x.numpy() for x in tmapper._vote_kernel(
        tix, torch.from_numpy(codes), K)]
    for name, w, g in zip(VOTE_NAMES, want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    best_key, count, second = want[0], want[1], want[2]
    assert (count > 0).all() and (second == count).all()
    assert (want[5] > best_key).all()


def alignment_tuples(alns):
    return [None if a is None else dataclasses.astuple(a) for a in alns]


@pytest.fixture(scope="module")
def aligned(contigs, indexes):
    """(JAX alignments, port alignments) of 400 pairs of reads from the
    contigs, in two batches."""
    jal = jmapper.KmerAligner.__new__(jmapper.KmerAligner)
    tal = tmapper.KmerAligner.__new__(tmapper.KmerAligner)
    for al, ix in ((jal, indexes[0]), (tal, indexes[1])):
        al.index, al.k, al.min_seeds = ix, K, 2
    out_j, out_t = [], []
    for b in range(2):
        codes, lengths = sample_reads(contigs, 200, 31 + b)
        ids = [f"p{b}_{i // 2}/{i % 2 + 1}" for i in range(len(codes))]
        out_j += jal.align_batch(codes, lengths, ids)
        out_t += tal.align_batch(codes, lengths, ids)
    return out_j, out_t


def test_align_batch_matches_jax(aligned):
    jal, tal = aligned
    assert alignment_tuples(tal) == alignment_tuples(jal)
    assert sum(a is not None for a in jal) > 200
    assert any(a is not None and a.cigar for a in jal)   # chained indels
    assert any(a is not None and a.rev for a in jal)


def test_fixmate_matches_jax(aligned):
    jal, tal = aligned
    jh, jlinks = jfixmate.fixmate([a for a in jal if a is not None])
    th, tlinks = tfixmate.fixmate([a for a in tal if a is not None])
    assert th.to_text() == jh.to_text()
    assert [dataclasses.astuple(x) for x in tlinks] == \
        [dataclasses.astuple(x) for x in jlinks]


def test_kmer_aligner_default_device_raises(monkeypatch, contigs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmapper.KmerAligner(contigs[:2], k=K)


# ------------------------------------------------------------ DistanceEst

def mle_case(seed, n_groups, n_range):
    """A fragment-size histogram and n_groups synthetic contig-pair
    groups: sample counts in n_range (several power-of-two buckets of
    n), true distances from -80 to 400, contig lengths 300-3000 (theta
    ranges of several power-of-two buckets of T)."""
    rng = np.random.default_rng(seed)
    frags = rng.normal(420, 45, 4000).astype(int)
    frags = [int(x) for x in frags if x > 0]
    groups = []
    for g in range(n_groups):
        n = int(rng.integers(*n_range))
        true_d = int(rng.integers(-80, 400))
        spans = rng.normal(420, 45, n).astype(int) - true_d
        groups.append((("u%d" % g, g % 2, "v%d" % g, 0),
                       [int(s) for s in spans],
                       int(rng.integers(300, 3000)),
                       int(rng.integers(300, 3000))))
    return frags, groups


@pytest.mark.parametrize("seed,n_groups,n_range", [
    (42, 70, (10, 200)), (43, 96, (3, 40)), (44, 64, (100, 600))])
def test_estimate_distances_device_matches_jax(seed, n_groups, n_range):
    frags, groups = mle_case(seed, n_groups, n_range)
    jpmf = jde.PMF.from_histogram(JHistogram.of(frags))
    tpmf = tde.PMF.from_histogram(THistogram.of(frags))
    first, last = -(len(jpmf.probs) - 1), len(jpmf.probs) - 1
    want = jde.estimate_distances_device(groups, jpmf, first, last)
    got = tde.estimate_distances_device(groups, tpmf, first, last,
                                        device="cpu")
    assert got == want
    # the groups fill several (T, n) buckets of the scan
    bounds = tde._theta_bounds(
        np.array([min(s) - 62 for _, s, _, _ in groups]),
        np.array([max(s) - 62 for _, s, _, _ in groups]),
        len(tpmf.probs), tpmf.mean, first, last)
    T = bounds[1] - bounds[0] + 1
    shapes = {(1 << int(t - 1).bit_length(),
               max(8, 1 << max(len(s) - 1, 1).bit_length()))
              for t, (_, s, _, _) in zip(T, groups)}
    assert len(shapes) >= 2


def test_estimate_distances_device_chunks():
    """max_batch_elems small enough that every bucket runs in chunks."""
    frags, groups = mle_case(45, 64, (10, 80))
    jpmf = jde.PMF.from_histogram(JHistogram.of(frags))
    tpmf = tde.PMF.from_histogram(THistogram.of(frags))
    first, last = -(len(jpmf.probs) - 1), len(jpmf.probs) - 1
    want = jde.estimate_distances_device(groups, jpmf, first, last,
                                         max_batch_elems=200_000)
    got = tde.estimate_distances_device(groups, tpmf, first, last,
                                        max_batch_elems=200_000,
                                        device="cpu")
    assert got == want


def links_for(groups):
    """PairLinks whose spans are the groups' samples (p1 = 0, a2 = 0)."""
    out = []
    for (u, su, v, sv), samples, len0, len1 in groups:
        for s in samples:
            out.append(jfixmate.PairLink(u, su, v, sv, 0, 50, s - len0, 0,
                                         len0, len1))
    return out


@pytest.mark.parametrize("n_groups", [63, 64, 90])
@pytest.mark.parametrize("mode", ["mle", "median"])
def test_estimate_distances_matches_jax(n_groups, mode):
    """The whole DistanceEst on both sides of the 64-group switch (host
    scan below, device scan from 64 up), and the median mode."""
    frags, groups = mle_case(46 + n_groups, n_groups, (10, 120))
    links = links_for(groups)
    tlinks = [tfixmate.PairLink(*dataclasses.astuple(x)) for x in links]
    want = jde.estimate_distances(links, JHistogram.of(frags), mode=mode)
    got = tde.estimate_distances(tlinks, THistogram.of(frags), mode=mode,
                                 device="cpu")
    assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
        {k: dataclasses.astuple(v) for k, v in want.items()}
    assert len(got) > n_groups // 3


# ------------------------------------------------------------ NW and dialign

def nw_pairs(seed, N, LA, LB):
    """Random pairs, half of them related (a mutated copy), BAD-padded
    after a random length; some rows of A or B all padding, N codes
    inside some rows."""
    rng = np.random.default_rng(seed)
    a = np.full((N, LA), alphabet.BAD, np.uint8)
    b = np.full((N, LB), alphabet.BAD, np.uint8)
    for i in range(N):
        la = int(rng.integers(0, LA + 1))
        lb = int(rng.integers(0, LB + 1))
        a[i, :la] = rng.integers(0, 4, la)
        if rng.random() < 0.5 and la:
            src = a[i, :la].copy()
            src[rng.random(la) < 0.1] = rng.integers(0, 4)
            lb = min(LB, la)
            b[i, :lb] = src[:lb]
        else:
            b[i, :lb] = rng.integers(0, 4, lb)
        if rng.random() < 0.2:
            a[i, rng.integers(0, LA)] = 4
    a[0] = alphabet.BAD
    b[1] = alphabet.BAD
    return a, b


@pytest.mark.parametrize("seed,N,LA,LB", [(1, 40, 30, 25), (2, 17, 64, 90),
                                          (3, 8, 1, 40), (4, 5, 50, 1)])
@pytest.mark.parametrize("scores", [(1, -1, -2), (2, -3, -1)])
def test_nw_batch_matches_jax(seed, N, LA, LB, scores):
    a, b = nw_pairs(seed, N, LA, LB)
    want = np.asarray(jnw.nw_batch(a, b, *scores))
    got = tnw.nw_batch(torch.from_numpy(a), torch.from_numpy(b), *scores)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_nw_batch_unpadded_is_nw_score():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, (6, 33), dtype=np.uint8)
    b = rng.integers(0, 4, (6, 41), dtype=np.uint8)
    got = tnw.nw_batch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.tolist() == [tnw.nw_score_np(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("n,seed", [(7, 5), (9, 6)])
def test_msa_consensus_matches_jax(n, seed, monkeypatch):
    """7 and 9 candidates (21 and 36 pairs): the all-pairs scores go
    through nw_batch."""
    rng = np.random.default_rng(seed)
    base = rnd(rng, 120)
    seqs = []
    for _ in range(n):
        c = list(base)
        for j in np.nonzero(rng.random(len(c)) < 0.04)[0]:
            c[j] = "ACGT"[rng.integers(4)]
        if rng.random() < 0.5:
            del c[int(rng.integers(10, 100))]
        seqs.append("".join(c))
    called = []

    def spy(a, b, *args):
        called.append(a.shape)
        return tnw.nw_batch(a, b, *args)

    monkeypatch.setattr(tdialign, "nw_batch", spy)
    got = tdialign.msa_consensus(seqs, 0.5, device="cpu")
    assert called and called[0][0] == n * (n - 1) // 2
    assert got == jdialign.msa_consensus(seqs, 0.5)
    assert got[0] is not None


# ------------------------------------------------------------ samtobreak

def test_contig_breakpoints_match_jax():
    """Contigs against a genome: exact pieces, reverse complements, a
    chimera of two distant pieces (a breakpoint), a piece with a 5-base
    deletion, a random contig and one shorter than k."""
    from abyss_tpu.stats import samtobreak as jstb
    from abyss_tpu_torch.stats import samtobreak as tstb
    rng = np.random.default_rng(17)
    genome = rnd(rng, 6000)
    contigs = [("a", genome[100:900]), ("b", alphabet.revcomp(genome[1000:1700])),
               ("chim", genome[2000:2400] + genome[4000:4500]),
               ("del", genome[3000:3300] + genome[3305:3700]),
               ("rand", rnd(rng, 400)), ("tiny", genome[:20])]
    want = jstb.contig_breakpoints(genome, contigs)
    got = tstb.contig_breakpoints(genome, contigs, device="cpu")
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert want.breakpoints >= 1
