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


# ------------------------------------------- the decision, from hand votes

def vote_row(c=1, s=0, diag=500, count=20, qs=0, qe=60, c2=None, s2=None,
             ddiag=0, second=0, qs2=0, qe2=0, best=True, runner=True):
    """One read's vote: the best key (contig c, strand s, diagonal diag)
    and a runner-up ddiag diagonals away, on contig c2 and strand s2
    (c and s unless given); best/runner False make that key a miss."""
    c2 = c if c2 is None else c2
    s2 = s if s2 is None else s2
    key = (((c << 1) | s) << 22) + diag + tmapper.DIAG_OFF
    key2 = (((c2 << 1) | s2) << 22) + diag + ddiag + tmapper.DIAG_OFF
    return (key if best else -1, count, second, qs, qe,
            key2 if runner else -1, qs2, qe2)


def tie_rows():
    """Counts on both sides of the 0.9 multimapping rule, with every
    10 * second == 9 * count from 10 to 300; runners-up on another
    contig, so no chain."""
    rows = []
    for count in range(2, 301):
        for second in {count * 9 // 10 - 1, count * 9 // 10,
                       count * 9 // 10 + 1, count - 1, count}:
            if 0 <= second <= count:
                rows.append(vote_row(count=count, second=second, c2=2,
                                     qs=0, qe=100))
    return rows


# each case: its votes, and whether the first read maps ungapped
# ("ungapped"), chains ("chained") or is None ("none"); qs/qe/qs2/qe2
# are read coordinates of the 100-base reads, k = 32
DECIDE_CASES = {
    "fwd_chain_clip": ([vote_row(ddiag=3, second=10, qs2=50, qe2=100)],
                       "chained"),
    "fwd_chain_swap": ([vote_row(qs=50, qe=100, ddiag=-3, second=10,
                                 qs2=0, qe2=60)], "chained"),
    "rev_chain": ([vote_row(s=1, diag=1000, qe=50, ddiag=-3, second=10,
                            qs2=50, qe2=100)], "chained"),
    "rev_chain_swap": ([vote_row(s=1, diag=1000, qs=40, qe=100, ddiag=5,
                                 second=9, qs2=0, qe2=45)], "chained"),
    "rev_tgap_negative": ([vote_row(s=1, diag=1000, qe=50, ddiag=3,
                                    second=10, qs2=50, qe2=100)],
                          "ungapped"),
    "fwd_insertion": ([vote_row(qe=40, ddiag=-3, second=10, qs2=43,
                                qe2=100)], "chained"),
    "fwd_tgap_negative": ([vote_row(qe=50, ddiag=-3, second=10, qs2=50,
                                    qe2=100)], "ungapped"),
    "overlap_beyond_k": ([vote_row(qe=80, ddiag=2, second=10, qs2=40,
                                   qe2=100)], "ungapped"),
    "overlap_same_start": ([vote_row(qs=10, qe=30, ddiag=2, second=10,
                                     qs2=10, qe2=90)], "ungapped"),
    "ddiag_0": ([vote_row(ddiag=0, second=10, qs2=60, qe2=100)],
                "ungapped"),
    "ddiag_64": ([vote_row(qe=40, ddiag=64, second=10, qs2=40, qe2=100)],
                 "chained"),
    "ddiag_-64": ([vote_row(s=1, diag=2000, qe=40, ddiag=-64, second=10,
                            qs2=40, qe2=100)], "chained"),
    "ddiag_65": ([vote_row(qe=40, ddiag=65, second=10, qs2=40, qe2=100)],
                 "ungapped"),
    "ddiag_-65": ([vote_row(s=1, diag=2000, qe=40, ddiag=-65, second=10,
                            qs2=40, qe2=100)], "ungapped"),
    "runner_other_contig": ([vote_row(c2=3, ddiag=3, second=10, qs2=50,
                                      qe2=100)], "ungapped"),
    "runner_other_strand": ([vote_row(s2=1, ddiag=3, second=10, qs2=50,
                                      qe2=100)], "ungapped"),
    "runner_few_seeds": ([vote_row(ddiag=3, second=1, qs2=50, qe2=100)],
                         "ungapped"),
    "runner_miss": ([vote_row(runner=False, second=10)], "ungapped"),
    "count_below_min_seeds": ([vote_row(count=1)], "none"),
    "best_key_miss": ([vote_row(best=False)], "none"),
    "multimapping_tie": ([vote_row(count=20, second=20, c2=2)],
                         "ungapped"),
    "tie_rule": (tie_rows(), "ungapped"),
}


@pytest.mark.parametrize("case", list(DECIDE_CASES))
def test_decide_matches_jax(case, indexes, monkeypatch):
    """The columnar decision of the port (`_decide`, through
    align_batch) against the JAX package's per-read host loop, both fed
    the same hand-built votes: every branch of the two-diagonal chain,
    and the float64 0.9 rule at and around its ties."""
    rows, kind = DECIDE_CASES[case]
    votes = [np.array(col, np.int64) for col in zip(*rows)]
    n = len(rows)
    monkeypatch.setattr(jmapper, "_vote_kernel",
                        lambda *a: tuple(votes))
    monkeypatch.setattr(tmapper, "_vote_kernel",
                        lambda *a: tuple(torch.from_numpy(v) for v in votes))
    jal = jmapper.KmerAligner.__new__(jmapper.KmerAligner)
    tal = tmapper.KmerAligner.__new__(tmapper.KmerAligner)
    for al, ix in ((jal, indexes[0]), (tal, indexes[1])):
        al.index, al.k, al.min_seeds = ix, K, 2
    codes = np.full((n, L), 4, np.uint8)
    lengths = np.full(n, READ_LEN, np.int32)
    ids = [f"r{i}" for i in range(n)]
    want = jal.align_batch(codes, lengths, ids)
    got = tal.align_batch(codes, lengths, ids)
    assert alignment_tuples(got) == alignment_tuples(want)
    first = want[0]
    assert kind == ("none" if first is None else
                    "chained" if first.cigar else "ungapped")
    cols = tal.align_columns(codes, lengths, n)
    assert cols.dtype == np.int32 and cols.shape == (len(tmapper.FIELDS), n)
    assert (cols[tmapper.CHAINED] == [a is not None and a.cigar is not None
                                      for a in want]).all()
    if case == "tie_rule":
        count, second = votes[1], votes[2]
        mapq = np.array([a.mapq for a in want])
        assert ((mapq == 0) == (second >= 0.9 * count)).all()
        tie = 10 * second == 9 * count
        assert tie.sum() >= 25 and (mapq[tie] == 0).all()
        assert (mapq > 0).any()


# ---------------------------------------------------- fixmate, by columns

def aln_rows(rng, n_keys, names):
    """(qname, rname, rev, pos, qstart, qend, mapq) rows or None: mate
    names from n_keys keys in a random order, each key's names drawn
    from key, key/1 and key/2 and seen 1 to 4 times, on contigs of
    `names`, some unmapped."""
    out = []
    for k in range(n_keys):
        for _ in range(int(rng.integers(1, 5))):
            q = f"q{k}" + ("", "/1", "/2")[rng.integers(3)]
            if rng.random() < 0.1:
                out.append((q, None))
                continue
            out.append((q, (names[rng.integers(len(names))],
                            bool(rng.integers(2)), int(rng.integers(0, 900)),
                            int(rng.integers(0, 20)),
                            int(rng.integers(60, 100)),
                            int(rng.choice([0, 3, 60])))))
    return [out[i] for i in rng.permutation(len(out))]


def hand_rows():
    """By hand: key "a" three times and "b" four times, interleaved; an
    unmapped mate; FF and RR pairs; mapq 0 on a cross-contig pair; mate
    names without a suffix, in the order /2 then /1, a bare key with
    key/1, a two-character name "/1" (kept whole) and "c/3"."""
    def m(rname, rev, pos, mapq=60):
        return (rname, rev, pos, 5, 95, mapq)
    return [("a/1", m("u", False, 100)), ("b/1", m("u", False, 10)),
            ("a/2", m("u", True, 400)), ("b/2", m("v", True, 50)),
            ("a/1", m("v", False, 20)), ("b/1", m("u", True, 500)),
            ("b/2", m("u", False, 200)), ("b/1", m("v", False, 30)),
            ("a/2", m("v", True, 300)),
            ("d/1", None), ("d/2", m("u", False, 7)),
            ("ff/1", m("u", False, 10)), ("ff/2", m("u", False, 300)),
            ("rr/1", m("v", True, 10)), ("rr/2", m("v", True, 300)),
            ("z/1", m("u", False, 10, mapq=0)), ("z/2", m("v", True, 60)),
            ("x", m("u", True, 600)), ("x", m("u", False, 100)),
            ("y/2", m("v", True, 700)), ("y/1", m("u", False, 30)),
            ("w", m("u", False, 40)), ("w/1", m("v", True, 90)),
            ("/1", m("u", False, 1)), ("/1", m("v", False, 2)),
            ("c/3", m("u", False, 100)), ("c/3", m("u", True, 400))]


FIXMATE_CASES = {
    "by_hand": lambda: hand_rows(),
    "random_one_contig": lambda: aln_rows(np.random.default_rng(5), 150,
                                          ["u"]),
    "random_three_contigs": lambda: aln_rows(np.random.default_rng(6), 300,
                                             ["u", "v", "w"]),
}


@pytest.mark.parametrize("case", list(FIXMATE_CASES))
def test_fixmate_columns_match_jax(case):
    """The columnar pairing, from a list of Alignments and from the
    mapper's block, against `abyss_tpu.align.fixmate`'s dict loop: the
    same histogram (its text and its insertion order) and the same
    PairLinks in the same order."""
    rows = FIXMATE_CASES[case]()
    rlen = {"u": 1000, "v": 1500, "w": 900}
    jal, tal = [], []
    for q, a in rows:
        if a is None:
            jal.append(None)
            tal.append(None)
            continue
        rname, rev, pos, qs, qe, mapq = a
        kw = dict(qname=q, rname=rname, rev=rev, pos=pos, qstart=qs,
                  qend=qe, read_len=100, score=qe - qs, mapq=mapq,
                  rlen=rlen[rname])
        jal.append(jmapper.Alignment(**kw))
        tal.append(tmapper.Alignment(**kw))
    jh, jlinks = jfixmate.fixmate([a for a in jal if a is not None])
    want = (jh.to_text(), list(jh.counts.items()),
            [dataclasses.astuple(x) for x in jlinks])
    th, tlinks = tfixmate.fixmate(tal)
    assert (th.to_text(), list(th.counts.items()),
            [dataclasses.astuple(x) for x in tlinks]) == want
    # the mapper's block of the same reads: contig i of contig_names
    contig_names = sorted(rlen)
    cols = np.zeros((len(tmapper.FIELDS), len(rows)), np.int32)
    for i, a in enumerate(tal):
        if a is not None:
            cols[[tmapper.MAPPED, tmapper.CONTIG, tmapper.REV, tmapper.POS,
                  tmapper.QSTART, tmapper.QEND, tmapper.MAPQ], i] = (
                1, contig_names.index(a.rname), a.rev, a.pos, a.qstart,
                a.qend, a.mapq)
    ch, clinks = tfixmate.fixmate_columns(
        cols, [q for q, _ in rows], contig_names,
        [rlen[n] for n in contig_names])
    assert (ch.to_text(), list(ch.counts.items()),
            [dataclasses.astuple(x) for x in clinks]) == want
    assert jh.size() > 0
    if case != "random_one_contig":
        assert jlinks


def test_align_columns_fixmate_matches_jax(contigs, indexes, aligned):
    """The mapper's block of the `aligned` fixture's reads, paired as it
    stands, gives the JAX package's fixmate of its alignments."""
    tal = tmapper.KmerAligner.__new__(tmapper.KmerAligner)
    tal.index, tal.k, tal.min_seeds = indexes[1], K, 2
    blocks, ids = [], []
    for b in range(2):
        codes, lengths = sample_reads(contigs, 200, 31 + b)
        ids += [f"p{b}_{i // 2}/{i % 2 + 1}" for i in range(len(codes))]
        blocks.append(tal.align_columns(codes, lengths, len(codes)))
    th, tlinks = tfixmate.fixmate_columns(
        np.concatenate(blocks, axis=1), ids, tal.index.names,
        tal.index.lengths)
    jh, jlinks = jfixmate.fixmate([a for a in aligned[0] if a is not None])
    assert th.to_text() == jh.to_text() and jh.size() > 0
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
