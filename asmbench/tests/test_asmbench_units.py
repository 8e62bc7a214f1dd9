"""The benchmark's arithmetic on inputs whose answers are known."""

import numpy as np
import pytest
import torch

from asmbench import gen, reference, roofline, run, trace
from asmbench.contiguity import ng50


def test_generators_repeat_for_a_seed():
    g1 = gen.genome_with_repeats(30000, 7, 12, 700)
    g2 = gen.genome_with_repeats(30000, 7, 12, 700)
    assert np.array_equal(g1, g2)
    assert not np.array_equal(g1, gen.genome_with_repeats(30000, 8, 12, 700))
    a = gen.simulate_pairs(g1, 500, 250, 600, 60, 0.005, 2 ** 33 + 5)
    b = gen.simulate_pairs(g1, 500, 250, 600, 60, 0.005, 2 ** 33 + 5)
    c = gen.simulate_pairs(g1, 500, 250, 600, 60, 0.005, 2 ** 33 + 6)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    # a run's seed reorders the pairs of one sample: the same work
    o1, o2 = gen.arrival_order(a, 5), gen.arrival_order(a, 6)
    assert not np.array_equal(o1[0], o2[0])
    for o in (o1, o2):
        pairs = sorted(map(bytes, np.concatenate(o, axis=1)))
        assert pairs == sorted(map(bytes, np.concatenate(a, axis=1)))


def test_reads_lie_on_the_genome():
    g = gen.genome_with_repeats(20000, 3, 4, 500)
    r1, r2 = gen.simulate_pairs(g, 200, 250, 600, 60, 0.0, 9)
    text = gen.decode(g)
    for row in r1[:20]:
        assert gen.decode(row) in text
    for row in r2[:20]:
        assert gen.decode(gen.revcomp_codes(row)) in text


def test_fastq_and_fasta_text(tmp_path):
    rows = np.array([[0, 1, 2, 3], [3, 2, 1, 0]], np.uint8)
    path = tmp_path / "r.fq"
    gen.write_fastq(str(path), rows, 2)
    assert path.read_bytes() == (b"@sim_0/2\nACGT\n+\nIIII\n"
                                 b"@sim_1/2\nTGCA\n+\nIIII\n")
    assert gen.parse_fasta(b">0 8 3 read:x\nACGT\nACGT\n>1 2 0\nAC\n") == [
        ("0 8 3 read:x", b"ACGTACGT"), ("1 2 0", b"AC")]


@pytest.mark.parametrize("lengths, genome, want", [
    ([1000, 2000, 3000, 4000], 10000, 3000),
    ([1000, 2000, 3000, 4000], 20000, 1000),  # all together under G/2
    ([100, 400, 600, 5000], 6000, 5000),      # under 500 left out
    ([600, 600, 600], 1200, 600),
    ([], 1000, 0),
])
def test_ng50(lengths, genome, want):
    assert ng50(lengths, genome) == want


def test_read_rate():
    # 3 jobs of 184 Mbp in 120 s
    assert run.read_rate(184_000_000, 3, 120.0) == pytest.approx(4.6)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (6.0, 7.0)]
    assert trace.union_seconds(iv) == pytest.approx(4.0)
    assert trace.idle_gaps(iv, 0.0, 8.0) == [(2.0, 3.0), (4.0, 6.0),
                                             (7.0, 8.0)]
    assert trace.idle_gaps(iv, 0.5, 3.2) == [(2.0, 3.0)]


def test_profile_reduction():
    ops = [("nthash_kernel(x)", 1.0, 1.5), ("walk_kernel<A>", 2.0, 4.0),
           ("Memcpy HtoD", 3.5, 5.0), ("nthash_kernel(x)", 9.0, 9.5),
           ("late", 11.0, 12.0)]
    spans = [("pe.stage_graph_2_3", 0.0, 6.0), ("pe._map_library", 5.0, 9.0)]
    p = trace.Profile(ops, spans, (0.0, 10.0))
    assert p.window_s() == 10.0
    assert p.busy_s() == pytest.approx(0.5 + 3.0 + 0.5)
    assert p.kernel_seconds(lambda n: "nthash" in n) == pytest.approx(1.0)
    assert p.top_ops(2) == [["walk_kernel<A>", 2.0], ["Memcpy HtoD", 1.5]]
    # gaps: [0,1) [1.5,2) in stage 2-3; [5,9) in the mapping; [9.5,10)
    idle = dict(p.idle_by_span())
    assert idle["pe.stage_graph_2_3"] == pytest.approx(1.5)
    assert idle["pe._map_library"] == pytest.approx(4.0)
    assert idle["job"] == pytest.approx(0.5)


def test_nthash_bytes_by_hand():
    # 2 rows of 10 codes at k = 4: 7 windows a row; 20 code bytes read,
    # 14 canon words (8 bytes) and 14 valid bytes written
    assert roofline.nthash_bytes(2, 10, 4, False) == 20 + 14 * 9
    # with strands, fwd and rev words too
    assert roofline.nthash_bytes(2, 10, 4, True) == 20 + 14 * 25
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)


def _canon(s: str) -> str:
    rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
    return min(s, rc)


@pytest.mark.parametrize("k", [5, 32, 33, 70, 96])
def test_kmer_keys_match_strings(k):
    rng = np.random.default_rng(k)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (150, 97, 40)]
    seqs[0][60] = 4  # an N
    flat = reference.flat_codes(seqs)
    keys, starts = reference.kmer_keys(flat, k, "cpu")
    text = gen.decode(flat)
    want = [i for i in range(len(text) - k + 1) if "N" not in text[i:i + k]]
    assert starts.tolist() == want
    # equal keys exactly when equal canonical strings
    strs = [_canon(text[i:i + k]) for i in want]
    ids = {}
    for row, s in zip(map(tuple, keys.tolist()), strs):
        assert ids.setdefault(row, s) == s
    assert len(ids) == len(set(strs))


def test_join_counts():
    a = torch.tensor([[1, 2], [1, 2], [3, 4], [5, 6]])
    b = torch.tensor([[1, 2], [7, 8]])
    c = torch.tensor([[3, 4], [1, 2], [1, 2]])
    cb, cc = reference.join_counts([a, b, c])
    assert cb.tolist() == [[2, 1, 2], [0, 1, 0]]
    assert cc.tolist() == [[1, 0, 1], [2, 1, 2], [2, 1, 2]]


def test_reference_numbers_on_a_known_assembly():
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, 400).astype(np.uint8)
    # error-free reads: every k-mer of the genome at least twice
    reads = np.stack([genome[i:i + 100] for i in range(0, 301, 10)])
    k = 40
    ref = reference.Reference([reads, reads], genome, k, "cpu")
    seq = gen.decode(genome).encode()
    keys, _ = reference.kmer_keys(reference.rows_flat(
        np.concatenate([reads, reads])), k, "cpu")
    gk, _ = reference.kmer_keys(reference.flat_codes([genome]), k, "cpu")
    (counts,) = reference.join_counts([keys, gk])
    cov = int(counts[:, 0].sum())
    good = ref.unitig_numbers([(f"0 400 {cov}", seq)], 2)
    assert good == {"cov_mismatch": 0, "unsolid_kmers": 0, "genome_miss": 0.0}
    bad = bytearray(seq)
    bad[200] = ord("A") if bad[200] != ord("A") else ord("C")
    nums = ref.unitig_numbers([(f"0 400 {cov}", bytes(bad))], 2)
    assert nums["cov_mismatch"] == 1 and nums["unsolid_kmers"] == k
    half = ref.unitig_numbers([("0 200 1", seq[:200])], 2)
    assert half["genome_miss"] == pytest.approx(1 - (200 - k + 1) / (400 - k + 1))
    scaf = ref.scaffold_numbers([("0", seq[:150] + b"N" * 10 + seq[160:])])
    assert scaf["scaffold_novel_kmers"] == 0
    # one scaffold under abyss-fac's 500 bp: nothing counts toward NG50
    assert scaf["scaffold_ng50_kbp"] == 0


def test_compare_and_job_numbers():
    from asmbench import check
    rows = check.compare({"a": 0, "b": 0.5, "c": 3, "d": 7},
                         {"a": 0, "b": 1.0, "d": {"min": 5}})
    assert rows == [("a", 0, "<=", 0), ("b", 0.5, "<=", 1.0),
                    ("d", 7, ">=", 5)] and check.passed(rows)
    assert not check.passed(check.compare({"d": 4}, {"d": {"min": 5}}))
    # a limit whose number was never read fails, a maximum or a minimum
    rows = check.compare({"a": 0}, {"a": 0, "z": 0})
    assert not check.passed(rows)
    assert not check.passed(check.compare({}, {"d": {"min": 5}}))
    outs = [{"final": b">0\nAC\n"}, None, {"final": b">0\nAC\n"},
            {"final": b">0\nAG\n"}]
    assert check.job_numbers(outs) == {"failed_jobs": 1, "fasta_differs": 1}
