"""The cases of tests/test_hash_dbg.py through both packages.

Each case runs once with abyss_tpu's dbg/hash_dbg.py and once with the
port's (device="cpu"), keeps the JAX test's own assertions, and returns
what it computed (contigs, counts, every array of the tables); the two
must be equal, arrays with their dtypes.  Also the `.kmer` snapshot
both ways.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from abyss_tpu import sim
from abyss_tpu.core import alphabet
from abyss_tpu.dbg import hash_dbg as J
from abyss_tpu_torch import convert
from abyss_tpu_torch.dbg import hash_dbg as T
from tests.test_torch_hash_dbg import as_u64, kw, random_reads

# one intra-op thread a worker process (see test_torch_hash_dbg.py)
torch.set_num_threads(1)


def codes_of(seqs, L=None):
    L = L or max(len(s) for s in seqs)
    out = np.full((len(seqs), L), alphabet.BAD, np.uint8)
    for i, s in enumerate(seqs):
        c = alphabet.encode(s)
        out[i, :len(c)] = c
    return out


def table_state(t):
    """The arrays of a table, as comparable numpy values."""
    out = {n: getattr(t, n) for n in ("kmers", "counts", "alive", "nbr",
                                      "hr", "text", "fwd_counts", "cs")}
    return {n: (None if v is None else np.asarray(v)) for n, v in out.items()}


def case_pack_matches_manual(mod):
    f, rc, canon, valid = mod.pack_kmers(_codes_in(mod, codes_of(["ACGTT"])),
                                         5)
    return [as_u64(a).tolist() for a in (f, rc, canon)] + [
        mod.unpack_kmer(int(as_u64(f)[0, 0]), 5)]


def _codes_in(mod, codes):
    return torch.from_numpy(codes) if mod is T else jnp.asarray(codes)


def case_rc_packed(mod):
    rng = np.random.default_rng(0)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 21))
    f, rc, _, _ = mod.pack_kmers(_codes_in(mod, codes_of([seq])), 21)
    got = mod._rc_packed(f, 21)
    assert as_u64(got)[0, 0] == as_u64(rc)[0, 0]
    return as_u64(got).tolist()


def case_count_kmers(mod):
    t = mod.count_kmers([codes_of(["ACGTACGTAC", "ACGTACGTAC"])], 7,
                        **kw(mod))
    t2 = mod.count_kmers(
        [codes_of(["ACGTACGTAC", alphabet.revcomp("ACGTACGTAC")])], 7,
        **kw(mod))
    assert len(t.kmers) == 2 and (t.counts == 4).all()
    return table_state(t), table_state(t2)


def case_assemble_single_sequence(mod):
    genome = sim.random_genome(300, seed=3)
    t = mod.count_kmers([codes_of([genome])], 15, **kw(mod))
    mod.apply_coverage_threshold(t, 1)
    mod.build_adjacency(t)
    contigs = mod.assemble(t)
    assert [s for s, _ in contigs] in ([genome], [alphabet.revcomp(genome)])
    return contigs, table_state(t)


def case_assemble_fork_splits(mod):
    rng = np.random.default_rng(4)
    common = "".join("ACGT"[i] for i in rng.integers(0, 4, 80))
    a = common + "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    b = common + "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    t = mod.count_kmers([codes_of([a, b])], 15, **kw(mod))
    mod.build_adjacency(t)
    contigs = mod.assemble(t)
    assert 3 <= len(contigs) <= 6
    return contigs


def _paired_seqs(genome, seed, coverage, read_len, error_rate):
    pr = sim.simulate_paired_reads(genome, coverage=coverage,
                                   read_len=read_len, error_rate=error_rate,
                                   seed=seed)
    return [s for _, s, _ in pr.reads1] + [s for _, s, _ in pr.reads2]


def case_full_engine_with_errors(mod):
    genome = sim.random_genome(5000, seed=5)
    seqs = _paired_seqs(genome, 6, 40, 100, 0.005)
    batches = [codes_of(seqs[i:i + 512], L=100)
               for i in range(0, len(seqs), 512)]
    contigs, t = mod.assemble_reads(batches, 21, kc=3, erode_cov=2,
                                    **kw(mod))
    assert max(len(s) for s, _ in contigs) > 0.5 * len(genome)
    return contigs, table_state(t)


def case_coverage_threshold_model(mod):
    h = mod.Histogram()
    for c, n in [(1, 5000), (2, 800), (3, 100), (25, 200), (30, 400),
                 (35, 200), (40, 150)]:
        h.insert(c, n)
    thr = mod.coverage_threshold(h)
    assert 3 <= thr <= 10
    return thr


def _tiled(seq, mult, length, step):
    return [seq[i:i + length] for _ in range(mult)
            for i in range(0, len(seq) - length, step)]


def case_pop_bubbles_kmer(mod):
    g = sim.random_genome(600, seed=21)
    alt = g[:300] + ("A" if g[300] != "A" else "C") + g[301:]
    reads = _tiled(g, 3, 60, 7) + _tiled(alt, 1, 60, 7)
    bubbles = []
    contigs, t = mod.assemble_reads(
        [codes_of(reads, L=60)], 21, kc=1, erode_cov=0, tip_len=0,
        bubble_len=42, bubbles_out=bubbles, **kw(mod))
    assert len(bubbles) >= 1 and max(len(s) for s, _ in contigs) > 500
    return contigs, bubbles, table_state(t)


def case_remove_low_coverage_contigs(mod):
    main = sim.random_genome(400, seed=22)
    junk = sim.random_genome(120, seed=23)
    reads = _tiled(main, 4, 60, 5) + _tiled(junk, 1, 60, 5)
    contigs, t = mod.assemble_reads(
        [codes_of(reads, L=60)], 21, kc=1, erode_cov=0, tip_len=0,
        min_mean_cov=10, **kw(mod))
    assert all(len(s) > 300 for s, _ in contigs)
    return contigs, table_state(t)


def case_wide_assemble_single_sequence(mod):
    genome = sim.random_genome(400, seed=7)
    t = mod.count_kmers([codes_of([genome])], 40, **kw(mod))
    assert t.wide and t.n == len(genome) - 40 + 1
    mod.build_adjacency(t)
    contigs = mod.assemble(t)
    assert [s for s, _ in contigs] in ([genome], [alphabet.revcomp(genome)])
    return contigs, table_state(t)


def case_wide_matches_packed_at_small_k(mod):
    genome = sim.random_genome(1500, seed=11)
    batches = [codes_of(_paired_seqs(genome, 12, 20, 100, 0.0), L=100)]
    tp = mod.count_kmers(batches, 21, **kw(mod))
    tw = mod._count_kmers_wide(batches, 21, **kw(mod))
    for t in (tp, tw):
        mod.build_adjacency(t)
    cp = sorted(s for s, _ in mod.assemble(tp))
    cw = sorted(s for s, _ in mod.assemble(tw))
    assert cp == cw
    return cp, table_state(tw)


def case_wide_full_engine_k96(mod):
    genome = sim.random_genome(4000, seed=13)
    seqs = _paired_seqs(genome, 14, 40, 150, 0.002)
    batches = [codes_of(seqs[i:i + 512], L=150)
               for i in range(0, len(seqs), 512)]
    contigs, t = mod.assemble_reads(batches, 96, kc=3, erode_cov=2,
                                    **kw(mod))
    assert t.wide and max(len(s) for s, _ in contigs) > 0.5 * len(genome)
    return contigs, table_state(t)


def case_wide_snapshot_roundtrip(mod, tmp_path):
    genome = sim.random_genome(600, seed=15)
    t = mod.count_kmers([codes_of([genome])], 48, **kw(mod))
    mod.build_adjacency(t)
    p = str(tmp_path / f"{mod.__name__}.kmer.npz")
    mod.save_snapshot(t, p)
    t2 = mod.load_snapshot(p, **kw(mod))
    assert t2.wide and t2.k == 48
    c1 = sorted(s for s, _ in mod.assemble(t))
    c2 = sorted(s for s, _ in mod.assemble(t2))
    assert c1 == c2
    return c1, table_state(t2)


def case_trim_flipped_orientation_tip(mod):
    k = 25
    trunk = sim.random_genome(300, seed=77)
    tip_seq = trunk[150 - (k - 1):150] + "".join(
        "TGCA"[(i * 7 + 3) % 4] for i in range(12))
    reads = [trunk[s:s + 80] for s in range(0, len(trunk) - 80, 7)]
    reads += [alphabet.revcomp(tip_seq)] * 2
    t = mod.count_kmers([codes_of(reads, L=80)], k, **kw(mod))
    mod.apply_coverage_threshold(t, 1)
    mod.build_adjacency(t)
    removed = mod.trim(t, k)
    assert removed >= 11
    return removed, mod.assemble(t), table_state(t)


def case_trim_keeps_long_branch(mod):
    k = 25
    trunk = sim.random_genome(200, seed=78)
    branch = trunk[100 - (k - 1):100] + sim.random_genome(80, seed=79)
    reads = [trunk[s:s + 60] for s in range(0, len(trunk) - 60, 5)]
    reads += [branch[s:s + 60] for s in range(0, len(branch) - 60, 5)]
    t = mod.count_kmers([codes_of(reads, L=60)], k, **kw(mod))
    mod.apply_coverage_threshold(t, 1)
    mod.build_adjacency(t)
    before = int(t.alive.sum())
    removed = mod.trim(t, k)
    assert int(t.alive.sum()) > before - 10
    return removed, table_state(t)


def case_erode_strand_threshold(mod):
    seq = sim.random_genome(120, seed=80)
    codes = codes_of([seq] * 4)
    t = mod.count_kmers([codes], 25, strand_counts=True, **kw(mod))
    mod.build_adjacency(t)
    t2 = mod.count_kmers([codes], 25, strand_counts=True, **kw(mod))
    mod.build_adjacency(t2)
    n1 = mod.erode(t, 2, 0)
    n2 = mod.erode(t2, 2, 1)
    assert n1 == 0 and n2 == t2.n
    return n1, n2, table_state(t), table_state(t2)


def case_trim_fixpoint_equals_ladder_schedule(mod):
    """The direct t-fixpoint trim reaches the alive set and removal
    total of the 1, 2, 4, .., t ladder of abyss_tpu's host round
    (hash_dbg._trim_round) on a JAX table built the same way (one seed
    of the JAX package's slow test)."""
    genome = sim.genome_with_repeats(3000, seed=101, n_repeats=3,
                                     repeat_len=150)
    reads = sim.simulate_paired_reads(genome, coverage=25, read_len=70,
                                      error_rate=0.01, seed=102)
    batch = [s for pair in zip(reads.reads1, reads.reads2)
             for _, s, _ in pair]
    k = 21
    ta = mod.count_kmers([codes_of(batch, L=70)], k, **kw(mod))
    mod.apply_coverage_threshold(ta, 2)
    mod.build_adjacency(ta)
    mod.erode(ta, 2)
    tb = J.KmerTable(k, ta.kmers.copy(), ta.counts.copy(), ta.alive.copy())
    J.build_adjacency(tb)
    removed = mod.trim(ta, k)
    total, ln = 0, 1
    while ln < k:
        total += J._trim_round(tb, ln)
        ln *= 2
    while True:
        n = J._trim_round(tb, k)
        total += n
        if n == 0:
            break
    np.testing.assert_array_equal(ta.alive, tb.alive)
    assert removed == total > 0
    return total, table_state(ta)


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def assert_same(a, b):
    """Deep equality of nested tuples/lists/dicts holding numpy arrays."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            assert_same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a is not None and b is not None
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


@pytest.mark.parametrize("case", list(CASES))
def test_hash_dbg_case(case, tmp_path):
    fn = CASES[case]
    extra = {"tmp_path": tmp_path} if "tmp_path" in \
        fn.__code__.co_varnames[:fn.__code__.co_argcount] else {}
    assert_same(fn(T, **extra), fn(J, **extra))


def test_snapshot_both_ways(tmp_path):
    """A JAX-written `.kmer` snapshot loads in the port and a
    port-written one in abyss_tpu: equal arrays (not zip bytes), and
    both assemble to the same contigs."""
    reads = random_reads(11)
    for k in (25, 40):
        jt = J.count_kmers([reads], k)
        J.apply_coverage_threshold(jt, 2)
        J.compact(jt)
        J.build_adjacency(jt)
        tt = T.count_kmers([reads], k, device="cpu")
        T.apply_coverage_threshold(tt, 2)
        T.compact(tt)
        T.build_adjacency(tt)
        jp, tp = str(tmp_path / f"j{k}.kmer"), str(tmp_path / f"t{k}.kmer")
        J.save_snapshot(jt, jp)
        T.save_snapshot(tt, tp)
        from_j = T.load_snapshot(jp, device="cpu")
        from_t = J.load_snapshot(tp)
        assert_same(table_state(from_j), table_state(J.load_snapshot(jp)))
        assert_same(table_state(from_t), table_state(T.load_snapshot(
            tp, device="cpu")))
        assert T.assemble(from_j) == J.assemble(from_t) == J.assemble(jt)
        # an in-memory JAX table through convert
        conv = convert.kmer_table_from_numpy(
            jt.k, jt.kmers, jt.counts, jt.alive, nbr=jt.nbr, hr=jt.hr,
            text=jt.text, fwd_counts=jt.fwd_counts, cs=jt.cs,
            device="cpu")
        assert_same(table_state(conv), table_state(jt))
        assert T.assemble(conv) == J.assemble(jt)
