"""The exact engine's chain phases, collision handling and pe knobs of
the port against abyss_tpu's, on the CPU: the cases of
tests/test_chain_ops.py, tests/test_wide_collision.py (those off the
mesh) and tests/test_pe_knobs.py as parity cases.

Chain phases: on error-laden reads with a repeat, reverse-complemented
reads, wide k and a circular genome, the port's one implementation
(dbg/chain_ops.py) gives the same removal counts, alive sets, popped
bubbles and contigs as the JAX package's device path, and the same
removal counts, alive sets, canonical popped sequences and contig dict
as the JAX package's numpy host forms (ABYSS_TPU_CHAIN=host, which only
abyss_tpu reads).  Collisions: a fingerprint collision planted
by aliasing one canonical hash onto another is detected, excised (or
fatal under ABYSS_TPU_COLLISION=raise) exactly as in abyss_tpu.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from abyss_tpu import sim
from abyss_tpu.core import alphabet
from abyss_tpu.core.histogram import Histogram
from abyss_tpu.dbg import hash_dbg as J
from abyss_tpu.ops import nthash as JN
from abyss_tpu.pipeline import pe as jpe
from abyss_tpu_torch import u64
from abyss_tpu_torch.dbg import hash_dbg as T
from abyss_tpu_torch.ops import nthash as TN
from abyss_tpu_torch.pipeline import pe as tpe
from tests.test_torch_hash_dbg import kw, random_reads
from tests.test_torch_hash_dbg_cases import assert_same, table_state

# one intra-op thread a worker process (see test_torch_hash_dbg.py)
torch.set_num_threads(1)


def _canon(s: str) -> str:
    return min(s, alphabet.revcomp(s))


def run_phases(mod, reads, k):
    t = mod.count_kmers([reads], k, strand_counts=True, **kw(mod))
    mod.apply_coverage_threshold(t, 2)
    mod.compact(t)
    mod.build_adjacency(t)
    counts = (mod.erode(t, 2, 1), mod.trim(t, k),
              mod.remove_low_coverage_contigs(t, 2.5),
              mod.erode(t, 2), mod.trim(t, k))
    popped = mod.pop_bubbles_kmer(t, 3 * k)
    contigs = mod.assemble(t)
    return t, counts, popped, contigs


@pytest.mark.parametrize("k,circular", [(25, False), (32, False), (49, False),
                                        (25, True), (40, True)])
def test_device_matches_host(k, circular, monkeypatch):
    reads = random_reads(k * 2 + circular, n=1200, glen=5000,
                         circular=circular)
    tt, tn, tpop, tc = run_phases(T, reads, k)
    for mode in ("device", "host"):
        with monkeypatch.context() as m:
            if mode == "host":
                m.setenv("ABYSS_TPU_CHAIN", "host")
            jt, jn, jpop, jc = run_phases(J, reads, k)
        assert tn == jn
        np.testing.assert_array_equal(tt.alive, jt.alive)
        if mode == "device":
            assert tpop == jpop and tc == jc
        else:
            # the host forms' chain dedup picks its own orientation
            assert sorted(map(_canon, tpop)) == sorted(map(_canon, jpop))
            assert dict(tc) == dict(jc)
    assert sum(tn) > 0 and len(tc) > 1


def test_compact_preserves_assembly():
    reads = random_reads(9, n=1200, glen=5000)
    out = {}
    for mod in (J, T):
        t1 = mod.count_kmers([reads], 25, **kw(mod))
        mod.apply_coverage_threshold(t1, 2)
        t2 = mod.count_kmers([reads], 25, **kw(mod))
        mod.apply_coverage_threshold(t2, 2)
        mod.compact(t2)
        assert t2.n == int(t1.alive.sum()) < t1.n
        for t in (t1, t2):
            mod.build_adjacency(t)
            mod.erode(t, 2)
            mod.trim(t, 25)
        c1, c2 = mod.assemble(t1), mod.assemble(t2)
        assert dict(c1) == dict(c2)
        out[mod] = (c2, table_state(t2))
    assert_same(out[T], out[J])


# --------------------------------------------------------------------------
# wide-mode fingerprint collisions (tests/test_wide_collision.py)


@pytest.fixture
def collided(monkeypatch):
    """Reads of a 1500 bp genome at k = 40 with the canonical hash of
    one k-mer aliased onto another's, in both packages' hash functions
    (the port's count launches canonical_hashes, its fill
    kmer_hashes)."""
    k = 40
    genome = sim.random_genome(1500, seed=70)
    reads = [genome[s:s + 80] for s in range(0, len(genome) - 80, 3)]
    codes = np.full((len(reads), 80), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = alphabet.encode(r)
    _, _, canon, _ = JN.kmer_hashes(jnp.asarray(codes[:1]), k)
    canon = np.asarray(canon)[0]
    a, b = np.uint64(canon[0]), np.uint64(canon[30])
    assert a != b
    ja, jb = jnp.uint64(a), jnp.uint64(b)
    ta, tb = u64.s64(int(a)), u64.s64(int(b))
    j_hashes = JN.kmer_hashes
    t_hashes, t_canonical = TN.kmer_hashes, TN.canonical_hashes

    def j_patched(codes_j, kk):
        f, r, c, v = j_hashes(codes_j, kk)
        return f, r, jnp.where(c == jb, ja, c), v

    def t_patched(codes_t, kk):
        f, r, c, v = t_hashes(codes_t, kk)
        return f, r, torch.where(c == tb, ta, c), v

    def t_canon_patched(codes_t, kk):
        c, v = t_canonical(codes_t, kk)
        return torch.where(c == tb, ta, c), v

    monkeypatch.setattr(JN, "kmer_hashes", j_patched)
    monkeypatch.setattr(TN, "kmer_hashes", t_patched)
    monkeypatch.setattr(TN, "canonical_hashes", t_canon_patched)
    return k, genome, codes, a, b


@pytest.mark.parametrize("mod", [J, T], ids=["jax", "port"])
def test_collision_raises_in_strict_mode(collided, monkeypatch, mod):
    k, genome, codes, a, b = collided
    monkeypatch.setenv("ABYSS_TPU_COLLISION", "raise")
    with pytest.raises(RuntimeError, match="collision"):
        mod.count_kmers([codes], k, **kw(mod))


def test_collision_recovery(collided, capsys):
    """The merged row is excised (present but dead) in both packages,
    with the same message, tables and contigs; every contig is a
    genome substring."""
    k, genome, codes, a, b = collided
    out = {}
    for mod in (J, T):
        t = mod.count_kmers([codes], k, **kw(mod))
        hit = np.searchsorted(t.kmers, a)
        assert t.kmers[hit] == a and not t.alive[hit]
        state = table_state(t)
        contigs = mod.assemble_table(t, kc=1, erode_cov=0)
        out[mod] = (state, contigs, capsys.readouterr().err)
    assert_same(out[T], out[J])
    n = T.count_kmers([codes], k, device="cpu").collisions
    assert n > 0 and f"({n} mismatching occurrence(s)" in out[T][2]
    contigs = out[T][1]
    grc = alphabet.revcomp(genome)
    assert sum(len(s) for s, _ in contigs) > 0.8 * len(genome)
    assert all(s in genome or s in grc for s, _ in contigs)


def test_unverified_failure_mode_is_bounded(collided):
    """verify=False: one merged row, first-seen text wins, counts
    conserved; the same table and contigs in both packages."""
    from abyss_tpu.ops.sorted_filter import SortedKmerCounter
    k, genome, codes, a, b = collided
    ctr = SortedKmerCounter(k, threshold=1)
    _, _, canon, valid = JN.kmer_hashes(jnp.asarray(codes), k)
    ctr.add(canon, valid)
    f = ctr.finalize()
    counts = np.minimum(np.asarray(f.counts), J.COVERAGE_MAX).astype(np.int32)
    out = {}
    for mod in (J, T):
        t = mod.KmerTable(k, np.array(f.kmers), counts.copy(),
                          np.ones(f.n, bool), **kw(mod))
        t = mod.fill_wide_side(t, [codes], verify=False)
        assert b not in t.kmers
        state = table_state(t)
        out[mod] = (state, mod.assemble_table(t, kc=1, erode_cov=0))
    assert_same(out[T], out[J])


def test_no_false_positive_on_clean_wide_run():
    k = 41
    genome = sim.random_genome(2000, seed=77)
    reads = []
    for s in range(0, len(genome) - 80, 5):
        r = genome[s:s + 80]
        reads.append(alphabet.revcomp(r) if (s // 5) % 2 else r)
    codes = np.full((len(reads), 80), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = alphabet.encode(r)
    tt = T.count_kmers([codes], k, device="cpu")
    jt = J.count_kmers([codes], k)
    assert tt.wide and tt.n > 0 and tt.collisions == 0
    assert tt.alive.all()
    assert_same(table_state(tt), table_state(jt))


# --------------------------------------------------------------------------
# pe's e/E/t/c/b knobs (tests/test_pe_knobs.py)


def knob_codes(genome, n_reads, read_len=80, seed=5, err=0.01):
    rng = np.random.default_rng(seed)
    g = alphabet.encode(genome)
    codes = np.full((n_reads, read_len), 4, np.uint8)
    for i in range(n_reads):
        s = rng.integers(0, len(genome) - read_len + 1)
        r = g[s:s + read_len].copy()
        bad = rng.random(read_len) < err
        r[bad] = (r[bad] + rng.integers(1, 4, bad.sum())) % 4
        if rng.random() < 0.5:
            r = alphabet.revcomp_codes(r)
        codes[i] = r
    return codes


def test_kv_parsing(tmp_path):
    argv = ["name=x", "k=31", "e=2", "E=1", "t=50", "c=3.5", "b=150",
            "in=a.fq", f"outdir={tmp_path}", "engine=exact"]
    for mod in (jpe, tpe):
        p = mod.parse_params(argv)
        assert (p.e, p.E, p.t, p.c, p.b, p.engine) == (2, 1, 50, 3.5, 150,
                                                       "exact")


KNOBS = {"auto": dict(auto_params=True, erode_cov=None, erode_strand=None,
                      min_mean_cov=None),
         "harsh": dict(erode_cov=2, erode_strand=0, tip_len=50,
                       min_mean_cov=30.0, bubble_len=126)}


@pytest.fixture(scope="module")
def knob_reads():
    return knob_codes(sim.random_genome(6000, seed=41), 3000, seed=42)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_knobs_change_engine_output(knob_reads, knobs):
    got = {}
    for mod in (J, T):
        contigs, t = mod.assemble_reads([knob_reads], 25, kc=2,
                                        **KNOBS[knobs], **kw(mod))
        got[mod] = (contigs, table_state(t))
    assert_same(got[T], got[J])
    if knobs == "harsh":
        base, _ = T.assemble_reads([knob_reads], 25, kc=2, **KNOBS["auto"],
                                   device="cpu")
        # c=30 kills everything below 30x mean coverage
        assert sorted(s for s, _ in base) != sorted(
            s for s, _ in got[T][0])


def test_auto_params_match_reference_rule():
    values = [1] * 50 + [2] * 20 + [8] * 5 + [9] * 30 + [10] * 40
    h = Histogram.of(values)
    from abyss_tpu_torch.core.histogram import Histogram as THistogram
    e, E, c = T.auto_coverage_params(THistogram.of(values))
    assert (e, E, c) == J.auto_coverage_params(h)
    assert e == int(round(max(2.0, T.coverage_threshold(THistogram.of(
        values)))))
    assert E in (0, 1) and c >= 2.0
