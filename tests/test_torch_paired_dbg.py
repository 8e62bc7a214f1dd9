"""The port's paired DBG (dbg/paired_dbg.py) against abyss_tpu's, on
the CPU, bit for bit (integers throughout: the tolerance is exact).

The cases of tests/test_pipeline.py::test_paired_dbg_wide_mode_matches_packed
and ::test_paired_dbg_large_k as parity cases, error-laden reads at
k = 16 (pairs that set bit 63) and at the zero gap K = 2k, a genome
with rc-palindromic pair windows, circular genomes (cycles in the
links, of 2^10 vertices in one), chains too short to fix every base,
and each device function of the packed and wide modes against its JAX
function, with argmax ties in the successor links; the packed chain
order and trim round against the JAX package's host ranking.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from abyss_tpu import sim
from abyss_tpu.core import alphabet
from abyss_tpu.dbg import hash_dbg as JH
from abyss_tpu.dbg import paired_dbg as J
from abyss_tpu_torch import u64
from abyss_tpu_torch.dbg import paired_dbg as T
from abyss_tpu_torch.utils import trace
from tests.test_torch_hash_dbg import as_int, as_u64, random_reads

torch.set_num_threads(1)


def tiled_reads(genome: str, L: int, step: int = 3) -> np.ndarray:
    reads = [genome[s:s + L] for s in range(0, len(genome) - L, step)]
    codes = np.full((len(reads), L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = alphabet.encode(r)
    return codes


def palindromic_genome(n: int, seed: int) -> str:
    """A random genome with rc-palindromes of 16 and 40 bases inside."""
    g = sim.random_genome(n, seed=seed)
    p8 = sim.random_genome(8, seed=seed + 1)
    p20 = sim.random_genome(20, seed=seed + 2)
    pal = p8 + alphabet.revcomp(p8)
    pal2 = p20 + alphabet.revcomp(p20)
    return g[:n // 3] + pal + g[n // 3:2 * n // 3] + pal2 + g[2 * n // 3:]


def circular_reads(n: int, seed: int, L: int = 90, step: int = 3):
    """Reads tiled around a circular genome of n bases: its pair graph
    is two cycles of n oriented vertices."""
    g = sim.random_genome(n, seed=seed)
    return tiled_reads(g + g[:L], L, step)


def palindromic_pair_reads(seed: int, k: int, K: int):
    """Reads of a genome holding one pair window a + gap + rc(a), a pair
    that is its own reverse complement."""
    g = sim.random_genome(1500, seed=seed)
    a = sim.random_genome(k, seed=seed + 1)
    gap = sim.random_genome(K - 2 * k, seed=seed + 2)
    return tiled_reads(g[:700] + a + gap + alphabet.revcomp(a) + g[700:],
                       90, 2)


def _t(codes):
    return torch.from_numpy(np.ascontiguousarray(codes, np.uint8))


def assert_tables(jt, tt, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      np.asarray(getattr(tt, f)), err_msg=f)


# --------------------------------------------------------------------------
# whole assemblies


def _cases():
    wide_vs_packed = tiled_reads(sim.random_genome(1200, seed=50), 70)
    large_k = tiled_reads(sim.random_genome(2000, seed=51), 80)
    pal = tiled_reads(palindromic_genome(1500, 52), 90, step=2)
    err = random_reads(53, n=700, L=100, glen=2500, err=0.004,
                       n_rate=0.001)
    return {
        "pipeline_packed_k14_K40": (wide_vs_packed, 14, 40, 1),
        "pipeline_large_k25_K50": (large_k, 25, 50, 1),
        "palindromes_k8_K30": (pal, 8, 30, 1),
        "palindromes_k20_K40_zero_gap": (pal, 20, 40, 1),
        "errors_k16_K32_zero_gap": (err, 16, 32, 2),
        "errors_k16_K48": (err, 16, 48, 2),
        "errors_k31_K80": (err, 31, 80, 2),
        # 2 x 1024 oriented vertices: cycles of 2^10, each member its own
        # chain (hash_dbg._pointer_double's rule)
        "circular_1024_k12_K40": (circular_reads(1024, 80), 12, 40, 2),
        "circular_1500_k16_K48": (circular_reads(1500, 81), 16, 48, 2),
        # chains shorter than K - 2k + 1 vertices leave an N gap
        "n_gap_k8_K48": (random_reads(82, n=500, L=100, glen=1500,
                                      err=0.01), 8, 48, 1),
        "zero_gap_k12_K24_kc1": (random_reads(83, n=500, L=100, glen=1500,
                                              err=0.004), 12, 24, 1),
        "palindromic_pair_k16_K40": (palindromic_pair_reads(84, 16, 40),
                                     16, 40, 1),
        # no solid pair: the JAX package's one all-N contig
        "no_solid_pair_k16_K48": (err, 16, 48, 1000),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_assemble_pairs_matches_jax(case):
    codes, k, K, kc = _cases()[case]
    want = J.assemble_pairs([codes], k, K, kc=kc)
    got = T.assemble_pairs([codes], k, K, kc=kc, device="cpu")
    assert got == want
    assert want


@pytest.mark.parametrize("case,what", [
    ("circular_1024_k12_K40", "cycles"), ("circular_1500_k16_K48", "cycles"),
    ("n_gap_k8_K48", "n_gap"), ("palindromic_pair_k16_K40", "palindrome")])
def test_assemble_pairs_case_shapes(case, what):
    """The packed cases above hold what they are there for: cycles in
    the final links (counted by `paired.cycle_vertices`), an N gap in a
    contig, a palindromic pair row."""
    codes, k, K, kc = _cases()[case]
    with trace.recording() as records:
        got = T.assemble_pairs([codes], k, K, kc=kc, device="cpu")
    counts = trace.counter_totals(records)
    assert counts["paired.contigs"] == len(got)
    if what == "cycles":
        assert counts["paired.cycle_vertices"] == 2 * counts["paired.rows"]
    else:
        assert counts["paired.cycle_vertices"] == 0
    if what == "n_gap":
        assert any("N" in seq for seq, _ in got)
    if what == "palindrome":
        kmers = u64.from_numpy(T.count_pairs([codes], k, K,
                                             device="cpu").kmers)
        assert (T._rc_pair(kmers, k) == kmers).sum() == 1


@pytest.mark.parametrize("case", ["pipeline_packed_k14_K40",
                                  "palindromes_k8_K30",
                                  "errors_k16_K32_zero_gap"])
def test_assemble_pairs_wide_matches_jax(case):
    """Wide mode at k <= 16 too, as test_paired_dbg_wide_mode_matches_packed
    runs it."""
    codes, k, K, kc = _cases()[case]
    want = J.assemble_pairs_wide([codes], k, K, kc=kc)
    with trace.recording() as records:
        got = T.assemble_pairs_wide([codes], k, K, kc=kc, device="cpu")
    assert got == want
    counts = trace.counter_totals(records)
    assert counts["paired.rows"] >= counts["paired.rows_kc"] > 0
    assert {"paired.count", "paired.kc_filter", "paired.fill",
            "paired.probe", "paired.trim", "paired.chains",
            "paired.emission"} <= set(trace.span_seconds(records))


def test_assemble_pairs_tip_len_and_batches():
    codes, k, K, kc = _cases()["errors_k16_K48"]
    batches = [codes[:300], codes[300:]]
    for tip in (0, 5):
        assert T.assemble_pairs(batches, k, K, kc=kc, tip_len=tip,
                                device="cpu") == \
            J.assemble_pairs(batches, k, K, kc=kc, tip_len=tip)
    codes, k, K, kc = _cases()["errors_k31_K80"]
    batches = [codes[:250], codes[250:]]
    assert T.assemble_pairs(batches, k, K, kc=kc, tip_len=0,
                            device="cpu") == \
        J.assemble_pairs(batches, k, K, kc=kc, tip_len=0)


def test_assemble_pairs_errors():
    codes = np.zeros((2, 40), np.uint8)
    for fn in (J.pack_pairs, T.pack_pairs):
        arg = jnp.asarray(codes) if fn is J.pack_pairs else _t(codes)
        with pytest.raises(ValueError):
            fn(arg, 17, 40)
        with pytest.raises(ValueError):
            fn(arg, 12, 20)
        with pytest.raises(ValueError):
            fn(arg, 10, 41)


# --------------------------------------------------------------------------
# packed-mode device functions


@pytest.mark.parametrize("k,K", [(16, 40), (16, 32), (9, 25)])
def test_pack_pairs_matches_jax(k, K):
    codes = random_reads(60 + k, n=40, L=90, n_rate=0.01)
    jo = J.pack_pairs(jnp.asarray(codes), k, K)
    to = T.pack_pairs(_t(codes), k, K)
    for ja, ta in zip(jo[:3], to[:3]):
        np.testing.assert_array_equal(as_u64(ja), as_u64(ta))
    np.testing.assert_array_equal(np.asarray(jo[3]), to[3].numpy())
    if k == 16:   # pairs of k = 16 fill all 64 bits
        assert (as_u64(to[2]) >> np.uint64(63)).any()


@pytest.mark.parametrize("k", [5, 16])
def test_rc_pair_matches_jax(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 1 << (4 * k) if k < 16 else 2**64 - 1, 500,
                     dtype=np.uint64)
    np.testing.assert_array_equal(
        np.asarray(J._rc_pair(jnp.asarray(x), k)),
        as_u64(T._rc_pair(u64.from_numpy(x), k)))


@pytest.mark.parametrize("k,K,kc", [(16, 40, 2), (16, 32, 1), (8, 30, 1)])
def test_count_and_adjacency_match_jax(k, K, kc):
    codes = _cases()["errors_k16_K32_zero_gap"][0] if k == 16 else \
        _cases()["palindromes_k8_K30"][0]
    batches = [codes[:200], codes[200:]]
    jt = J.count_pairs(batches, k, K)
    tt = T.count_pairs(batches, k, K, device="cpu")
    assert_tables(jt, tt, ["kmers", "counts", "alive"])
    jt.alive &= jt.counts >= kc
    tt.alive &= tt.counts >= kc
    np.testing.assert_array_equal(J.build_pair_adjacency(jt, k),
                                  T.build_pair_adjacency(
                                      u64.from_numpy(tt.kmers), k).T.numpy())


def links_and_degrees(seed, rows=700):
    """Successor links over 2 * rows oriented vertices as the pair graph
    has them: chains, one-vertex stubs, self-links and cycles of 1, 2,
    3, 4, 8 and more vertices among the alive rows, each with its
    reverse-complement twin (u -> v and v^1 -> u^1); dead rows with no
    link and degree 0.  A linked vertex has out-degree 1 (so its target
    in-degree 1); an unlinked one 0-2.  Returns (nxt, alive, right_deg,
    left_deg, vertices on cycles)."""
    rng = np.random.default_rng(seed)
    alive = rng.random(rows) > 0.1
    live = rng.permutation(np.flatnonzero(alive))
    nxt = np.full(2 * rows, -1, np.int64)
    on_cycle = i = 0
    while i < len(live):
        seg = live[i:i + int(rng.choice([1, 2, 3, 4, 5, 8, 8, 30, 100]))]
        ov = 2 * seg + rng.integers(0, 2, len(seg))
        if rng.random() < 0.4:       # close it into a cycle
            ov = np.append(ov, ov[0])
            on_cycle += 2 * len(seg)
        nxt[ov[:-1]] = ov[1:]
        nxt[ov[1:] ^ 1] = ov[:-1] ^ 1
        i += len(seg)
    outdeg = np.where(nxt >= 0, 1, rng.integers(0, 3, 2 * rows))
    outdeg = np.where(np.repeat(alive, 2), outdeg, 0)
    return nxt, alive, outdeg[0::2], outdeg[1::2], on_cycle


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pair_chain_order_matches_host_ranking(seed):
    """The device chain order equals hash_dbg._pointer_double then
    lexsort, as the JAX package orders the chains, cycles of 2^j
    vertices (each member its own chain) included."""
    nxt, alive, _, _, on_cycle = links_and_degrees(seed)
    head, pos = JH._pointer_double(nxt)
    order = np.lexsort((pos, head))
    order = order[np.repeat(alive, 2)[order]]
    heads = head[order]
    want_start = np.concatenate([[True], heads[1:] != heads[:-1]])
    with trace.recording() as records:
        ov_s, start = T._pair_chain_order(torch.from_numpy(nxt),
                                          torch.from_numpy(alive))
    np.testing.assert_array_equal(ov_s.numpy(), order)
    np.testing.assert_array_equal(start.numpy(), want_start)
    assert trace.counter_totals(records)["paired.cycle_vertices"] == \
        on_cycle > 0
    # the members of cycles of 2, 4 and 8 vertices are one-vertex chains
    lengths = np.diff(np.append(np.flatnonzero(want_start), len(order)))
    alone = set(order[np.flatnonzero(want_start)[lengths == 1]].tolist())
    pow2 = set()
    for v in np.flatnonzero(nxt >= 0):
        n, w = 1, nxt[v]
        while w != v and w >= 0 and n <= 8:
            n, w = n + 1, nxt[w]
        if w == v and n in (2, 4, 8):
            pow2.add(int(v))
    assert pow2 and pow2 <= alone


@pytest.mark.parametrize("seed", [6, 7])
@pytest.mark.parametrize("max_tip", [1, 5, 96])
def test_pair_trim_round_matches_jax(seed, max_tip):
    """One device trim round (capped ranking) kills the rows the JAX
    package's host round (full ranking) kills."""
    nxt, alive, rd, ld, _ = links_and_degrees(seed)
    want = alive.copy()
    removed = J._chain_trim_round(want, nxt, rd, ld, max_tip)
    got, got_removed = T._pair_trim_round(
        torch.from_numpy(nxt), torch.from_numpy(rd), torch.from_numpy(ld),
        torch.from_numpy(alive), torch.ones(len(alive), dtype=torch.int32),
        max_tip)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got_removed) == removed > 0


# --------------------------------------------------------------------------
# wide-mode device functions


def test_mix_pair_matches_jax():
    rng = np.random.default_rng(3)
    x, y = (rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64)
            for _ in range(2))
    np.testing.assert_array_equal(
        np.asarray(J._mix_pair(jnp.asarray(x), jnp.asarray(y))),
        as_u64(T._mix_pair(u64.from_numpy(x), u64.from_numpy(y))))
    jf = J._pair_fp(*(jnp.asarray(a) for a in (x, y, y, x)))
    tf = T._pair_fp(*(u64.from_numpy(a) for a in (x, y, y, x)))
    for ja, ta in zip(jf, tf):
        np.testing.assert_array_equal(np.asarray(ja), as_u64(ta))


@pytest.mark.parametrize("k,K", [(20, 50), (31, 62)])
def test_pair_batches_match_jax(k, K):
    codes = random_reads(70 + k, n=30, L=100, n_rate=0.01)
    np.testing.assert_array_equal(
        np.asarray(J._pair_canon_batch(jnp.asarray(codes), k, K)),
        as_u64(T._pair_canon_batch(_t(codes), k, K)))
    jo = J._pair_fill_batch(jnp.asarray(codes), k, K)
    to = T._pair_fill_batch(_t(codes), k, K)
    for ja, ta in zip(jo, to):
        if ta.dtype == torch.bool:
            np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(ja), as_u64(ta))


WIDE_FIELDS = ["keys", "counts", "alive", "fa", "ra", "fb", "rb", "text"]


@pytest.fixture(scope="module")
def wide_tables():
    codes, k, K, kc = _cases()["errors_k31_K80"]
    batches = [codes[:300], codes[300:]]
    jt = J.count_pairs_wide(batches, k, K, kc=kc)
    tt = T.count_pairs_wide(batches, k, K, kc=kc, device="cpu")
    return jt, tt


def test_count_pairs_wide_matches_jax(wide_tables):
    jt, tt = wide_tables
    assert_tables(jt, tt, WIDE_FIELDS)
    assert tt.n > 100 and tt.text.any()


@pytest.mark.parametrize("zero_gap", [False, True])
def test_pair_probe_matches_jax(wide_tables, zero_gap):
    jt, tt = wide_tables
    jn, jts = J._pair_probe_dev(jt, zero_gap)
    tn, tts = T._pair_probe_dev(tt, zero_gap, torch.device("cpu"))
    np.testing.assert_array_equal(as_int(jn), as_int(tn))
    np.testing.assert_array_equal(np.asarray(jts).astype(np.int64),
                                  as_int(tts))
    # the columns that really found a neighbour
    assert (as_int(tn) >= 0).sum() > tt.n // 4


def test_probe_col_hashes_match_jax(wide_tables):
    jt, tt = wide_tables
    ends = J._pair_end_bases(jt)
    for ci in (0, 7, 16, 31):
        right = ci < 16
        c1, c2 = (ci % 16) >> 2, ci & 3
        ja, jb = (ends[0], ends[2]) if right else (ends[1], ends[3])
        jo = J._probe_col_hashes(
            jt.k, right, *(jnp.asarray(getattr(jt, f))
                           for f in ("fa", "ra", "fb", "rb")),
            jnp.asarray(ja), jnp.asarray(jb), c1, c2)
        to = T._probe_col_hashes(
            tt.k, right, *(u64.from_numpy(getattr(tt, f))
                           for f in ("fa", "ra", "fb", "rb")),
            torch.from_numpy(ja), torch.from_numpy(jb), c1, c2)
        for x, y in zip(jo, to):
            np.testing.assert_array_equal(np.asarray(x), as_u64(y))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nxt_pair_matches_jax_with_ties(seed):
    """Random links over few rows, so that one target sits in several
    columns (argmax ties: the first maximum must win), with palindromic
    and dead rows."""
    rng = np.random.default_rng(seed)
    N = 40
    nbr = np.full((32, N), -1, np.int32)
    for row in range(N):
        for lo in (0, 16):
            cols = rng.choice(16, 1 + (rng.random() < 0.3), replace=False)
            nbr[lo + cols, row] = rng.integers(0, N)   # 2 columns: a tie
    ts = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    palin = rng.random(N) < 0.1
    alive = rng.random(N) < 0.9
    want = J._nxt_pair(jnp.asarray(nbr), jnp.asarray(ts),
                       jnp.asarray(palin), jnp.asarray(alive))
    got = T._nxt_pair(torch.from_numpy(nbr.astype(np.int64)),
                      torch.from_numpy(ts.astype(np.int64)),
                      torch.from_numpy(palin), torch.from_numpy(alive))
    np.testing.assert_array_equal(as_int(want), as_int(got))
    assert (as_int(got) >= 0).any()


@pytest.mark.parametrize("max_tip", [0, 1, 80])
def test_device_pair_dbg_matches_jax(wide_tables, max_tip):
    jt, tt = wide_tables
    jd = J.DevicePairDBG(jt, zero_gap=False)
    td = T.DevicePairDBG(tt, zero_gap=False)
    np.testing.assert_array_equal(np.asarray(jd.palin_d), td.palin_d.numpy())
    assert jd.trim(max_tip) == td.trim(max_tip)
    np.testing.assert_array_equal(np.asarray(jd.alive_d), td.alive_d.numpy())
    for ja, ta in zip(jd.chains(), td.chains()):
        np.testing.assert_array_equal(np.asarray(ja).astype(np.int64),
                                      np.asarray(ta).astype(np.int64))
