"""The exact hash-DBG engine of the port against abyss_tpu's, on the CPU.

Each device program of the port (ops/nthash.kmer_hashes_alt, the
load-phase packing and counting of dbg/hash_dbg.py, both neighbour
probes, and dbg/chain_ops.py's successor links, list ranking, trim and
erode rounds and chain sort) is run on the same numpy inputs, made from
a seed, as its abyss_tpu counterpart, and must give the same bits
(64-bit words compared as uint64).  The cases of tests/test_hash_dbg.py
are in tests/test_torch_hash_dbg_cases.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from abyss_tpu.core import alphabet
from abyss_tpu.dbg import chain_ops as JC
from abyss_tpu.dbg import hash_dbg as J
from abyss_tpu.ops import nthash as JN
from abyss_tpu_torch import u64
from abyss_tpu_torch.dbg import chain_ops as TC
from abyss_tpu_torch.dbg import hash_dbg as T
from abyss_tpu_torch.ops import nthash as TN

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores
torch.set_num_threads(1)


def kw(mod):
    """The port's entry points default to the card; these run on the
    CPU."""
    return {"device": "cpu"} if mod is T else {}


def as_u64(x) -> np.ndarray:
    """A JAX uint64 array or a port int64 tensor as numpy uint64."""
    if isinstance(x, torch.Tensor):
        return u64.to_numpy(x)
    return np.asarray(x).astype(np.uint64)


def as_int(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def random_reads(seed, n=600, L=120, glen=3000, err=0.006, n_rate=0.0,
                 circular=False):
    """Reads of a random genome with a 400-base repeat, substitution
    errors, half of them reverse-complemented; `n_rate` of the bases N."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, glen).astype(np.uint8)
    g = np.concatenate([g, g[glen // 3: glen // 3 + 400]])
    src = np.concatenate([g, g[:L]]) if circular else g
    reads = []
    for _ in range(n):
        p = rng.integers(0, len(src) - L)
        r = src[p:p + L].copy()
        errpos = rng.random(L) < err
        r[errpos] = (r[errpos] + rng.integers(1, 4, errpos.sum())) % 4
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads.append(r)
    reads = np.array(reads)
    if n_rate:
        reads[rng.random(reads.shape) < n_rate] = 4
    return reads


# --------------------------------------------------------------------------
# device programs, one by one


@pytest.mark.parametrize("B,L,k", [(4, 60, 21), (3, 150, 96), (5, 40, 40)])
def test_kmer_hashes_alt(B, L, k):
    codes = random_reads(B * L + k, n=B, L=L, n_rate=0.02).astype(np.uint8)
    jf, jr = JN.kmer_hashes_alt(jnp.asarray(codes), k)
    tf, tr = TN.kmer_hashes_alt(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(as_u64(tf), as_u64(jf))
    np.testing.assert_array_equal(as_u64(tr), as_u64(jr))


PACK_CASES = [(5, False), (5, True), (16, False), (16, True), (31, False),
              (31, True), (32, False)]


@pytest.mark.parametrize("k,strand_key", PACK_CASES)
def test_pack_canon_masked(k, strand_key):
    codes = random_reads(k, n=64, L=100, n_rate=0.01).astype(np.uint8)
    ja, jb = J._pack_canon_masked(jnp.asarray(codes), k, strand_key)
    ta, tb = T._pack_canon_masked(torch.from_numpy(codes), k, strand_key)
    np.testing.assert_array_equal(as_u64(ta), as_u64(ja))
    if strand_key:
        assert jb is None and tb is None
    else:
        np.testing.assert_array_equal(as_u64(tb), as_u64(jb))
    if k == 32:
        # keys with bit 63 set, which signed order would put first
        keys = as_u64(ta)
        assert ((keys >> np.uint64(63)) == 1).sum() > \
            (keys == np.uint64(0xFFFFFFFFFFFFFFFF)).sum()


def test_pack_kmers_k32_unsigned_min():
    """canon = unsigned min(fwd, rc) at k = 32, where both words can
    have bit 63 set."""
    seq = "T" * 16 + "G" * 15 + "A"
    codes = alphabet.encode(seq)[None]
    jf, jr, jc, jv = J.pack_kmers(jnp.asarray(codes), 32)
    tf, tr, tc, tv = T.pack_kmers(torch.from_numpy(codes), 32)
    for a, b in ((tf, jf), (tr, jr), (tc, jc)):
        np.testing.assert_array_equal(as_u64(a), as_u64(b))
    assert as_u64(tc)[0, 0] >> np.uint64(63) == 1


COUNT_CASES = [(21, False), (21, True), (31, True), (32, False), (32, True),
               (40, False), (64, True)]


@pytest.mark.parametrize("k,strand", COUNT_CASES)
def test_count_kmers(k, strand):
    reads = random_reads(100 + k, n=400, n_rate=0.002)
    batches = [reads[:150], reads[150:]]
    jt = J.count_kmers(batches, k, strand_counts=strand)
    tt = T.count_kmers(batches, k, strand_counts=strand, device="cpu")
    np.testing.assert_array_equal(tt.kmers, jt.kmers)
    np.testing.assert_array_equal(tt.counts, jt.counts)
    np.testing.assert_array_equal(tt.alive, jt.alive)
    if strand and k <= 32:
        np.testing.assert_array_equal(tt.fwd_counts, jt.fwd_counts)
    else:
        assert tt.fwd_counts is None and jt.fwd_counts is None
    assert tt.wide == jt.wide == (k > 32)
    if k > 32:
        for name in ("hr", "text", "cs"):
            np.testing.assert_array_equal(getattr(tt, name),
                                          getattr(jt, name))
        assert tt.collisions == 0


def solid_table(mod, k, seed=7, circular=False):
    """count -> kc 2 -> compact -> adjacency, with a tenth of the rows
    then marked dead (seeded)."""
    reads = random_reads(seed, circular=circular)
    t = mod.count_kmers([reads], k, strand_counts=True, **kw(mod))
    mod.apply_coverage_threshold(t, 2)
    mod.compact(t)
    mod.build_adjacency(t)
    rng = np.random.default_rng(seed)
    t.alive = rng.random(t.n) > 0.1
    return t


@pytest.fixture(scope="module")
def tables():
    """(JAX table, port table) by (k, circular), built once."""
    out = {}

    def get(k, circular=False):
        if (k, circular) not in out:
            out[k, circular] = (solid_table(J, k, circular=circular),
                                solid_table(T, k, circular=circular))
        return out[k, circular]
    return get


@pytest.mark.parametrize("k", [21, 32, 40, 64])
def test_neighbor_probes(tables, k):
    jt, tt = tables(k)
    np.testing.assert_array_equal(tt.nbr, jt.nbr)
    if k > 32:
        fb, lb = jt.end_bases()
        j = J._neighbor_probe_wide(jnp.asarray(jt.kmers), jnp.asarray(jt.hr),
                                   jnp.asarray(fb), jnp.asarray(lb), k)
        t = T._neighbor_probe_wide(
            u64.from_numpy(jt.kmers), u64.from_numpy(jt.hr),
            torch.from_numpy(fb), torch.from_numpy(lb), k)
    else:
        j = J._neighbor_probe(jnp.asarray(jt.kmers), k)
        t = T._neighbor_probe(u64.from_numpy(jt.kmers), k)
    np.testing.assert_array_equal(as_int(t), as_int(j))
    assert (as_int(t) >= 0).sum() > jt.n   # most rows have neighbours


def nxt_inputs(jt):
    """The JAX and port successor-program inputs of a table."""
    j = dict(kmers=jnp.asarray(jt.kmers), nbr8=jnp.asarray(
        np.ascontiguousarray(jt.nbr.T)), alive=jnp.asarray(jt.alive))
    t = dict(kmers=u64.from_numpy(jt.kmers), nbr8=torch.from_numpy(
        np.ascontiguousarray(jt.nbr.T).astype(np.int64)),
        alive=torch.from_numpy(jt.alive.copy()))
    return j, t


@pytest.mark.parametrize("k", [21, 32])
def test_nxt_packed(tables, k):
    jt, _ = tables(k)
    j, t = nxt_inputs(jt)
    want = as_int(JC._nxt_packed(k, j["kmers"], j["nbr8"], j["alive"]))
    got = as_int(TC._nxt_packed(k, t["kmers"], t["nbr8"], t["alive"]))
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > jt.n // 2


@pytest.mark.parametrize("k", [40, 64])
def test_nxt_wide(tables, k):
    jt, _ = tables(k)
    j, t = nxt_inputs(jt)
    fb, lb = jt.end_bases()
    want = as_int(JC._nxt_wide(k, j["kmers"], jnp.asarray(jt.hr),
                               jnp.asarray(fb), jnp.asarray(lb), j["nbr8"],
                               j["alive"]))
    got = as_int(TC._nxt_wide(k, t["kmers"], u64.from_numpy(jt.hr),
                              torch.from_numpy(fb), torch.from_numpy(lb),
                              t["nbr8"], t["alive"]))
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > jt.n // 2


def chains_and_cycles(seed, n=3000):
    """A successor array over n vertices: random chains, 1-2 vertex
    stubs and cycles of several lengths (a 1-cycle excluded: the
    successor programs never link a vertex to itself)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    nxt = np.full(n, -1, np.int32)
    i = 0
    while i < n:
        ln = int(rng.choice([1, 2, 3, 7, 40, 300]))
        seg = perm[i:i + ln]
        nxt[seg[:-1]] = seg[1:]
        if len(seg) > 1 and rng.random() < 0.4:
            nxt[seg[-1]] = seg[0]            # close it into a cycle
        i += ln
    return nxt


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_full_rank_with_cycles(seed):
    nxt = chains_and_cycles(seed)
    jP, jd = JC._full_rank(jnp.asarray(nxt))
    tP, td = TC._full_rank(torch.from_numpy(nxt.astype(np.int64)))
    np.testing.assert_array_equal(as_int(tP), as_int(jP))
    np.testing.assert_array_equal(as_int(td), as_int(jd))
    # the JAX package's host form differs from the device programs only
    # on cycles of 2, 4, 8, ... vertices, whose doubled pointers return
    # to themselves and look converged (a fault of its _pointer_double)
    hP, hd = J._pointer_double(nxt.astype(np.int64))
    same = hP == as_int(tP)
    np.testing.assert_array_equal(hd[same], as_int(td)[same])
    for v in np.flatnonzero(~same):
        n, w = 1, nxt[v]
        while w != v:
            n, w = n + 1, nxt[w]
        assert n & (n - 1) == 0, (v, n)


def test_capped_rank():
    nxt = chains_and_cycles(4)
    for rounds in (0, 1, 3, 6):
        want = JC._capped_rank(jnp.asarray(nxt), rounds)
        got = TC._capped_rank(torch.from_numpy(nxt.astype(np.int64)),
                              rounds)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(as_int(g), as_int(w))


def round_inputs(jt):
    """(JAX, port) inputs of one trim or erode round on a table: nxt,
    the oriented degrees, alive, counts and the weak mask (e = 4)."""
    d = JC.DeviceDBG(jt)
    nxt = np.asarray(d._nxt())
    outdeg, indeg = (np.asarray(a) for a in d._deg_ov())
    weak = jt.counts < 4
    j = [jnp.asarray(a) for a in (nxt, outdeg, indeg, jt.alive, jt.counts,
                                  weak)]
    t = [torch.from_numpy(np.array(a)) for a in (
        nxt.astype(np.int64), outdeg, indeg, jt.alive, jt.counts, weak)]
    return j, t


@pytest.mark.parametrize("k,circular", [(25, False), (25, True), (49, False)])
def test_trim_round_impl(tables, k, circular):
    jt, _ = tables(k, circular)
    j, t = round_inputs(jt)
    for max_tip in (1, 5, k):
        rounds = max(int(np.ceil(np.log2(max_tip))), 0) if max_tip > 1 else 0
        ja, jn = JC._trim_round_impl(j[0], j[1], j[2], j[3], j[4],
                                     jnp.int32(max_tip), rounds)
        ta, tn = TC._trim_round_impl(t[0], t[1], t[2], t[3], t[4], max_tip,
                                     rounds)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert int(tn) == int(jn)
    assert int(jn) > 0


@pytest.mark.parametrize("k,circular", [(25, False), (25, True), (49, False)])
def test_erode_round_impl(tables, k, circular):
    jt, _ = tables(k, circular)
    j, t = round_inputs(jt)
    ja, jn = JC._erode_round_impl(j[0], j[2], j[3], j[5])
    ta, tn = TC._erode_round_impl(t[0], t[2], t[3], t[5])
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert int(tn) == int(jn) > 0


@pytest.mark.parametrize("k,circular", [(21, False), (25, True), (40, True)])
def test_chains_sorted_dev(tables, k, circular):
    """Equal on the alive prefix, the only part that reaches the host
    (the sentinels after it come out of an unstable sort)."""
    jt, _ = tables(k, circular)
    j, t = round_inputs(jt)
    jo, js, jc = JC._chains_sorted_dev(j[0], j[3])
    to, ts, tc = TC._chains_sorted_dev(t[0], t[3])
    a = int(jc)
    assert int(tc) == a == 2 * int(jt.alive.sum())
    np.testing.assert_array_equal(as_int(to)[:a], as_int(jo)[:a])
    np.testing.assert_array_equal(as_int(ts)[:a], as_int(js)[:a])
