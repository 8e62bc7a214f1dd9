"""The port's RResolver against abyss_tpu, on the CPU: the r-mer Bloom
filter's bits, and the edges resolve_repeats / resolve_repeats_multi
cut and the graph and sequences they leave, on the same inputs."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from abyss_tpu.graph import adjlist as jadj
from abyss_tpu.graph import graphio as jgio
from abyss_tpu.graph import rresolver as jrr
from abyss_tpu_torch import convert
from abyss_tpu_torch.core import alphabet
from abyss_tpu_torch.graph import adjlist as tadj
from abyss_tpu_torch.graph import graphio as tgio
from abyss_tpu_torch.graph import rresolver as trr

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)


def read_batches(seed, n_batches, B, L):
    """[B, L] code batches: reads of random lengths padded with 4, a few
    N codes, one row all padding."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
        codes[rng.random((B, L)) < 0.003] = 4
        lengths = rng.integers(L // 2, L + 1, B)
        codes[np.arange(L)[None, :] >= lengths[:, None]] = 4
        codes[0] = 4
        out.append(codes)
    return out


@pytest.mark.parametrize("r,L,size", [(91, 128, 1 << 16), (60, 100, 1 << 12),
                                      (150, 128, 1 << 10)])
def test_rmer_filter_bits_match_jax(r, L, size):
    """r = 91 (default_r of 100 bp reads at k = 31), a shorter r into a
    filter small enough to saturate in places, and r longer than the
    batch (skipped: an empty filter)."""
    batches = read_batches(r + L, 3, 64, L)
    jf = jrr.build_rmer_filter(batches, r=r, size=size)
    tf = trr.build_rmer_filter(batches, r=r, size=size, device="cpu")
    assert (tf.k, tf.num_hashes, tf.size) == (jf.k, jf.num_hashes, jf.size)
    np.testing.assert_array_equal(tf.bits.numpy(), np.asarray(jf.bits))
    assert (tf.popcount > 0) == (r <= L)


def test_bit_filter_from_numpy_answers_as_jax():
    batches = read_batches(7, 2, 32, 128)
    jf = jrr.build_rmer_filter(batches, r=91, size=1 << 14)
    tf = convert.bit_filter_from_numpy(np.asarray(jf.bits), 91,
                                       jf.num_hashes, device="cpu")
    probe = read_batches(8, 1, 16, 128)[0]
    probe[:8] = batches[0][:8]
    from abyss_tpu.ops import nthash as jnt
    from abyss_tpu_torch.ops import nthash as tnt
    import jax.numpy as jnp
    _, _, jc, jv = jnt.kmer_hashes(jnp.asarray(probe), 91)
    _, _, tc, tv = tnt.kmer_hashes(torch.from_numpy(probe), 91)
    want = np.asarray(jf.contains(jc, jv))
    np.testing.assert_array_equal(tf.contains(tc, tv).numpy(), want)
    assert want.any() and not want.all()
    assert convert.bit_filter_from_numpy(None, 91) is None


def mk(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def codes_of(reads, r):
    codes = np.full((len(reads), r), 4, np.uint8)
    for i, s in enumerate(reads):
        codes[i, :len(s)] = alphabet.encode(s)
    return codes


def two_path_repeat(seed):
    """tests/test_rresolver.py's two-path repeat: A-R-B and C-R-D share
    R; reads only cross the true paths."""
    rng = np.random.default_rng(seed)
    k, r = 21, 100
    A, B, C, D = (mk(rng, 150) for _ in range(4))
    R = mk(rng, 60)
    reads = []
    for chrom in (A + R + B, C + R + D):
        reads += [chrom[i:i + r] for i in range(0, len(chrom) - r + 1, 3)]
    o = k - 1
    contigs = [("A", A + R[:o]), ("B", R[-o:] + B), ("C", C + R[:o]),
               ("D", R[-o:] + D), ("R", R)]
    return contigs, [codes_of(reads, r)], k, r


def false_edge(seed):
    """tests/test_rresolver.py's false edge: X-R-Z is read, X-R-Y not."""
    rng = np.random.default_rng(seed)
    k, r = 21, 80
    R = mk(rng, 40)
    X, Y, Z = mk(rng, 120), mk(rng, 120), mk(rng, 120)
    genome = X + R + Z
    reads = [genome[i:i + r] for i in range(0, len(genome) - r + 1, 2)]
    o = k - 1
    contigs = [("X", X + R[:o]), ("R", R), ("Y", R[-o:] + Y),
               ("Z", R[-o:] + Z)]
    return contigs, [codes_of(reads, r)], k, r


def dot(gio, g, k):
    buf = io.StringIO()
    gio.write_dot(g, buf, k=k)
    return buf.getvalue()


@pytest.mark.parametrize("case", [two_path_repeat, false_edge])
@pytest.mark.parametrize("seed", [200, 201])
def test_resolve_repeats_matches_jax(case, seed):
    contigs, batches, k, r = case(seed)
    jg, tg = jadj.build_overlap_graph(contigs, k), \
        tadj.build_overlap_graph(contigs, k)
    assert dot(tgio, tg, k) == dot(jgio, jg, k)
    jseqs, tseqs = dict(contigs), dict(contigs)
    jf = jrr.build_rmer_filter(batches, r=r, size=1 << 20)
    tf = trr.build_rmer_filter(batches, r=r, size=1 << 20, device="cpu")
    js = jrr.resolve_repeats(jg, jseqs, jf, k, support_threshold=4)
    ts = trr.resolve_repeats(tg, tseqs, tf, k, support_threshold=4)
    assert dataclasses.astuple(ts) == dataclasses.astuple(js)
    assert js.edges_cut + js.repeats_split >= 1
    assert dot(tgio, tg, k) == dot(jgio, jg, k)
    assert tseqs == jseqs


def genome_reads(seed, read_sizes):
    """A 1,500-base genome with a 50-base repeat twice (W R X ... Y R Z),
    its unitigs split at the repeat, and tiled reads of each size in
    read_sizes (several r values for resolve_repeats_multi)."""
    rng = np.random.default_rng(seed)
    k = 31
    R = mk(rng, 50)
    W, X, Y, Z = (mk(rng, 300) for _ in range(4))
    genome = W + R + X + mk(rng, 200) + Y + R + Z
    reads = []
    for size in read_sizes:
        reads += [genome[i:i + size] for i in range(0, len(genome) - size,
                                                    2)]
    L = max(read_sizes)
    codes = codes_of(reads, L)
    lengths = np.array([len(s) for s in reads], np.int32)
    o = k - 1
    mid = X + genome[len(W + R + X):len(W + R + X) + 200] + Y
    contigs = [("W", W + R[:o]), ("R", R), ("X", R[-o:] + mid + R[:o]),
               ("Z", R[-o:] + Z)]
    return contigs, codes, lengths, k


@pytest.mark.parametrize("read_sizes", [(100,), (100, 120), (100, 90)])
def test_resolve_repeats_multi_matches_jax(read_sizes):
    contigs, codes, lengths, k = genome_reads(31, read_sizes)
    jg, tg = jadj.build_overlap_graph(contigs, k), \
        tadj.build_overlap_graph(contigs, k)
    jseqs, tseqs = dict(contigs), dict(contigs)

    def batches():
        return (codes[i:i + 64] for i in range(0, len(codes), 64))

    js = jrr.resolve_repeats_multi(jg, jseqs, batches, lengths, k,
                                   filter_size=1 << 18)
    ts = trr.resolve_repeats_multi(tg, tseqs, batches, lengths, k,
                                   filter_size=1 << 18, device="cpu")
    assert dataclasses.astuple(ts) == dataclasses.astuple(js)
    assert js.junctions > 0 and js.paths_tested > 0
    assert dot(tgio, tg, k) == dot(jgio, jg, k)
    assert tseqs == jseqs


def test_read_size_helpers_match_jax():
    rng = np.random.default_rng(3)
    lengths = np.concatenate([np.full(800, 100), np.full(150, 150),
                              rng.integers(30, 100, 50)])
    assert trr.read_size_batches(lengths) == jrr.read_size_batches(lengths)
    for size in (50, 100, 150, 250):
        assert trr.default_r(size, 31) == jrr.default_r(size, 31)
