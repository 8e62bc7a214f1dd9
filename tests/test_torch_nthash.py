"""abyss_tpu_torch.ops.nthash against abyss_tpu.ops.nthash and the TPU
kernel kmer_hashes_pallas (interpret mode), bit for bit, on the same
reads with N codes and padded rows."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from abyss_tpu.ops import nthash as jnt
from abyss_tpu.ops.pallas_kernels import kmer_hashes_pallas
from abyss_tpu_torch import u64
from abyss_tpu_torch.ops import kernels
from abyss_tpu_torch.ops import nthash as tnt

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)

KS = [5, 25, 31, 96]


def reads(seed, B=6, L=160):
    """uint8 [B, L] reads: random bases, N codes, a padded tail, an
    all-padding row and an all-N row."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[1, L // 2:] = 4           # padded row
    codes[2] = 4                    # empty row
    codes[3, 40] = 9                # any code >= 4 is N
    return codes


def as_np(x):
    return np.asarray(x)


@pytest.mark.parametrize("k", KS)
def test_kmer_hashes_plain_matches_jax(k):
    codes = reads(k)
    jf, jr, jc, jv = jnt.kmer_hashes(jnp.asarray(codes), k)
    tf, tr, tc, tv = tnt.kmer_hashes_plain(torch.from_numpy(codes), k)
    np.testing.assert_array_equal(u64.to_numpy(tf), as_np(jf))
    np.testing.assert_array_equal(u64.to_numpy(tr), as_np(jr))
    np.testing.assert_array_equal(u64.to_numpy(tc), as_np(jc))
    np.testing.assert_array_equal(tv.numpy(), as_np(jv))


@pytest.mark.parametrize("k", KS)
def test_canonical_hashes_matches_jax_and_pallas(k):
    codes = reads(100 + k)
    launched = kernels.launches["nthash"]
    tc, tv = tnt.canonical_hashes(torch.from_numpy(codes), k)
    assert kernels.launches["nthash"] == launched   # CPU: plain version
    _, _, jc, jv = jnt.kmer_hashes(jnp.asarray(codes), k)
    pc, pv = kmer_hashes_pallas(jnp.asarray(codes), k, interpret=True)
    np.testing.assert_array_equal(tv.numpy(), as_np(jv))
    np.testing.assert_array_equal(tv.numpy(), as_np(pv))
    np.testing.assert_array_equal(u64.to_numpy(tc), as_np(jc))
    valid = tv.numpy()
    np.testing.assert_array_equal(u64.to_numpy(tc)[valid],
                                  as_np(pc)[valid])


def test_read_shorter_than_k_raises():
    with pytest.raises(ValueError):
        tnt.kmer_hashes_plain(torch.zeros((2, 10), dtype=torch.uint8), 11)


@pytest.mark.parametrize("k", [11, 31])
def test_hash_base_and_rolls_match_jax(k):
    rng = np.random.default_rng(k)
    kmers = rng.integers(0, 4, size=(64, k), dtype=np.uint8)
    jf, jr = jnt.hash_base(jnp.asarray(kmers), k)
    tf, tr = tnt.hash_base(torch.from_numpy(kmers), k)
    np.testing.assert_array_equal(u64.to_numpy(tf), as_np(jf))
    np.testing.assert_array_equal(u64.to_numpy(tr), as_np(jr))
    c_out = rng.integers(0, 5, size=64).astype(np.uint8)
    c_in = rng.integers(0, 5, size=64).astype(np.uint8)
    for jroll, troll in ((jnt.roll_right, tnt.roll_right),
                         (jnt.roll_left, tnt.roll_left)):
        jf2, jr2 = jroll(jf, jr, k, jnp.asarray(c_out), jnp.asarray(c_in))
        tf2, tr2 = troll(tf, tr, k, torch.from_numpy(c_out),
                         torch.from_numpy(c_in))
        np.testing.assert_array_equal(u64.to_numpy(tf2), as_np(jf2))
        np.testing.assert_array_equal(u64.to_numpy(tr2), as_np(jr2))


def test_roll_right_walks_the_read():
    """Rolling the first window along a read gives every window hash."""
    k = 21
    codes = np.random.default_rng(7).integers(0, 4, (1, 90)).astype(np.uint8)
    f, r, _, _ = tnt.kmer_hashes_plain(torch.from_numpy(codes), k)
    t = torch.from_numpy(codes[0].astype(np.int64))
    cf, cr = f[0, 0], r[0, 0]
    for i in range(1, 90 - k + 1):
        cf, cr = tnt.roll_right(cf, cr, k, t[i - 1], t[i + k - 1])
        assert cf.item() == f[0, i].item() and cr.item() == r[0, i].item()


@pytest.mark.parametrize("num_hashes", [1, 4])
def test_multi_hashes_match_jax(num_hashes):
    rng = np.random.default_rng(3)
    canon = rng.integers(0, 1 << 63, size=500, dtype=np.uint64)
    canon[::2] |= np.uint64(1 << 63)
    j = jnt.multi_hashes(jnp.asarray(canon), 25, num_hashes)
    t = tnt.multi_hashes(u64.from_numpy(canon), 25, num_hashes)
    np.testing.assert_array_equal(u64.to_numpy(t), as_np(j))


def test_srol_matches_jax():
    rng = np.random.default_rng(4)
    v = rng.integers(0, 1 << 63, size=300, dtype=np.uint64) | np.uint64(
        1 << 63)
    n = rng.integers(0, 3000, size=300)
    np.testing.assert_array_equal(
        u64.to_numpy(tnt.srol(u64.from_numpy(v), torch.from_numpy(n))),
        as_np(jnt.srol(jnp.asarray(v), jnp.asarray(n))))


@pytest.mark.parametrize("n", [5, 64, 65, 300])
def test_kmer_hashes_padded_matches_jax(n):
    k = 25
    rng = np.random.default_rng(n)
    seq = rng.integers(0, 4, size=n).astype(np.uint8)
    j = jnt.kmer_hashes_padded(seq, k)
    t = tnt.kmer_hashes_padded(seq, k, "cpu")
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_array_equal(u64.to_numpy(a), as_np(b))
    np.testing.assert_array_equal(t[3].numpy(), as_np(j[3]))


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises; it never runs the plain
    version itself, and it counts nothing."""
    launched = kernels.launches["nthash"]
    with pytest.raises(ValueError):
        kernels.nthash(torch.zeros((2, 40), dtype=torch.uint8), 5)
    assert kernels.launches["nthash"] == launched
