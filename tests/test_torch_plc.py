"""The port's probabilistic log counter (ops/plc.py) against abyss_tpu's,
on the CPU: the threefry stream (PRNGKey, split, bits, randint) equal to
jax.random's, the minifloat decode and increment, PLCArray counters
bit-identical after 50 inserts (repeated cells in a batch included) at
sizes 8, 16, 1,000 (not a power of two) and 2^20, the logcounter loop
equal to abyss_tpu's, and the unsigned remainder of 64-bit words.
Tolerance: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abyss_tpu.ops import nthash as jnthash
from abyss_tpu.ops import plc as jplc
from abyss_tpu_torch import sim, u64
from abyss_tpu_torch.cli import tools2
from abyss_tpu_torch.ops import plc as tplc

torch.set_num_threads(1)

SEEDS = (0, 1, 7, 12345, (5 << 32) | 99)


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_and_randint_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = tplc.prng_key(seed)
    assert _key(key) == tkey
    assert [_key(k) for k in jax.random.split(key)] == tplc.split(tkey)
    assert [_key(k) for k in jax.random.split(key, 5)] == \
        tplc.split(tkey, 5)
    for n in (1, 2, 3, 1000, 4099):
        want = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
        got = tplc.random_bits(tkey, n, "cpu").numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        for lo, hi in ((0, 1 << 30), (0, 1000), (-5, 7), (3, (1 << 31) - 1)):
            want = np.asarray(jax.random.randint(key, (n,), lo, hi,
                                                 dtype=jnp.int32))
            got = tplc.randint(tkey, n, lo, hi, "cpu").numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64))


def test_threefry_block_matches_jax():
    from jax._src import prng
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, size=(2, 257), dtype=np.uint64).astype(
        np.uint32)
    for key in ((0, 0), (1, 2), (0xFFFFFFFF, 0x12345678)):
        want = prng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                  jnp.asarray(x.reshape(-1)))
        want = np.asarray(want).reshape(2, -1)
        # threefry_2x32 hashes the two halves of its flat count as (x0, x1)
        got = tplc.threefry2x32(key, torch.from_numpy(x[0].astype(np.int64)),
                                torch.from_numpy(x[1].astype(np.int64)))
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_decode_and_increment_match_jax():
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tplc.to_count(torch.from_numpy(codes)).numpy(),
        np.asarray(jplc.to_count(jnp.asarray(codes))))
    rng = np.random.default_rng(4)
    rnd = rng.integers(0, 1 << 30, size=(8, 256), dtype=np.int64)
    for row in rnd:
        np.testing.assert_array_equal(
            tplc.increment(torch.from_numpy(codes),
                           torch.from_numpy(row)).numpy(),
            np.asarray(jplc.increment(jnp.asarray(codes),
                                      jnp.asarray(row, jnp.uint32))))


@pytest.mark.parametrize("size", [8, 16, 1000, 1 << 20])
def test_plc_array_counters_match_jax(size):
    rng = np.random.default_rng(size)
    ja = jplc.PLCArray(size, seed=3)
    ta = tplc.PLCArray(size, seed=3, device="cpu")
    hot = rng.integers(0, size, size=4)
    for _ in range(50):
        # one batch shape, so that abyss_tpu compiles its insert once
        idx = rng.integers(0, size, size=256)
        idx[:40] = rng.choice(hot, size=40)     # repeated cells
        idx[-1] = size - 1                      # the last cell
        ja.insert(idx)
        ta.insert(idx)
    np.testing.assert_array_equal(ta.counters.numpy(),
                                  np.asarray(ja.counters))
    assert ta.counters.shape == (size,)
    assert int(ta.counters.max()) > 32   # past the exact mantissa range
    q = np.concatenate([hot, [size - 1, 0]])
    np.testing.assert_array_equal(ta.count(q).numpy(),
                                  np.asarray(ja.count(q)))


def test_plc_counts_approximately():
    """abyss_tpu's own accuracy check, on the port: bounded relative
    error far past the mantissa."""
    arr = tplc.PLCArray(16, seed=1, device="cpu")
    idx = np.zeros(1, np.int32)
    for _ in range(2000):
        arr.insert(idx)
    assert 1000 <= int(arr.count(idx)[0]) <= 4000


def test_logcounter_matches_jax(tmp_path):
    """tools2.logcounter against abyss_tpu's logcounter loop (ntHash of
    each batch, canonical hash mod size, PLCArray insert), size 1000."""
    genome = sim.random_genome(3000, seed=30)
    # 4,500 reads: two batches of 4096
    reads = sim.simulate_paired_reads(genome, coverage=150, read_len=100,
                                      seed=31)
    p1, p2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    reads.write_fastq(p1, p2)
    from abyss_tpu.io import read_batches
    size, k = 1000, 21
    ja = jplc.PLCArray(size)
    n = 0
    for batch in read_batches([p1, p2], 4096, 512):
        _, _, canon, valid = jnthash.kmer_hashes(jnp.asarray(batch.codes), k)
        idx = (np.asarray(canon).reshape(-1) % size).astype(np.int64)
        idx = idx[np.asarray(valid).reshape(-1)]
        ja.insert(idx)
        n += idx.size
    ta, tn = tools2.logcounter([p1, p2], k, size, device="cpu")
    assert tn == n > 0
    np.testing.assert_array_equal(ta.counters.numpy(),
                                  np.asarray(ja.counters))


def test_unsigned_remainder():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 64, size=5000, dtype=np.uint64)
    x[:4] = [0, 1, (1 << 64) - 1, 1 << 63]
    t = u64.from_numpy(x)
    for m in (1, 2, 1000, 1 << 20, 1 << 30, 3_000_000_019, 1 << 62):
        np.testing.assert_array_equal(u64.umod(t, m).numpy(),
                                      (x % np.uint64(m)).astype(np.int64))
