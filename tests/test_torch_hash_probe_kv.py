"""The key -> value hash tables of the port (ops/hash_probe: build_kv,
lookup, lookup_slot, insert) and ops/scan.running_sum against
abyss_tpu's, on the CPU, bit for bit.

`insert` is held to the JAX package with lanes that race for one slot
(duplicate keys, and distinct keys whose windows collide in a small
table): the tables and the failure count must be identical, so the
winner rule (the highest lane) is the JAX package's on the CPU.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from abyss_tpu.ops import hash_probe as JH
from abyss_tpu.ops import scan as JS
from abyss_tpu_torch import u64
from abyss_tpu_torch.ops import hash_probe as TH
from abyss_tpu_torch.ops import scan as TS

torch.set_num_threads(1)


def _keys(rng, n, pool=None):
    if pool is None:
        return rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
    return rng.choice(pool, n)


def _t(a):
    return u64.from_numpy(np.asarray(a, np.uint64))


@pytest.mark.parametrize("n", [0, 1, 100, 3000])
def test_build_kv_matches_jax(n):
    rng = np.random.default_rng(n)
    keys = _keys(rng, n)
    if n:
        keys[0] = JH.EMPTY        # reserved: never stored
    vals = rng.integers(-5, 1 << 20, n).astype(np.int32)
    jt, jv = JH.build_kv(keys, vals)
    tt, tv = TH.build_kv(keys, vals)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jv, tv)
    # a forced small size makes the build grow
    jt, jv = JH.build_kv(keys, vals, size=16)
    tt, tv = TH.build_kv(keys, vals, size=16)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jv, tv)


@pytest.mark.parametrize("fn", ["lookup", "lookup_slot"])
def test_lookup_matches_jax(fn):
    rng = np.random.default_rng(5)
    keys = _keys(rng, 500)
    vals = np.arange(500, dtype=np.int32)
    tab, vtab = JH.build_kv(keys, vals, size=1024)
    # a key stored twice in one window: the first slot must answer
    dup = keys[7]
    base = int(JH._mix_np(np.array([dup]))[0] & np.uint64(1023))
    free = [s for s in range(base, base + JH.B) if tab[s] == JH.EMPTY]
    if free:
        tab[free[-1]] = dup
        vtab[free[-1]] = 999
    q = np.concatenate([keys[::3], _keys(rng, 200),
                        np.array([JH.EMPTY, dup], np.uint64)])
    jout = getattr(JH, fn)(jnp.asarray(tab), jnp.asarray(vtab),
                           jnp.asarray(q))
    tout = getattr(TH, fn)(_t(tab), torch.from_numpy(vtab), _t(q))
    for ja, ta in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(ja).astype(np.int64),
                                      ta.numpy().astype(np.int64))


@pytest.mark.parametrize("case", ["distinct", "duplicates", "crowded",
                                  "masked", "prefilled"])
def test_insert_matches_jax(case):
    rng = np.random.default_rng(len(case))
    size = 64 if case == "crowded" else 1024
    n = 300 if case == "crowded" else 400
    if case == "duplicates":
        keys = _keys(rng, n, pool=_keys(rng, 40))    # racing equal keys
    else:
        keys = _keys(rng, n)
    vals = np.arange(n, dtype=np.int32) * 3 + 1
    live = np.ones(n, bool) if case != "masked" else rng.random(n) < 0.6
    keys = np.where(live, keys, JH.EMPTY)
    tab = np.full(size + JH.B, JH.EMPTY, np.uint64)
    vtab = np.full(size + JH.B, -1, np.int32)
    if case == "prefilled":
        tab, vtab = JH.build_kv(_keys(rng, 100), np.arange(100,
                                dtype=np.int32), size=size)
    jt, jv, jf = JH.insert(jnp.asarray(tab), jnp.asarray(vtab),
                           jnp.asarray(keys), jnp.asarray(vals),
                           jnp.asarray(live))
    tt, tv, tf = TH.insert(_t(tab), torch.from_numpy(vtab), _t(keys),
                           torch.from_numpy(vals), torch.from_numpy(live))
    np.testing.assert_array_equal(np.asarray(jt), u64.to_numpy(tt))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    assert int(jf) == int(tf)
    if case == "crowded":
        assert int(tf) > 0        # the case really overflows windows
    # the inputs are not written
    np.testing.assert_array_equal(vtab, np.asarray(vtab))


def test_set_last_highest_lane_wins():
    dst = torch.zeros(8, dtype=torch.int64)
    idx = torch.tensor([3, 1, 3, 3, 1, 5, 0])
    vals = torch.arange(10, 17)
    write = torch.tensor([True] * 6 + [False])
    TH.set_last(dst, idx, vals, write)
    assert dst.tolist() == [0, 14, 0, 13, 0, 15, 0, 0]
    j = jnp.zeros(8, jnp.int64).at[jnp.asarray([3, 1, 3, 3, 1, 5])].set(
        jnp.arange(10, 16))
    assert np.asarray(j).tolist() == dst.tolist()


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_running_sum_matches_jax(n):
    x = np.random.default_rng(n).integers(-3, 9, n).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(JS.running_sum(jnp.asarray(x))),
        TS.running_sum(torch.from_numpy(x)).numpy())
