"""The port's scatter-max (ops/scatter_max.py) against abyss_tpu's Pallas
scatter_max_u8_pallas, run as tests/test_pallas_scatter.py runs it (the
TPU interpreter on the CPU), on the same inputs: numpy's maximum.at with
indices past the size dropped and the sink slot untouched; all updates
to one counter (where the Pallas kernel overflows its tiles); and the
counting filter's "pallas" update mode equal to its "scatter" mode.
Tolerance: exact equality.  The CUDA kernel's own body is checked in
test_torch_kernel_host.py, and on the card in test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from abyss_tpu.ops import bloom as jbloom
from abyss_tpu.ops import pallas_scatter as ps
from abyss_tpu_torch import u64
from abyss_tpu_torch.ops import bloom as tbloom
from abyss_tpu_torch.ops import kernels
from abyss_tpu_torch.ops import scatter_max as tsm

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's many small CPU ops from oversubscribing
# the cores (tens of times slower when they do)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    """tests/test_pallas_scatter.py's inputs."""
    rng = np.random.default_rng(0)
    S = 1 << 17
    Q = 5000
    idx = rng.integers(0, S, size=Q).astype(np.int32)
    idx[:10] = S + 1  # beyond-size entries must be dropped
    val = rng.integers(1, 250, size=Q).astype(np.uint8)
    cnt = rng.integers(0, 100, size=S + 1).astype(np.uint8)
    return S, idx, val, cnt


def port(cnt, idx, val):
    new, ok = tsm.scatter_max_u8(torch.from_numpy(cnt.copy()),
                                 torch.from_numpy(idx), torch.from_numpy(val))
    assert ok is True
    return new.numpy()


def test_scatter_max_matches_numpy_and_pallas(data):
    S, idx, val, cnt = data
    ref = cnt.copy()
    np.maximum.at(ref, np.minimum(idx, S), np.where(idx < S, val, 0))
    ref[S] = cnt[S]  # sink slot untouched
    with pltpu.force_tpu_interpret_mode():
        jnew, jok = ps.scatter_max_u8_pallas(
            jnp.asarray(cnt), jnp.asarray(idx), jnp.asarray(val))
    assert bool(jok)
    np.testing.assert_array_equal(np.asarray(jnew), ref)
    np.testing.assert_array_equal(port(cnt, idx, val), ref)
    # int64 indices (the counting filter's) give the same counters
    np.testing.assert_array_equal(port(cnt, idx.astype(np.int64), val), ref)


def test_all_updates_to_one_counter():
    """The Pallas kernel's tiles overflow here (ok=False, its callers
    fall back to the XLA scatter); the port has no tiles and returns the
    right maximum with ok True."""
    S = 1 << 17
    Q = 4096
    idx = np.zeros(Q, np.int32)
    val = np.ones(Q, np.uint8)
    val[1234] = 200
    cnt = np.zeros(S, np.uint8)
    with pltpu.force_tpu_interpret_mode():
        _, jok = ps.scatter_max_u8_pallas(
            jnp.asarray(cnt), jnp.asarray(idx), jnp.asarray(val))
    assert not bool(jok)
    ref = cnt.copy()
    ref[0] = 200
    np.testing.assert_array_equal(port(cnt, idx, val), ref)


def test_counting_bloom_pallas_mode_matches_scatter():
    """update_mode="pallas" gives bit-identical counters to "scatter",
    in abyss_tpu (Pallas interpreter) and in the port, and the port's
    equal abyss_tpu's."""
    rng = np.random.default_rng(3)
    canon = rng.integers(0, 2**63, size=3000, dtype=np.uint64)
    mask = rng.random(3000) < 0.9
    fa = jbloom.CountingBloomFilter.create(1 << 17, 25, 4, 2)
    fb = fa._replace(update_mode="pallas")
    fa = fa.insert(jnp.asarray(canon), jnp.asarray(mask))
    with pltpu.force_tpu_interpret_mode():
        fb = fb.insert(jnp.asarray(canon), jnp.asarray(mask))
    np.testing.assert_array_equal(np.asarray(fa.counters),
                                  np.asarray(fb.counters))
    for mode in ("scatter", "pallas"):
        tf = tbloom.CountingBloomFilter(
            torch.zeros((1 << 17) + 1, dtype=torch.uint8), 25, 4, 2,
            update_mode=mode)
        tf.insert(u64.from_numpy(canon), torch.from_numpy(mask))
        np.testing.assert_array_equal(tf.counters.numpy(),
                                      np.asarray(fa.counters))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors and counts nothing; the
    module's entry point takes the plain version there."""
    cnt = torch.zeros(9, dtype=torch.uint8)
    idx = torch.tensor([1, 3], dtype=torch.int64)
    val = torch.tensor([5, 6], dtype=torch.uint8)
    launched = kernels.launches["scatter_max"]
    with pytest.raises(ValueError):
        kernels.scatter_max(cnt, idx, val)
    new, ok = tsm.scatter_max_u8(cnt, idx, val)
    assert kernels.launches["scatter_max"] == launched
    assert ok is True and new.tolist() == [0, 5, 0, 6, 0, 0, 0, 0, 0]
