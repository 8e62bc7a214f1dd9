"""The port's device mesh (abyss_tpu_torch/parallel/mesh.py) against
JAX's: devices, mesh layout, and the collectives psum, all_to_all and
axis_index held bit for bit against jax.lax's under shard_map on the
8-device CPU mesh (tests/conftest.py), on 1-D and 2-D meshes and over
an axis tuple (host-major)."""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from abyss_tpu.parallel import distributed as jdist
from abyss_tpu_torch.parallel import distributed as tdist
from abyss_tpu_torch.parallel import mesh as tm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cpu8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return tm.devices("cpu")


def test_devices_follow_xla_flags(cpu8, monkeypatch):
    """devices("cpu") gives JAX's count of virtual CPU devices, from the
    XLA_FLAGS setting that makes them."""
    assert len(cpu8) == len(jax.devices()) == 8
    assert all(d == torch.device("cpu") for d in cpu8)
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=3")
    assert len(tm.devices("cpu")) == 3
    monkeypatch.delenv("XLA_FLAGS")
    assert len(tm.devices("cpu")) == 1


def test_mesh_layout_matches_jax(cpu8):
    for n_data, n_shard in ((8, 1), (4, 2), (2, 4)):
        jm = jdist.make_mesh(n_data, n_shard)
        m = tm.make_mesh(n_data, n_shard, cpu8)
        assert m.axis_names == jm.axis_names == ("data", "shard")
        assert m.shape == dict(jm.shape)
        assert m.size == 8
    hm = tm.make_host_mesh(2, 4, cpu8)
    assert hm.axis_names == jdist.make_host_mesh(2, 4).axis_names
    assert hm.shape == {"host": 2, "data": 4}
    with pytest.raises(AssertionError, match="need 16 devices"):
        tm.make_mesh(8, 2, cpu8)


def _jax_collective(jm, spec_axes, fn, x):
    """fn under shard_map over jm with x [n_dev, ...] sharded over every
    mesh axis; returns the per-device results stacked [n_dev, ...]."""
    names = tuple(jm.axis_names)
    spec = P(names)

    @jax.jit
    @partial(jax.shard_map, mesh=jm, in_specs=spec, out_specs=spec)
    def run(xs):
        return fn(xs[0])[None]

    return np.asarray(run(x))


MESHES = {"1d": ("mesh", 8, 1), "2d": ("mesh", 4, 2), "host": ("host", 2, 4)}


def _meshes(kind, cpu8):
    which, a, b = MESHES[kind]
    if which == "host":
        return jdist.make_host_mesh(a, b), tm.make_host_mesh(a, b, cpu8)
    return jdist.make_mesh(a, b), tm.make_mesh(a, b, cpu8)


def _axes(kind):
    if kind == "host":
        return ["data", "host", ("host", "data")]
    return ["data", "shard", ("data", "shard")]


@pytest.mark.parametrize("kind", list(MESHES))
def test_psum_and_axis_index_match_jax(cpu8, kind):
    jm, m = _meshes(kind, cpu8)
    rng = np.random.default_rng(1)
    x = rng.integers(-1000, 1000, size=(8, 5)).astype(np.int64)
    for axis in _axes(kind):
        got = tm.psum(m, [torch.from_numpy(x[i]) for i in range(8)], axis)
        want = _jax_collective(jm, axis, lambda v: jax.lax.psum(v, axis), x)
        np.testing.assert_array_equal(np.stack([g.numpy() for g in got]),
                                      want)
        idx = _jax_collective(
            jm, axis, lambda v: jnp.broadcast_to(
                jax.lax.axis_index(axis), v.shape), x)
        assert tm.axis_index(m, axis) == idx[:, 0].tolist()


@pytest.mark.parametrize("kind", list(MESHES))
def test_all_to_all_matches_jax(cpu8, kind):
    jm, m = _meshes(kind, cpu8)
    rng = np.random.default_rng(2)
    for axis in _axes(kind):
        n = m.axis_size(axis)
        x = rng.integers(0, 1 << 40, size=(8, n, 3)).astype(np.int64)
        got = tm.all_to_all(m, [torch.from_numpy(x[i]) for i in range(8)],
                            axis)
        want = _jax_collective(
            jm, axis, lambda v: jax.lax.all_to_all(v, axis, 0, 0,
                                                   tiled=False), x)
        np.testing.assert_array_equal(np.stack([g.numpy() for g in got]),
                                      want)


def test_shards_lie_on_their_devices(cpu8):
    """Every shard of a batch or of the counters lies on its mesh device,
    and an uneven batch raises as jax.device_put does."""
    m = tm.make_mesh(4, 2, cpu8)
    codes = np.arange(8 * 6, dtype=np.uint8).reshape(8, 6) % 4
    shards = tdist.shard_batch(m, codes)
    assert all(s.device == d for s, d in zip(shards, m.flat))
    np.testing.assert_array_equal(
        tm.gather_rows(m, shards, "data").numpy(), codes)
    with pytest.raises(ValueError, match="divisible by 4") as port_err:
        tdist.shard_batch(m, codes[:7])
    with pytest.raises(ValueError, match="divisible by 4"):
        jdist.shard_batch(jdist.make_mesh(4, 2), codes[:7])
    assert "equal to 7" in str(port_err.value)
    ctr = tdist.shard_counters(m, torch.arange(16, dtype=torch.uint8))
    assert [c.tolist() for c in ctr[:2]] == [list(range(8)),
                                             list(range(8, 16))]


def test_repeated_device_mesh(cpu8):
    """A mesh may repeat one device (one card standing for four)."""
    one = [torch.device("cpu")]
    m = tm.make_mesh(2, 2, one * 4)
    assert m.size == 4 and len(set(m.flat)) == 1
    got = tm.psum(m, [torch.tensor([i]) for i in range(4)], "data")
    assert [int(g) for g in got] == [2, 4, 2, 4]
    assert os.environ.get("XLA_FLAGS")  # tests/conftest.py's setting
