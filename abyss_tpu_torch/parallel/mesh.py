"""A single-process device mesh and its collectives.

The counterpart of `jax.sharding.Mesh` plus the `shard_map`
collectives abyss_tpu/parallel uses (`psum`, `all_to_all` with
tiled=False on axis 0, `axis_index`).  One process drives every device,
as JAX's single controller does: a per-shard program is a loop over
the mesh's devices, and a collective moves each shard's operand to the
devices that need it with `tensor.to(dest)`, nothing else.  Integer
sums are exact in any order, so every collective here gives the JAX
primitive's values bit for bit.

A mesh's devices may repeat: a mesh of four copies of cuda:0 runs the
same routed programs as four cards, each shard's tensors on "its"
device, and `.to` between two shards of one device is a no-op.  The
same code runs on a mesh of distinct cards.

Sharded arrays are lists of per-shard tensors indexed by the flat
(row-major) device index; for a ("host", "data") mesh that is
host-major, the order in which JAX flattens the axis tuple.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from .. import resolve_device


class Mesh:
    """A grid of torch devices with named axes (jax.sharding.Mesh).

    `shape` maps each axis name to its size, `devices` is the grid
    (numpy object array), `flat` the devices in row-major order: shard
    i of a sharded array lies on flat[i]."""

    def __init__(self, grid: np.ndarray, axis_names: tuple):
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D grid needs {grid.ndim} axis "
                             f"names, got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.flat = [torch.device(d) for d in grid.reshape(-1)]

    @property
    def size(self) -> int:
        return len(self.flat)

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({shape}; {', '.join(map(str, self.flat))})"

    def coords(self, i: int) -> tuple:
        """Grid coordinates of flat device i."""
        return tuple(int(c) for c in np.unravel_index(
            i, self.devices.shape))

    def _axes(self, axis) -> tuple:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} "
                                 f"(axes {self.axis_names})")
        return axes

    def group(self, i: int, axis) -> list[int]:
        """Flat indices of the devices that share every coordinate of
        device i outside `axis` (a name or a tuple of names), ordered by
        their index along `axis` (host-major for a tuple)."""
        axes = self._axes(axis)
        base = list(self.coords(i))
        dims = [self.axis_names.index(a) for a in axes]
        out = []
        for sub in np.ndindex(*[self.devices.shape[d] for d in dims]):
            c = list(base)
            for d, v in zip(dims, sub):
                c[d] = v
            out.append(int(np.ravel_multi_index(c, self.devices.shape)))
        return out

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axis)]))


def devices(device="cuda") -> list[torch.device]:
    """The devices a mesh may take, as `jax.devices()` lists them: one
    entry per visible card for "cuda"; for "cpu", N entries of the CPU,
    N the `--xla_force_host_platform_device_count` in XLA_FLAGS (the
    setting that gives JAX its virtual CPU devices), else 1."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    return [torch.device("cpu")] * (int(m.group(1)) if m else 1)


def make_mesh(n_data: int, n_shard: int = 1, devices=None) -> Mesh:
    """("data", "shard") mesh of the first n_data * n_shard devices
    (default: those of `devices("cuda")`)."""
    devices = devices if devices is not None else _devices("cuda")
    assert len(devices) >= n_data * n_shard, \
        f"need {n_data * n_shard} devices, have {len(devices)}"
    grid = np.empty(n_data * n_shard, dtype=object)
    grid[:] = list(devices[: n_data * n_shard])
    return Mesh(grid.reshape(n_data, n_shard), ("data", "shard"))


def make_host_mesh(n_hosts: int, n_data: int, devices=None) -> Mesh:
    """("host", "data") mesh for the sharded table: the outer axis the
    reference's nodes, the inner one each node's devices; the table's
    collectives run over the axis tuple, host-major."""
    devices = devices if devices is not None else _devices("cuda")
    need = n_hosts * n_data
    assert len(devices) >= need, f"need {need} devices, have {len(devices)}"
    grid = np.empty(need, dtype=object)
    grid[:] = list(devices[:need])
    return Mesh(grid.reshape(n_hosts, n_data), ("host", "data"))


_devices = devices


def axis_index(mesh: Mesh, axis) -> list[int]:
    """jax.lax.axis_index: each device's index along `axis` (a tuple
    flattens host-major)."""
    return [mesh.group(i, axis).index(i) for i in range(mesh.size)]


def psum(mesh: Mesh, xs: list, axis) -> list:
    """jax.lax.psum over `axis`: device i gets the sum of the operands
    of its group, on its own device."""
    out = []
    for i, dev in enumerate(mesh.flat):
        grp = mesh.group(i, axis)
        acc = xs[grp[0]].to(dev)
        for j in grp[1:]:
            acc = acc + xs[j].to(dev)
        out.append(acc)
    return out


def all_to_all(mesh: Mesh, xs: list, axis) -> list:
    """jax.lax.all_to_all(x, axis, 0, 0, tiled=False): xs[i] is [n, ...]
    with n the size of `axis`; device i gets [n, ...] whose row j is
    row i (its index along the axis) of the operand of the j-th device
    of its group."""
    n = mesh.axis_size(axis)
    out = []
    for i, dev in enumerate(mesh.flat):
        grp = mesh.group(i, axis)
        me = grp.index(i)
        for j in grp:
            if xs[j].shape[0] != n:
                raise ValueError(f"all_to_all over {axis!r}: operand rows "
                                 f"{xs[j].shape[0]} != axis size {n}")
        out.append(torch.stack([xs[j][me].to(dev) for j in grp]))
    return out


def scatter_rows(mesh: Mesh, x: torch.Tensor, axis) -> list:
    """x [B, ...] split into contiguous row blocks over `axis` (B a
    multiple of its size), device i taking the block of its index along
    the axis: jax.device_put with NamedSharding P(axis)."""
    n = mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(
            f"sharding over {axis!r} implies that the global size of "
            f"dimension 0 should be divisible by {n}, but it is equal to "
            f"{x.shape[0]} (full shape: {tuple(x.shape)})")
    per = x.shape[0] // n
    idx = axis_index(mesh, axis)
    return [x[idx[i] * per:(idx[i] + 1) * per].to(dev)
            for i, dev in enumerate(mesh.flat)]


def gather_rows(mesh: Mesh, xs: list, axis) -> torch.Tensor:
    """The global array of a list sharded by rows over `axis` (and
    replicated over the other axes), on the mesh's first device: the
    blocks of the devices of device 0's group, concatenated."""
    dev = mesh.flat[0]
    return torch.cat([xs[j].to(dev) for j in mesh.group(0, axis)])
