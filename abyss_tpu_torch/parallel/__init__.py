"""Multi-device stage 1: the port of abyss_tpu/parallel/.

The JAX package maps the reference's MPI engine (rank-sharded k-mer
table, routed vertex messages, MPI_Allreduce of scalars and
histograms; SURVEY.md §2.5, §2.12) onto a `jax.sharding.Mesh` driven by
one controller process: `shard_map` programs with `psum` and
`all_to_all` over named mesh axes.

The port keeps that single-controller design (`mesh.py`): a `Mesh` is
a grid of torch devices with the same axis names, a sharded array is a
list of per-shard tensors (shard i on mesh device i, in row-major
order of the grid), a per-shard program is a loop over the shards, and
the collectives are plain functions named after the JAX primitives
they replace, whose only cross-device movement is `tensor.to(dest)`.
A device may repeat in a mesh, so one card (or the CPU) stands for a
mesh of N, and the routed phase machine runs for real on it.

  mesh.py           Mesh, make_mesh, make_host_mesh, devices, psum,
                    all_to_all, axis_index
  distributed.py    the counting-filter build and probes over a
                    ("data", "shard") mesh, mesh k-mer counting, and
                    ShardedCountingFilter (pass 2 over a sharded filter)
  sharded_table.py  the distributed exact engine: the owner-sharded
                    k-mer table and every phase of stage 1 on the mesh
"""
