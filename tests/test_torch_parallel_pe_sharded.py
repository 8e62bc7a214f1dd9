"""`pe engine=exact` over the mesh-sharded table: np=8 (a 1-D mesh of
8) and np=4 nh=2 (the ("host", "data") mesh), the whole pipeline once
in each package through `pe.run`, every artifact byte-identical
(tests/test_torch_parallel_pe.py holds the reads and the helpers)."""

import pytest
import torch

from abyss_tpu_torch.io import read_batches
from abyss_tpu_torch.parallel import mesh as tm
from abyss_tpu_torch.parallel import sharded_table as tst

from .test_torch_parallel_pe import (ARTIFACTS_EXACT, NAME,  # noqa: F401
                                     assert_same_artifacts, read, reads,
                                     run_both)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def exact8(reads, tmp_path_factory):
    return run_both(reads, tmp_path_factory.mktemp("exact8"), np_devices=8,
                    engine="exact")


@pytest.fixture(scope="module")
def exact4x2(reads, tmp_path_factory):
    return run_both(reads, tmp_path_factory.mktemp("exact4x2"),
                    np_devices=4, n_hosts=2, engine="exact")


@pytest.mark.parametrize("name", ARTIFACTS_EXACT)
def test_exact_np8_matches_jax(exact8, name):
    jdir, tdir = exact8
    assert read(tdir / name) == read(jdir / name)


@pytest.mark.parametrize("name", ARTIFACTS_EXACT)
def test_exact_np4_nh2_matches_jax(exact4x2, name):
    jdir, tdir = exact4x2
    assert read(tdir / name) == read(jdir / name)


def test_exact_mesh_runs_pop_a_bubble(exact8, exact4x2, reads):
    """Both meshes write all of abyss_tpu's artifacts, the host mesh the
    1-D mesh's unitigs; stage 1 on the mesh pops the SNP's bubble."""
    for jdir, tdir in (exact8, exact4x2):
        assert_same_artifacts(jdir, tdir, ARTIFACTS_EXACT)
    assert read(exact8[1] / f"{NAME}-1.fa") == \
        read(exact4x2[1] / f"{NAME}-1.fa")
    batches = [b.codes for b in read_batches(reads, 1024, 128, q=3)]
    popped = []
    tst.assemble_sharded(tm.make_mesh(8, 1, tm.devices("cpu")), batches, 25,
                         erode_cov=None, erode_strand=None, auto_params=True,
                         bubbles_out=popped)
    assert popped
