"""The rest of the port's ops against abyss_tpu's, on the CPU:
build_sorted_filter (ops/sorted_filter) and the general running scan
with reverse= (ops/scan).  Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abyss_tpu.ops import scan as js
from abyss_tpu.ops import sorted_filter as jsf
from abyss_tpu_torch import u64
from abyss_tpu_torch.ops import scan as ts
from abyss_tpu_torch.ops import sorted_filter as tsf

torch.set_num_threads(1)


def _u(t):
    return u64.to_numpy(t)


@pytest.mark.parametrize("k,threshold", [(21, 2), (15, 1), (31, 3)])
def test_build_sorted_filter_matches_jax(k, threshold):
    rng = np.random.default_rng(k)
    seq = rng.integers(0, 4, size=1500).astype(np.uint8)
    batches = [rng.integers(0, 4, size=(32, 80), dtype=np.uint8),
               np.tile(seq[:600], (3, 1)), seq[None]]
    batches[0][rng.random(batches[0].shape) < 0.02] = 4
    want = jsf.build_sorted_filter(batches, k, threshold=threshold)
    got = tsf.build_sorted_filter(batches, k, threshold=threshold,
                                  device="cpu")
    np.testing.assert_array_equal(_u(got.kmers), np.asarray(want.kmers))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(_u(got.packed), np.asarray(want.packed))
    assert (got.k, got.threshold) == (want.k, want.threshold)


def test_running_scans_match_jax():
    rng = np.random.default_rng(0)
    for n in (1, 3, 128, 4097):
        x = rng.integers(0, 1000, size=n).astype(np.int64)
        t = torch.from_numpy(x)
        for rev in (False, True):
            for jf, tf in ((js.running_max, ts.running_max),
                           (js.running_min, ts.running_min),
                           (js.running_sum, ts.running_sum)):
                np.testing.assert_array_equal(
                    tf(t, reverse=rev).numpy(),
                    np.asarray(jf(jnp.asarray(x), reverse=rev)))
            np.testing.assert_array_equal(
                ts.running(t, torch.bitwise_xor, 0, rev).numpy(),
                np.asarray(js.running(jnp.asarray(x), jnp.bitwise_xor, 0,
                                      rev)))
