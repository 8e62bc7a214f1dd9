"""NG50 of a set of sequence lengths: a frozen copy of the abyss-fac
arithmetic in `abyss_tpu_torch/core/histogram.py` (`contiguity_stats`
with `exp_size`, `Histogram.trim_low` and `Histogram.arg_min`), in
NumPy.  Sequences shorter than `min_size` are left out, as abyss-fac's
`-s 500` does; N bases count toward a scaffold's length."""

from __future__ import annotations

import numpy as np


def ng50(lengths, genome_size: int, min_size: int = 500) -> int:
    """The smallest length L such that the sequences of length >= L
    cover half of genome_size (the smallest kept length when all of
    them together cover less)."""
    ls = np.sort(np.asarray([x for x in lengths if x >= min_size],
                            dtype=np.int64))
    if ls.size == 0:
        return 0
    total = int(ls.sum())
    half = genome_size // 2
    if total < half:
        return int(ls[0])
    # ascending partial sums reach total - half at the NG50 length
    idx = int(np.searchsorted(np.cumsum(ls), total - half, side="left"))
    return int(ls[min(idx, ls.size - 1)])
