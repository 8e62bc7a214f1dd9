"""abyss_tpu_torch — the PyTorch/CUDA port of the abyss_tpu assembler.

The package mirrors `abyss_tpu`'s module layout so each port module
sits at the same path as its JAX counterpart.  It imports torch and
numpy only: never jax, and never a module of `abyss_tpu`.

Ported so far: stage 1 of the default pipeline, the `bloom-dbg`
assembler with the sorted-table filter (`dbg/bloom_dbg.py`), with two
hand-written CUDA kernels: the canonical ntHash (`csrc/nthash.cu`) and
the unitig walk (`csrc/walk.cu`).

Hashes and keys are `torch.int64` tensors holding the bit pattern of
the JAX package's `uint64` values; `u64.py` holds the unsigned helpers.

Every entry point takes `device` and defaults to "cuda".  Without a
card it raises unless the caller asked for "cpu"; there is no silent
CPU path.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.

    Raises RuntimeError for a CUDA device when no card is present, so a
    run meant for the GPU never falls back to the CPU unnoticed."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "abyss_tpu_torch: no CUDA device is available; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev
