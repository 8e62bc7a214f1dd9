"""abyss_tpu_torch — the PyTorch/CUDA port of the abyss_tpu assembler.

The package mirrors `abyss_tpu`'s module layout so each port module
sits at the same path as its JAX counterpart.  It imports torch and
numpy only: never jax, and never a module of `abyss_tpu`.

Ported: the `pe` pipeline (`pipeline/pe.py`: stages 1 to 8, 10 and
stats, with the bloom engine or the exact hash-DBG engine, colour space,
lr=, long=, K=, sealer_ks= and stage 1 over np= x nh= devices on a
single-process mesh, `parallel/`), and the whole tool suite of `python -m
abyss_tpu_torch` (`__main__.py`: the 56 tools of `python -m abyss_tpu`,
among them `bloom-dbg`, `assemble`, `paired-dbg`, `konnector`,
`sealer`, `abyss-bloom`, `logcounter` with its PLC counters in
`ops/plc.py`, and the FM-index tools over `align/fmindex.py`), with
hand-written CUDA kernels: the canonical ntHash (`csrc/nthash.cu`), the
scatter-max of the counting filter and the PLC array
(`csrc/scatter_max.cu`) and the unitig walks (`csrc/walk.cu`, also over
a counting filter sharded across a mesh).

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
