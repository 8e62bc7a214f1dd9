"""Checkpoint/resume for Bloom-mode assembly.

Port of abyss_tpu/dbg/checkpoint.py (BloomDBG/Checkpoint.h:14-270):
every N reads, atomically (tmp + rename) persist the solid-k-mer table,
the visited filter, progress counters and the partial contig FASTA; on
restart, detect a valid checkpoint and resume.  The files and their
layout are the JAX package's, so either package resumes from the
other's checkpoint: `counting.npy` holds the sorted table as stacked
uint64 (kmers, counts) (`sorted_mode` true in state.json) or the
counting Bloom filter's uint8 counters (`sorted_mode` false).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from .. import convert, u64
from ..ops.bloom import BitBloomFilter, CountingBloomFilter
from ..ops.sorted_filter import SortedKmerFilter

FILES = ("counting.npy", "visited.npy", "state.json", "contigs.fa")


def _tmp(path: str) -> str:
    return path + ".tmp"


def save(ckpt_dir: str, cbf: SortedKmerFilter | CountingBloomFilter,
         visited: BitBloomFilter, reads_processed: int, counters: dict,
         partial_contigs_path: str | None = None):
    """Atomically write a checkpoint (Checkpoint::create semantics)."""
    sorted_mode = isinstance(cbf, SortedKmerFilter)
    if sorted_mode:
        counting = np.stack([u64.to_numpy(cbf.kmers),
                             cbf.counts.cpu().numpy().astype(np.uint64)])
    elif isinstance(cbf, CountingBloomFilter):
        counting = cbf.counters.cpu().numpy()
    else:
        raise TypeError(f"cannot checkpoint a {type(cbf).__name__}")
    os.makedirs(ckpt_dir, exist_ok=True)
    np.save(_tmp(os.path.join(ckpt_dir, "counting.npy")), counting)
    np.save(_tmp(os.path.join(ckpt_dir, "visited.npy")),
            visited.bits.cpu().numpy())
    state = dict(reads_processed=reads_processed, counters=counters,
                 k=cbf.k, num_hashes=cbf.num_hashes,
                 threshold=cbf.threshold, sorted_mode=sorted_mode)
    with open(_tmp(os.path.join(ckpt_dir, "state.json")), "w") as f:
        json.dump(state, f)
    contigs_dst = os.path.join(ckpt_dir, "contigs.fa")
    if partial_contigs_path and os.path.exists(partial_contigs_path):
        shutil.copy(partial_contigs_path, _tmp(contigs_dst))
    else:
        open(_tmp(contigs_dst), "a").close()
    # atomic publish: rename all tmp files (npy adds .npy to tmp names)
    for name in ("counting.npy", "visited.npy"):
        os.replace(os.path.join(ckpt_dir, name + ".tmp.npy"),
                   os.path.join(ckpt_dir, name))
    for name in ("state.json", "contigs.fa"):
        os.replace(_tmp(os.path.join(ckpt_dir, name)),
                   os.path.join(ckpt_dir, name))


def exists(ckpt_dir: str) -> bool:
    return all(os.path.exists(os.path.join(ckpt_dir, f)) for f in FILES)


def load(ckpt_dir: str, device="cuda"):
    """Returns (cbf, visited, reads_processed, counters) on `device`."""
    with open(os.path.join(ckpt_dir, "state.json")) as f:
        state = json.load(f)
    counting = np.load(os.path.join(ckpt_dir, "counting.npy"))
    visited = np.load(os.path.join(ckpt_dir, "visited.npy"))
    kw = dict(k=state["k"], threshold=state["threshold"],
              visited_bits=visited, num_hashes=state["num_hashes"],
              device=device)
    if state.get("sorted_mode"):
        cbf, vis = convert.from_numpy_state(
            counting[0], counting[1].astype(np.int32), **kw)
    else:
        cbf, vis = convert.counting_filter_from_numpy(counting, **kw)
    return cbf, vis, state["reads_processed"], state["counters"]


def remove(ckpt_dir: str):
    """Delete checkpoint files after a successful run."""
    for f in FILES:
        p = os.path.join(ckpt_dir, f)
        if os.path.exists(p):
            os.remove(p)
    if os.path.isdir(ckpt_dir):
        try:
            os.rmdir(ckpt_dir)
        except OSError:
            pass
