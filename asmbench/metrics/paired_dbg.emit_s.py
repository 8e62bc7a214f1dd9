"""Seconds a job spends spelling the packed pair graph's chains as
unitigs (abyss_tpu_torch.dbg.paired_dbg._emit_packed_chains: a host
loop over every row of every chain), mean over the window's jobs.  A
program without that function has no span here, and the metric is
left out."""

import importlib

UNIT = "s"
LAYER = "dbg.paired_dbg"
MOVES = "read_mbp_per_s"
MODULE = "abyss_tpu_torch.dbg.paired_dbg"
EMIT = "_emit_packed_chains"
SPANS = {}
try:
    if hasattr(importlib.import_module(MODULE), EMIT):
        SPANS["paired_dbg.emit"] = (MODULE, EMIT)
except ImportError:
    pass


def read(run):
    return run.span_mean("paired_dbg.emit")
