"""Seconds a job spends on the packed pair graph between counting and
emission: the kc filter, the adjacency probe, the trim rounds, the
links, ranks and order of the chains (dbg.paired_dbg.assemble_pairs
less count_pairs and _emit_packed_chains), mean over the window's
jobs.  Left out where the program has no emission function to take
away (as paired_dbg.emit_s)."""

import importlib

UNIT = "s"
LAYER = "dbg.paired_dbg"
MOVES = "read_mbp_per_s"
MODULE = "abyss_tpu_torch.dbg.paired_dbg"
EMIT = "_emit_packed_chains"
SPANS = {"paired_dbg.assemble_pairs": (MODULE, "assemble_pairs"),
         "paired_dbg.count_pairs": (MODULE, "count_pairs")}
try:
    if hasattr(importlib.import_module(MODULE), EMIT):
        SPANS["paired_dbg.emit"] = (MODULE, EMIT)
except ImportError:
    pass
PARTS = ("paired_dbg.count_pairs", "paired_dbg.emit")


def read(run):
    vals = [j["paired_dbg.assemble_pairs"] - sum(j[p] for p in PARTS)
            for j in run.jobs
            if "paired_dbg.assemble_pairs" in j and all(p in j for p in PARTS)]
    return sum(vals) / len(vals) if vals else None
