"""Seconds a job spends in pass 1 of the bloom engine: the ntHash of
every read and the count of the solid k-mers
(abyss_tpu_torch.dbg.bloom_dbg.load_filter), mean over the window's
jobs."""

UNIT = "s"
LAYER = "dbg.bloom_dbg pass 1"
MOVES = "read_mbp_per_s"
SPANS = {"bloom_dbg.load_filter": ("abyss_tpu_torch.dbg.bloom_dbg",
                                   "load_filter")}


def read(run):
    return run.span_mean("bloom_dbg.load_filter")
