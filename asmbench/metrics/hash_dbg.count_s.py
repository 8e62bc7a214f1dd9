"""Seconds a job spends counting k-mers in the exact engine
(abyss_tpu_torch.dbg.hash_dbg.count_kmers: ntHash keys at k > 32, the
sorted count), mean over the window's jobs."""

UNIT = "s"
LAYER = "dbg.hash_dbg count"
MOVES = "read_mbp_per_s"
SPANS = {"hash_dbg.count_kmers": ("abyss_tpu_torch.dbg.hash_dbg",
                                  "count_kmers")}


def read(run):
    return run.span_mean("hash_dbg.count_kmers")
