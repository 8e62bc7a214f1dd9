"""Seconds a job spends counting k-mer pairs in the paired de Bruijn
graph (abyss_tpu_torch.dbg.paired_dbg.count_pairs: the pairs of every
read window packed and counted on the card by the sorted counter),
mean over the window's jobs."""

UNIT = "s"
LAYER = "dbg.paired_dbg"
MOVES = "read_mbp_per_s"
SPANS = {"paired_dbg.count_pairs": ("abyss_tpu_torch.dbg.paired_dbg",
                                    "count_pairs")}


def read(run):
    return run.span_mean("paired_dbg.count_pairs")
