"""Seconds a job spends in the exact engine's graph phases: coverage
model, side arrays, adjacency, erode, trim, the low-coverage loop,
bubbles and emission (dbg.hash_dbg and dbg.chain_ops), as
hash_dbg.assemble_reads less its count, mean over the window's jobs."""

UNIT = "s"
LAYER = "dbg.hash_dbg graph"
MOVES = "read_mbp_per_s"
SPANS = {"hash_dbg.assemble_reads": ("abyss_tpu_torch.dbg.hash_dbg",
                                     "assemble_reads"),
         "hash_dbg.count_kmers": ("abyss_tpu_torch.dbg.hash_dbg",
                                  "count_kmers")}


def read(run):
    vals = [j["hash_dbg.assemble_reads"] - j.get("hash_dbg.count_kmers", 0.0)
            for j in run.jobs if "hash_dbg.assemble_reads" in j]
    return sum(vals) / len(vals) if vals else None
