"""Seconds a job spends in pass 2 of the bloom engine: the read-seeded
walks (Assembler, dbg.extend and the walk kernels) and the unitigs'
emission, as bloom_dbg.assemble less its pass 1, mean over the
window's jobs."""

UNIT = "s"
LAYER = "dbg.bloom_dbg pass 2"
MOVES = "read_mbp_per_s"
SPANS = {"bloom_dbg.assemble": ("abyss_tpu_torch.dbg.bloom_dbg", "assemble"),
         "bloom_dbg.load_filter": ("abyss_tpu_torch.dbg.bloom_dbg",
                                   "load_filter")}


def read(run):
    vals = [j["bloom_dbg.assemble"] - j.get("bloom_dbg.load_filter", 0.0)
            for j in run.jobs if "bloom_dbg.assemble" in j]
    return sum(vals) / len(vals) if vals else None
