"""Seconds a job spends mapping reads to contigs, both mappings (stages
4-5 to the unitigs and 7-8 to the contigs): align.mapper's index, the
vote kernel and the host chaining, and fixmate
(pipeline.pe._map_library), mean over the window's jobs."""

UNIT = "s"
LAYER = "align.mapper"
MOVES = "read_mbp_per_s"
SPANS = {"pe._map_library": ("abyss_tpu_torch.pipeline.pe", "_map_library")}


def read(run):
    return run.span_mean("pe._map_library")
