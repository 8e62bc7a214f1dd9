"""Seconds a job spends in pe's stages 4-8 outside the read mappings:
DistanceEst (align.distance_est), the paths, consensus and merges of
stages 4-6 and the scaffolder of stages 7-8 (scaffold.*), as
stage_dist_5 + stage_contigs_6 + stage_scaffolds_8 less
pe._map_library, mean over the window's jobs."""

UNIT = "s"
LAYER = "scaffold"
MOVES = "read_mbp_per_s"
STAGES = ("pe.stage_dist_5", "pe.stage_contigs_6", "pe.stage_scaffolds_8")
SPANS = {name: ("abyss_tpu_torch.pipeline.pe", name.split(".")[1])
         for name in STAGES}
SPANS["pe._map_library"] = ("abyss_tpu_torch.pipeline.pe", "_map_library")


def read(run):
    vals = [sum(j.get(s, 0.0) for s in STAGES) - j.get("pe._map_library", 0.0)
            for j in run.jobs if any(s in j for s in STAGES)]
    return sum(vals) / len(vals) if vals else None
