"""Seconds a job spends in pe's stages 2-3: the overlap graph,
RResolver, filtergraph and PopBubbles (graph.adjlist, graph.rresolver,
graph.algorithms; pipeline.pe.stage_graph_2_3), mean over the window's
jobs."""

UNIT = "s"
LAYER = "graph"
MOVES = "read_mbp_per_s"
SPANS = {"pe.stage_graph_2_3": ("abyss_tpu_torch.pipeline.pe",
                                "stage_graph_2_3")}


def read(run):
    return run.span_mean("pe.stage_graph_2_3")
