"""Where the time of one benchmark cell's jobs goes, by the port's own
tracer (abyss_tpu_torch/utils/trace.py), on an NVIDIA card.

    python3 scripts/trace_cell.py --workload bloom-k96.unitigs \
        --seed 12345 [--pairs 2] [--out trace_cell.json]

Makes the cell's reads as `python3 -m asmbench.run` does (asmbench's
generator and traffic file), runs one warm-up job, then `--pairs`
pairs of jobs with the tracer off and on (off first in even pairs, on
first in odd ones), and last one traced job under torch.profiler.  The
JSON holds each job's wall seconds; the traced jobs' spans (total and
self seconds) and counters; and for the profiled job the device's busy
time, its idle stretches summed by the innermost span of the tracer
open over each ("job" where none is), the device operations by time,
and the walk kernel's share of its memory roofline from the `walk.*`
counters (chip_smoke.py's bytes model).  The tracer's `abyss.*` ranges
are host spans here, never device work.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, the published bandwidth
# chip_smoke.py's walk bytes: 8 probed 64-byte table windows (8 32-byte
# counter sectors in a counting filter) and 2 buffer bytes a lane step,
# the bases written, 60 bytes of lane state a lane
WALK_TABLE_BYTES_PER_STEP = 8 * 64 + 2
WALK_BLOOM_BYTES_PER_STEP = 8 * 32 + 2
WALK_LANE_BYTES = 60
JOB_RANGE = "trace_cell.job"


def walk_bytes(counts: dict, table: bool) -> int:
    per_step = WALK_TABLE_BYTES_PER_STEP if table \
        else WALK_BLOOM_BYTES_PER_STEP
    return (counts.get("walk.lane_steps", 0) * per_step
            + counts.get("walk.bases", 0)
            + counts.get("walk.lanes", 0) * WALK_LANE_BYTES)


def profile_summary(prof, counts: dict) -> dict:
    """Busy and idle seconds of the profiled job, idle by innermost span
    of the tracer, the top device operations, the walk roofline."""
    from torch.autograd import DeviceType
    from abyss_tpu_torch.utils import trace
    from asmbench.trace import idle_gaps, union_seconds
    ops, spans, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith((trace.PREFIX, JOB_RANGE)):
                ops.append((e.name, s, t))
        elif e.name == JOB_RANGE:
            window = (s, t)
        elif e.name.startswith(trace.PREFIX):
            spans.append((e.name[len(trace.PREFIX):], s, t))
    lo, hi = window
    ops = [(n, max(s, lo), min(t, hi)) for n, s, t in ops
           if t > lo and s < hi]
    busy = union_seconds([(s, t) for _, s, t in ops])
    idle = defaultdict(float)
    for gs, ge in idle_gaps([(s, t) for _, s, t in ops], lo, hi):
        mid = (gs + ge) / 2
        inner = None
        for name, s, t in spans:
            if s <= mid < t and (inner is None or s >= inner[1]):
                inner = (name, s)
        idle[inner[0] if inner else "job"] += ge - gs
    by_op = defaultdict(float)
    for n, s, t in ops:
        by_op[n[:120]] += t - s
    walk_ops = [(n, t - s) for n, s, t in ops if "walk_kernel" in n]
    walk_s = sum(d for _, d in walk_ops)
    table = any("TableSolid" in n for n, _ in walk_ops)
    nbytes = walk_bytes(counts, table)
    return dict(
        window_s=hi - lo, busy_s=busy,
        idle_share=100.0 * (1.0 - busy / (hi - lo)),
        idle_by_span=sorted(idle.items(), key=lambda kv: -kv[1]),
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:12],
        walk_kernel_s=walk_s, walk_launches=len(walk_ops),
        walk_bytes=nbytes, walk_table=table,
        walk_roofline=(100.0 * nbytes / HBM_BYTES_PER_S / walk_s
                       if walk_s > 0 else None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from abyss_tpu_torch.ops import kernels
    from abyss_tpu_torch.utils import trace
    from asmbench import jobs, registry
    from asmbench.run import Inputs
    if not torch.cuda.is_available():
        print("trace_cell: needs a CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark(REPO)
    cell = registry.cell(bench, args.workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    work = tempfile.mkdtemp(prefix="trace_cell-")
    out = dict(workload=args.workload, seed=args.seed,
               card=torch.cuda.get_device_name(0), jobs=[])
    try:
        inputs = Inputs(traffic["genome"], traffic["reads"], args.seed,
                        work, "reads")
        kernels.build_all()
        warm = Inputs(dict(traffic["genome"],
                           seed=traffic["genome"]["seed"] + 1),
                      dict(traffic["reads"],
                           sample_seed=traffic["reads"]["sample_seed"] + 1),
                      args.seed, work, "warm",
                      length=traffic["warmup_genome_bp"])
        jobs.run_job(traffic["target"], config, warm.paths,
                     os.path.join(work, "warmup"), "cuda")
        order = []
        for i in range(args.pairs):
            order += [False, True] if i % 2 == 0 else [True, False]
        for i, traced in enumerate(order + [True]):
            profiled = i == len(order)
            prof = None
            if profiled:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            trace.enable(traced)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(JOB_RANGE):
                jobs.run_job(traffic["target"], config, inputs.paths,
                             os.path.join(work, f"job{i}"), "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            trace.enable(False)
            records = trace.take()
            row = dict(traced=traced, profiled=profiled, wall_s=wall)
            if traced:
                counts = trace.counter_totals(records)
                row.update(
                    spans_s=trace.span_seconds(records),
                    self_s=trace.self_seconds(records), counts=counts)
            if prof is not None:
                prof.__exit__(None, None, None)
                row["profile"] = profile_summary(prof, row["counts"])
            out["jobs"].append(row)
            print(json.dumps({k: v for k, v in row.items()
                              if k in ("traced", "profiled", "wall_s")}),
                  flush=True)
        plain = [j["wall_s"] for j in out["jobs"] if not j["traced"]]
        on = [j["wall_s"] for j in out["jobs"]
              if j["traced"] and not j["profiled"]]
        out["median_off_s"] = statistics.median(plain) if plain else None
        out["median_on_s"] = statistics.median(on) if on else None
    finally:
        shutil.rmtree(work, ignore_errors=True)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text[-6000:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
