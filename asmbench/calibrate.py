"""Readings for the limits of `correct`: the numbers the reference gives
(reference.py) for sound jobs of a cell on many seeds, and for jobs
with the control or a fault planted (faults.py) on a few, in one
process.  Each seed draws its own sequencing run, or with
--traffic-sample orders the traffic file's one, as the benchmark's
runs do.  Not part of a benchmark run.

    python3 -m asmbench.calibrate --workload bloom-k96.unitigs \
        --seeds 11 12 13 ... --plant-seeds 11 12 13 \
        [--plants control half_batch unchanged altered] [--traffic-sample]

prints one JSON line per job: workload, seed, plant ("sound" or the
plant's name), the job's seconds and the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

from . import faults, jobs, registry
from .run import CHECKOUT, HERE, Inputs, forbidden_modules


def numbers_of(ref, out: dict | None, traffic: dict, config: dict) -> dict:
    from .gen import parse_fasta
    if out is None:
        return {"failed_jobs": 1}
    nums = ref.unitig_numbers(parse_fasta(out["unitigs"]),
                              config.get("kc", 2))
    if traffic["target"] == "pe":
        nums.update(ref.scaffold_numbers(parse_fasta(out["final"])))
    return nums


def readings(bench: dict, workload: str, seeds, plant_seeds, plants,
             device, base: str = HERE, traffic_sample: bool = False):
    """Yield one dict a job: seed, plant, job_s and the numbers."""
    import torch
    from .reference import Reference
    cell = registry.cell(bench, workload)
    config = registry.config(cell["config"], base)
    traffic = registry.traffic(cell["traffic"], base)
    workdir = tempfile.mkdtemp(prefix="asmbench-cal-")
    try:
        for n, seed in enumerate(seeds):
            # a fresh sequencing run a seed: the limits have to hold for
            # any sample, not for one sample's orders only
            reads = traffic["reads"] if traffic_sample else \
                dict(traffic["reads"], sample_seed=seed)
            inputs = Inputs(traffic["genome"], reads, seed, workdir, "reads")
            if n == 0:
                warm = Inputs(dict(traffic["genome"],
                                   seed=traffic["genome"]["seed"] + 1),
                              dict(traffic["reads"], sample_seed=traffic[
                                  "reads"]["sample_seed"] + 1),
                              seed, workdir, "warm",
                              length=traffic["warmup_genome_bp"])
                jobs.run_job(traffic["target"], config, warm.paths,
                             os.path.join(workdir, "warm"), device)
            ref = Reference(list(inputs.reads), inputs.genome, config["k"],
                            device)
            todo = ["sound"] + (list(plants) if seed in plant_seeds else [])
            for plant in todo:
                t0 = time.perf_counter()
                out = None
                try:
                    ctx = faults.PLANTS[plant]() if plant != "sound" else \
                        faults.patched()
                    with ctx:
                        out = jobs.run_job(traffic["target"], config,
                                           inputs.paths,
                                           os.path.join(workdir, "job"),
                                           device)
                except Exception:
                    traceback.print_exc()
                yield {"workload": workload, "seed": seed, "plant": plant,
                       "job_s": time.perf_counter() - t0,
                       "numbers": numbers_of(ref, out, traffic, config)}
            del ref
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m asmbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--plant-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--plants", nargs="*",
                    help="default: every plant of the cell's target")
    ap.add_argument("--traffic-sample", action="store_true",
                    help="order the traffic file's sample, as a run does")
    args = ap.parse_args(argv)
    bench = registry.benchmark(CHECKOUT)
    cell = registry.cell(bench, args.workload)
    plants = args.plants if args.plants is not None else faults.plants_for(
        registry.traffic(cell["traffic"])["target"])
    for row in readings(bench, args.workload, args.seeds, args.plant_seeds,
                        plants, "cuda", traffic_sample=args.traffic_sample):
        print(json.dumps(row), flush=True)
    found = forbidden_modules()
    if found:
        print(f"asmbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
