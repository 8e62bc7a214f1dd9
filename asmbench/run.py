"""One run of one benchmark cell of abyss_tpu_torch.

    python3 -m asmbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up: the cell's genome and reads are
drawn from the traffic file's seeds and put in the order --seed draws
(gen.py), then written as FASTQ under TMPDIR, the kernel libraries
are loaded (built on the first run, into the port's build directory in
the checkout), and one warm-up job runs on a small genome with the
cell's configuration.  The window: a closed loop of whole jobs (the
program's `pe` or its stage 1), each in a fresh output directory; a new
job starts while less than --seconds have passed, and the window ends
when the last job has ended.  Then the reference (reference.py) checks
the output, and the last line of standard output is the result as JSON.
With --trace 1 the metrics are the cell's per-layer metrics
(metrics/*.py), read from spans, calls and a profile of the window's
first job (trace.py); the spans of the profiled job, which the
profiler slows on the host, are left out where the window holds
another.

The run fails, printing no result, without an NVIDIA card (no CPU
fallback), and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)

from . import check, gen, jobs, registry, trace  # noqa: E402
from .contiguity import ng50  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "abyss_tpu")
MAX_PROFILED_OPS = 10


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Inputs:
    """A genome and the reads drawn from it, on disk as two FASTQ."""

    def __init__(self, genome_spec: dict, reads_spec: dict, seed: int,
                 workdir: str, tag: str, length: int | None = None):
        g = dict(genome_spec)
        if length is not None:
            g["length"] = length
        self.genome = gen.genome_with_repeats(
            g["length"], g["seed"], g["n_repeats"], g["repeat_len"])
        r = reads_spec
        self.n_pairs = int(len(self.genome) * r["coverage"]
                           / (2 * r["read_len"]))
        # the sequencing run is the traffic file's; --seed orders its pairs
        self.reads = gen.arrival_order(gen.simulate_pairs(
            self.genome, self.n_pairs, r["read_len"], r["fragment_mean"],
            r["fragment_sd"], r["error_rate"], r["sample_seed"]), seed)
        self.paths = [os.path.join(workdir, f"{tag}_{m}.fq") for m in (1, 2)]
        for mate, (path, rows) in enumerate(zip(self.paths, self.reads), 1):
            gen.write_fastq(path, rows, mate)
        self.bases = sum(int(r.size) for r in self.reads)


def read_rate(bases_per_job: int, jobs: int, wall_s: float) -> float:
    """Mbp of input reads a second: all jobs' bases over the window's
    wall time, from its start to the end of its last job."""
    return bases_per_job * jobs / wall_s / 1e6


def _sync_for(device):
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


class Window:
    """What the window produced: outputs, wall time, peak, traces."""

    def __init__(self):
        self.outputs: list[dict | None] = []
        self.first: dict | None = None
        self.wall_s = 0.0
        self.peak_bytes = 0
        self.recorder: trace.Recorder | None = None
        self.profile: trace.Profile | None = None


def run_window(cell_cfg: dict, traffic: dict, inputs: Inputs, seconds: float,
               device, workdir: str, tracing: bool, spans: dict,
               calls: dict) -> Window:
    import torch
    is_cuda = torch.device(device).type == "cuda"
    sync = _sync_for(device)
    w = Window()
    if tracing:
        w.recorder = trace.Recorder(sync)
        w.recorder.install(spans, calls)
    prof = None
    try:
        sync()
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        i = 0
        while True:
            profiling = tracing and i == 0
            if profiling:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if is_cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
            outer = prof if profiling else contextlib.nullcontext()
            inner = w.recorder.job() if tracing else contextlib.nullcontext()
            out = None
            try:
                with outer, inner:
                    out = jobs.run_job(traffic["target"], cell_cfg,
                                       inputs.paths,
                                       os.path.join(workdir, f"job{i}"),
                                       device)
            except Exception:  # a failed job is counted, the loop goes on
                traceback.print_exc()
            if out is not None and w.first is None:
                w.first = out
            w.outputs.append(None if out is None else
                             {"final": out["final"]})
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        w.wall_s = time.perf_counter() - t0
        if is_cuda:
            w.peak_bytes = torch.cuda.max_memory_allocated()
    finally:
        if w.recorder is not None:
            w.recorder.remove()
    if prof is not None:
        w.profile = trace.Profile.from_profiler(prof)
        del prof
    return w


class TraceView:
    """What a per-layer metric reads: the spans of each job the profiler
    did not slow (the profiled first job's only where the window held no
    other), and the profile of the first job with the calls it made."""

    def __init__(self, w: Window):
        jobs = w.recorder.jobs if w.recorder else []
        self.jobs = jobs[1:] if len(jobs) > 1 else jobs
        calls = w.recorder.calls if w.recorder else []
        self.profile_calls = calls[0] if calls else {}
        self.profile = w.profile

    def span_mean(self, name: str) -> float | None:
        vals = [j[name] for j in self.jobs if name in j]
        return sum(vals) / len(vals) if vals else None


def reference_numbers(w: Window, traffic: dict, config: dict,
                      inputs: Inputs, device) -> dict:
    """The numbers that decide `correct` (check.py, reference.py)."""
    from .reference import Reference
    numbers = check.job_numbers(w.outputs)
    if w.first is None:
        return numbers
    ref = Reference(list(inputs.reads), inputs.genome, config["k"], device)
    numbers.update(ref.unitig_numbers(gen.parse_fasta(w.first["unitigs"]),
                                      config.get("kc", 2)))
    if traffic["target"] == "pe":
        numbers.update(ref.scaffold_numbers(gen.parse_fasta(w.first["final"])))
    return numbers


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             tracing: bool, device, t_start: float, base: str = HERE,
             under_window=contextlib.nullcontext):
    """One run of a cell on `device`; (result dict, check rows).
    `under_window` is entered around the window alone (the tests plant
    faults under the timed path with it)."""
    import torch
    cell = registry.cell(bench, workload)
    config = registry.config(cell["config"], base)
    traffic = registry.traffic(cell["traffic"], base)
    per_layer = registry.cell_metrics(bench, workload, "per_layer")
    readers = {m["name"]: registry.metric(m["name"], base) for m in per_layer}
    spans, calls = {}, {}
    for mod in readers.values():
        spans.update(getattr(mod, "SPANS", {}))
        calls.update(getattr(mod, "CALLS", {}))
    workdir = tempfile.mkdtemp(prefix="asmbench-")
    try:
        inputs = Inputs(traffic["genome"], traffic["reads"], seed, workdir,
                        "reads")
        if torch.device(device).type == "cuda":
            from abyss_tpu_torch.ops import kernels
            kernels.build_all()
        warm = Inputs(dict(traffic["genome"],
                           seed=traffic["genome"]["seed"] + 1),
                      dict(traffic["reads"],
                           sample_seed=traffic["reads"]["sample_seed"] + 1),
                      seed, workdir, "warm",
                      length=traffic["warmup_genome_bp"])
        jobs.run_job(traffic["target"], config, warm.paths,
                     os.path.join(workdir, "warmup"), device)
        del warm
        setup_s = time.perf_counter() - t_start
        with under_window():
            w = run_window(config, traffic, inputs, seconds, device,
                           workdir, tracing, spans, calls)
        attempted = len(w.outputs)
        metrics = {}
        if tracing:
            view = TraceView(w)
            for m in per_layer:
                value = readers[m["name"]].read(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            final = gen.parse_fasta(w.first["final"]) if w.first else []
            values = {
                "read_mbp_per_s": read_rate(inputs.bases, attempted, w.wall_s),
                "peak_mem_gib": w.peak_bytes / 2 ** 30,
                "ng50_kbp": ng50([len(s) for _, s in final],
                                 len(inputs.genome)) / 1e3,
                "setup_s": setup_s,
            }
            for m in registry.cell_metrics(bench, workload, "end_to_end"):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        dev = torch.device(device)
        result = {
            "attempted": attempted,
            "failed": 0,
            "metrics": metrics,
            "device": {
                "platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                         else "cpu"),
                "count": cell["chips"],
                "memory_peak_bytes": w.peak_bytes,
            },
        }
        if tracing and w.profile is not None and w.profile.window:
            result["device"]["busy_s"] = w.profile.busy_s()
            result["device"]["window_s"] = w.profile.window_s()
            result["breakdown"] = {
                "device_ops": w.profile.top_ops(MAX_PROFILED_OPS),
                "idle_gaps": w.profile.idle_by_span(MAX_PROFILED_OPS)}
        # the reference runs once the window's state is gone
        w.profile = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers = reference_numbers(w, traffic, config, inputs, device)
        rows = check.compare(numbers, traffic["limits"])
        result["readings"] = {k: v for k, v in numbers.items()
                              if k not in traffic["limits"]}
        result["failed"] = numbers["failed_jobs"] + numbers["fasta_differs"]
        result["correct"] = check.passed(rows)
        return result, rows
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def emit(result: dict, rows) -> None:
    """The compared numbers last on standard error, and the result as the
    last line of standard output, with the numbers under `checks`."""
    for name, value in sorted(result.get("readings", {}).items()):
        print(f"reading {name} {value!r} (no limit)", file=sys.stderr)
    for name, value, op, limit in rows:
        print(f"check {name} {value!r} limit {op} {limit!r} "
              f"{'ok' if check.ok(value, op, limit) else 'FAIL'}",
              file=sys.stderr)
    ordered = {"correct": result["correct"], "attempted": result["attempted"],
               "failed": result["failed"], "metrics": result["metrics"],
               "device": result["device"]}
    if "breakdown" in result:
        ordered["breakdown"] = result["breakdown"]
    # a number that was never read (inf) goes out as null
    ordered["checks"] = {name: {"value": value if abs(value) != float("inf")
                                else None, "op": op, "limit": limit}
                         for name, value, op, limit in rows}
    sys.stderr.flush()
    print(json.dumps(ordered), flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m asmbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = registry.benchmark(CHECKOUT)
    cell = registry.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"asmbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    if "NVIDIA" not in kind:
        print(f"asmbench: {kind!r} is not an NVIDIA card", file=sys.stderr)
        return 2
    result, rows = run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"asmbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
