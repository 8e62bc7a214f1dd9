"""One job of a cell: the program's entry point on the cell's reads, in
a fresh output directory.  The program is imported here alone."""

from __future__ import annotations

import os
import shutil

def pipeline_params(config: dict, paths: list[str], outdir: str, device):
    """pe's PipelineParams from the configuration file's keys that name
    one of its fields (the others describe the configuration)."""
    import dataclasses
    from abyss_tpu_torch.pipeline import pe
    names = {f.name for f in dataclasses.fields(pe.PipelineParams)}
    fields = {k: v for k, v in config.items() if k in names}
    # logging is the harness's choice, not the configuration's
    return pe.PipelineParams(in_files=list(paths), outdir=outdir,
                             device=str(device), verbose=0, **fields)


def final_fasta(target: str, name: str) -> str:
    """The file a user takes away: scaffolds for pe, unitigs else."""
    return f"{name}-8.fa" if target == "pe" else f"{name}-1.fa"


def run_job(target: str, config: dict, paths: list[str], outdir: str,
            device) -> dict[str, bytes]:
    """Run one job in `outdir` (made here, removed before returning);
    returns the bytes of the unitigs and of the final FASTA."""
    from abyss_tpu_torch.pipeline import pe
    os.makedirs(outdir)
    try:
        p = pipeline_params(config, paths, outdir, device)
        if target == "pe":
            pe.run(p)
        elif target == "unitigs":
            pe.stage_unitigs_1(p)
        else:
            raise ValueError(f"unknown target {target!r}")
        out = {}
        for key, fname in (("unitigs", f"{p.name}-1.fa"),
                           ("final", final_fasta(target, p.name))):
            with open(os.path.join(outdir, fname), "rb") as f:
                out[key] = f.read()
        return out
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
