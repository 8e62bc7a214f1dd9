"""Time one checkout's ntHash kernel on the main run's launch shapes.

    python3 scripts/nthash_shapes_ab.py TREE

TREE is the root of a checkout of this repository: this one (`.`) or a
`git archive` of another commit.  The codes are the ones that
`python3 chip_smoke.py`, run from this script's checkout, kept of each
ntHash launch shape of its main run and of its pass-1 batch 150
(`.chip_smoke_shapes/nthash_codes.pt`), and chip_smoke's synthetic
[4096, 512] batch.  TREE's kernel is built from TREE's sources, held bit
for bit against TREE's plain version at every shape (chip_smoke's
nthash_check), and timed by chip_smoke's graph_ms: CUDA events around a
CUDA graph of launches, so no wrapper host time.  Prints one JSON line:
each shape's ms, launches and bound, launches x (ms - bound_ms) summed
over the shapes, and the two batches' ms.

To compare two commits, run it on both in turns in one call on the card
(parent, change, change, parent), after one chip_smoke.py run.
"""

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    tree = os.path.abspath(sys.argv[1])
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # TREE's package, not this checkout's, from here on
    sys.path.insert(0, tree)
    import torch
    from abyss_tpu_torch.ops import kernels
    if not kernels.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {kernels.__file__}, not {tree}'s")
    saved = torch.load(smoke.SHAPES_FILE)
    dev = torch.device("cuda")

    def timed(codes, k, strands):
        codes = codes.to(dev)
        smoke.nthash_check(codes, k)
        ms = smoke.graph_ms(lambda: kernels.nthash(codes, k, strands),
                            smoke._graph_reps(codes, k, strands))
        return ms, smoke.nthash_bound(codes, k, strands)["bound_ms"]

    rows = []
    for s in saved["shapes"]:
        pass_, B, L, k, strands = s["key"]
        ms, bound = timed(s["codes"], k, strands)
        rows.append(dict(name=pass_, shape=[B, L], k=k, strands=strands,
                         launches=s["launches"], ms=ms, bound_ms=bound))
    synthetic = torch.from_numpy(smoke._smoke_codes(4096, 512, seed=2024))
    print(json.dumps(dict(
        tree=tree, gap_ms=sum(r["launches"] * (r["ms"] - r["bound_ms"])
                              for r in rows),
        pass1_batch_ms=timed(saved["pass1_batch"], 31, False)[0],
        synthetic_ms=timed(synthetic, 31, False)[0], shapes=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
