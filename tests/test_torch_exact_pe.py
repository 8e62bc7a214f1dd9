"""The exact engine end to end, colour space and linked reads: the
port against abyss_tpu on the CPU, every artifact byte for byte.

  * `pe engine=exact` at wide k (k = 40, the input of
    tests/test_pipeline.py::test_pipeline_exact_engine_wide_k);
  * colour-space `pe` (tests/test_cs_pipeline.py's reads, exact engine);
  * the linked-read flow (scaffold/linked_reads.py) on
    tests/test_linked_reads.py's cases.
"""

import os

import numpy as np
import torch

from abyss_tpu import sim
from abyss_tpu.align.mapper import KmerAligner as JAligner
from abyss_tpu.core import alphabet
from abyss_tpu.pipeline import pe as jpe
from abyss_tpu.scaffold import linked_reads as jlr
from abyss_tpu_torch.align.mapper import KmerAligner as TAligner
from abyss_tpu_torch.pipeline import pe as tpe
from abyss_tpu_torch.scaffold import linked_reads as tlr

# one intra-op thread a worker process (see test_torch_hash_dbg.py)
torch.set_num_threads(1)


def tree(d) -> dict:
    """{file name: bytes, or "-> target" for a link} of a directory."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        out[name] = ("-> " + os.readlink(path)) if os.path.islink(path) \
            else open(path, "rb").read()
    return out


def run_both(make, tmp_path) -> tuple[dict, dict]:
    """(JAX tree, port tree) of pe.run(make(module, outdir))."""
    out = []
    for mod, tag in ((jpe, "jax"), (tpe, "port")):
        d = str(tmp_path / tag)
        mod.run(make(mod, d))
        out.append(tree(d))
    return out[0], out[1]


def test_pe_exact_wide_k(tmp_path):
    genome = sim.random_genome(8000, seed=401)
    pr = sim.simulate_paired_reads(genome, coverage=30, read_len=100,
                                   error_rate=0.001, seed=402)
    p1, p2 = str(tmp_path / "w1.fq"), str(tmp_path / "w2.fq")
    pr.write_fastq(p1, p2)

    def make(mod, d):
        extra = {"device": "cpu"} if mod is tpe else {}
        return mod.PipelineParams(
            name="w", k=40, in_files=[p1, p2], engine="exact", outdir=d,
            min_pairs=5, verbose=0, batch_size=2048, max_read_len=128,
            **extra)

    want, got = run_both(make, tmp_path)
    assert got == want
    assert len(want) >= 30
    scaffolds = want["w-8.fa"].decode().split(">")[1:]
    assert sum(len(s.split("\n", 1)[1].replace("\n", ""))
               for s in scaffolds) > 0.9 * len(genome)


def test_pe_colour_space(tmp_path):
    """Colour-space reads through the exact engine: the cs flow stops
    after stage 6 with name-cs.fa and nucleotide name-6.fa."""
    genome = sim.random_genome(4000, seed=33)
    reads = str(tmp_path / "reads-cs.fa")
    with open(reads, "w") as f:
        for i, s in enumerate(range(0, len(genome) - 60, 4)):
            r = genome[s:s + 60]
            if (s // 4) % 2:
                r = alphabet.revcomp(r)
            f.write(f">r{i}\n{alphabet.nucleotide_to_colour(r)}\n")

    def make(mod, d):
        extra = {"device": "cpu"} if mod is tpe else {}
        return mod.PipelineParams(
            name="cs", k=25, in_files=[reads], outdir=d, engine="exact",
            kc=2, verbose=0, min_pairs=2, min_len=100, **extra)

    want, got = run_both(make, tmp_path)
    assert got == want
    assert "cs-cs.fa" in want and "cs-8.fa" not in want
    seqs = [s.split("\n", 1)[1].replace("\n", "")
            for s in want["cs-6.fa"].decode().split(">")[1:]]
    grc = alphabet.revcomp(genome)
    big = [max(s.split("N"), key=len) for s in seqs if len(s) >= 200]
    assert big and all(c in genome or c in grc for c in big)


# --------------------------------------------------------------------------
# linked reads (tests/test_linked_reads.py's cases)


def linked_reads(genome, n_molecules=60, mol_len=800, reads_per_mol=12,
                 read_len=60, seed=0):
    rng = np.random.default_rng(seed)
    reads = []
    for m in range(n_molecules):
        start = int(rng.integers(0, max(1, len(genome) - mol_len)))
        bc = f"BC{m:04d}"
        for r in range(reads_per_mol):
            pos = start + int(rng.integers(0, mol_len - read_len))
            reads.append((f"m{m}r{r}", genome[pos:pos + read_len], bc))
    return reads


def align_both(contigs, reads):
    codes = np.full((len(reads), 64), alphabet.BAD, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, (rid, seq, bc) in enumerate(reads):
        c = alphabet.encode(seq)
        codes[i, :len(c)] = c
        lens[i] = len(c)
    ids = [rid for rid, _, _ in reads]
    j = JAligner(contigs, k=32).align_batch(codes, lens, ids)
    t = TAligner(contigs, k=32, device="cpu").align_batch(codes, lens, ids)
    assert [vars(a) if a else None for a in t] == \
        [vars(a) if a else None for a in j]
    return t, {rid: bc for rid, _, bc in reads}


def molecules(mols):
    return [vars(m) for m in mols]


def test_linked_infer_molecules():
    genome = sim.random_genome(4000, seed=2)
    alns, barcodes = align_both([("g", genome)],
                                linked_reads(genome, n_molecules=20, seed=2))
    got = tlr.infer_molecules(alns, barcodes, max_dist=2000, min_reads=4)
    want = jlr.infer_molecules(alns, barcodes, max_dist=2000, min_reads=4)
    assert molecules(got) == molecules(want) and len(got) >= 15


def test_linked_cut_chimeric_contig():
    a = sim.random_genome(2000, seed=3)
    b = sim.random_genome(2000, seed=4)
    reads = (linked_reads(a, n_molecules=80, seed=5)
             + [(f"b{rid}", seq, bc + "b") for rid, seq, bc in
                linked_reads(b, n_molecules=80, seed=6)])
    alns, barcodes = align_both([("chimera", a + b)], reads)
    mols = tlr.infer_molecules(alns, barcodes, max_dist=2000, min_reads=4)
    got = tlr.cut_contigs([("chimera", a + b)], mols, min_spanning=1,
                          trim_ends=400)
    want = jlr.cut_contigs([("chimera", a + b)], mols, min_spanning=1,
                           trim_ends=400)
    assert got == want and got[1] >= 1


def test_linked_rescaffold(tmp_path):
    genome = sim.random_genome(6000, seed=7)
    contigs = [("c0", genome[:3000]), ("c1", genome[3000:])]
    reads = linked_reads(genome, n_molecules=120, mol_len=1500, seed=8)
    alns, barcodes = align_both(contigs, reads)
    lengths = {n: len(s) for n, s in contigs}
    g_t = tlr.barcode_links(alns, barcodes, lengths, end_len=1500,
                            min_shared=3, min_len=500)
    g_j = jlr.barcode_links(alns, barcodes, lengths, end_len=1500,
                            min_shared=3, min_len=500)
    assert g_t.num_edges() == g_j.num_edges() >= 2
    path = str(tmp_path / "lr.fq")
    with open(path, "w") as f:
        for rid, seq, bc in reads:
            f.write(f"@{rid} BX:Z:{bc}\n{seq}\n+\n{'I' * len(seq)}\n")
    kw = dict(align_k=32, min_shared=3, end_len=1500, min_pairs=3,
              min_len=500)
    got = tlr.rescaffold_linked(contigs, [path], device="cpu", **kw)
    want = jlr.rescaffold_linked(contigs, [path], **kw)
    assert got == want
    assert want[1]["links"] >= 1 and max(len(s) for _, s in want[0]) > 3000
