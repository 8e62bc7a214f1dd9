"""The control and the faults that `correct` has to catch, planted under
a job by patching the program for the length of a `with` block.  Used by
calibrate.py on the card and by the CPU tests; the benchmark's own runs
never load this module.

- control: the counts held in 8 bits (saturating at 127) instead of 16
  (COVERAGE_MAX 32767), the nearest lower precision of the counters the
  configuration states; repeat k-mers, seen some 300 times at 40x, then
  read 127, which breaks the guarantee that a unitig's coverage is the
  sum of its k-mers' multiplicities;
- unchanged: stage 1 returns its state unchanged, an empty graph, and
  writes no unitig;
- half_batch: half of every read batch is left out;
- altered: one base of the longest unitig is changed where stage 1
  writes it;
- unjoined (pe only): stages 6 and 8 return their input, so the
  scaffolds are stage 3's contigs, every sequence still there, no join
  made;
- unscaffolded (pe only): stage 8 returns its input, so the scaffolds
  are stage 6's contigs.

The fault "the exchange between chips left out" has no place in a
one-chip cell.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import shutil

CONTROL_MAX = 127


@contextlib.contextmanager
def patched(*triples):
    """Set (module name, attribute, value) for the block, then restore."""
    saved = []
    try:
        for modname, attr, value in triples:
            mod = importlib.import_module(modname)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, value)
        yield
    finally:
        for mod, attr, value in reversed(saved):
            setattr(mod, attr, value)


def control():
    return patched(
        ("abyss_tpu_torch.ops.sorted_filter", "COUNTER_MAX", CONTROL_MAX),
        ("abyss_tpu_torch.dbg.hash_dbg", "COVERAGE_MAX", CONTROL_MAX))


def unchanged():
    def stage_unitigs_1(p, devices=None):
        out = p.path("1.fa")
        open(out, "w").close()
        return out
    return patched(("abyss_tpu_torch.pipeline.pe", "stage_unitigs_1",
                    stage_unitigs_1))


def half_batch():
    from abyss_tpu_torch.io import read_batches

    def halved(*args, **kwargs):
        for b in read_batches(*args, **kwargs):
            keep = b.num_reads // 2
            codes = b.codes.copy()
            codes[keep:] = 4
            lengths = b.lengths.copy()
            lengths[keep:] = 0
            yield dataclasses.replace(
                b, codes=codes, lengths=lengths, ids=b.ids[:keep],
                comments=b.comments[:keep] if b.comments else b.comments)
    return patched(
        ("abyss_tpu_torch.pipeline.pe", "io_read_batches", halved),
        ("abyss_tpu_torch.dbg.bloom_dbg", "io_read_batches", halved))


def altered():
    from abyss_tpu_torch.pipeline import pe
    original = pe.stage_unitigs_1

    def stage_unitigs_1(p, devices=None):
        out = original(p, devices)
        with open(out, "rb") as f:
            recs = f.read().split(b">")[1:]
        seqs = [r.partition(b"\n")[2].replace(b"\n", b"") for r in recs]
        if seqs:
            i = max(range(len(seqs)), key=lambda j: len(seqs[j]))
            s = bytearray(seqs[i])
            mid = len(s) // 2
            s[mid] = ord({"A": "C", "C": "G", "G": "T"}.get(chr(s[mid]), "A"))
            head = recs[i].partition(b"\n")[0]
            recs[i] = head + b"\n" + bytes(s) + b"\n"
            with open(out, "wb") as f:
                f.write(b"".join(b">" + r for r in recs))
        return out
    return patched(("abyss_tpu_torch.pipeline.pe", "stage_unitigs_1",
                    stage_unitigs_1))


def _passthrough(src: str, dst: str):
    """A stage that writes its input FASTA out as its output."""
    def stage(p):
        out = p.path(dst)
        shutil.copyfile(p.path(src), out)
        return out
    return stage


def unjoined():
    return patched(
        ("abyss_tpu_torch.pipeline.pe", "stage_contigs_6",
         _passthrough("3.fa", "6.fa")),
        ("abyss_tpu_torch.pipeline.pe", "stage_scaffolds_8",
         _passthrough("6.fa", "8.fa")))


def unscaffolded():
    return patched(("abyss_tpu_torch.pipeline.pe", "stage_scaffolds_8",
                    _passthrough("6.fa", "8.fa")))


PLANTS = {"control": control, "unchanged": unchanged,
          "half_batch": half_batch, "altered": altered,
          "unjoined": unjoined, "unscaffolded": unscaffolded}
# the plants whose stages a target runs
PE_ONLY = ("unjoined", "unscaffolded")


def plants_for(target: str) -> list[str]:
    return [n for n in PLANTS if target == "pe" or n not in PE_ONLY]
