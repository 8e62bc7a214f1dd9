"""Linked-read (10x Chromium) misassembly correction + scaffolding.

The reference pipeline shells out to external Tigmint and ARCS binaries
for its `lr=` stage (bin/abyss-pe:752-849): map linked reads, group
them into molecule extents per barcode (tigmint-molecule), cut contigs
where molecule coverage drops (tigmint-cut), then link contig ends
sharing barcodes (arcs) and re-run abyss-scaffold.  This module
implements those three stages natively so the lr= flow has no external
dependencies; the algorithms follow the published tool semantics.

Barcodes ride the read name comment as `BX:Z:<barcode>` (the standard
10x tag), extracted by `barcode_of`.

Port of abyss_tpu/scaffold/linked_reads.py (no jax there): a copy whose
only change is the `device` of the KmerAligner that `rescaffold_linked`
builds.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ..graph.contig_graph import ContigGraph, node


def barcode_of(comment: str) -> str | None:
    """Extract the BX:Z: barcode from a read-name comment."""
    for tok in comment.split():
        if tok.startswith("BX:Z:"):
            return tok[5:]
    return None


@dataclass
class Molecule:
    rname: str
    start: int
    end: int
    barcode: str
    num_reads: int


def infer_molecules(alignments, barcodes: dict[str, str],
                    max_dist: int = 50000, min_reads: int = 4,
                    ) -> list[Molecule]:
    """tigmint-molecule: group per-barcode alignments on each contig
    into molecule extents — reads of one barcode belong to the same
    molecule while consecutive positions are <= max_dist apart."""
    by_bc: dict[tuple[str, str], list[int]] = defaultdict(list)
    for a in alignments:
        if a is None:
            continue
        bc = barcodes.get(a.qname) or barcodes.get(a.qname.split("/")[0])
        if bc is None:
            continue
        by_bc[(a.rname, bc)].append(a.pos)
    molecules = []
    for (rname, bc), positions in by_bc.items():
        positions.sort()
        start = positions[0]
        prev = positions[0]
        n = 1
        for p in positions[1:]:
            if p - prev > max_dist:
                if n >= min_reads:
                    molecules.append(Molecule(rname, start, prev, bc, n))
                start = p
                n = 0
            prev = p
            n += 1
        if n >= min_reads:
            molecules.append(Molecule(rname, start, prev, bc, n))
    return molecules


def molecule_coverage(molecules: list[Molecule], lengths: dict[str, int],
                      ) -> dict[str, np.ndarray]:
    """Per-base molecule span depth for each contig (difference array)."""
    cov = {name: np.zeros(length + 1, np.int32)
           for name, length in lengths.items()}
    for m in molecules:
        arr = cov.get(m.rname)
        if arr is None:
            continue
        arr[m.start] += 1
        arr[min(m.end, len(arr) - 1)] -= 1
    return {name: np.cumsum(arr[:-1]).astype(np.int32)
            for name, arr in cov.items()}


def cut_contigs(contigs: list[tuple[str, str]], molecules: list[Molecule],
                min_spanning: int = 2, trim_ends: int = 500,
                ) -> tuple[list[tuple[str, str]], int]:
    """tigmint-cut: split each contig where molecule span depth drops
    below min_spanning (away from the natural low-coverage ends).
    Returns (possibly-split contigs, number of cuts)."""
    lengths = {n: len(s) for n, s in contigs}
    cov = molecule_coverage(molecules, lengths)
    out = []
    n_cuts = 0
    for name, seq in contigs:
        depth = cov[name]
        interior = depth[trim_ends: max(len(seq) - trim_ends, trim_ends)]
        if interior.size == 0 or interior.min() >= min_spanning:
            out.append((name, seq))
            continue
        # cut at the minimum of each low-coverage run
        low = interior < min_spanning
        cuts = []
        i = 0
        while i < len(low):
            if low[i]:
                j = i
                while j < len(low) and low[j]:
                    j += 1
                run = interior[i:j]
                cuts.append(trim_ends + i + int(np.argmin(run)))
                i = j
            else:
                i += 1
        prev = 0
        for idx, c in enumerate(cuts):
            out.append((f"{name}.{idx}", seq[prev:c]))
            prev = c
            n_cuts += 1
        out.append((f"{name}.{len(cuts)}", seq[prev:]))
    return out, n_cuts


def barcode_links(alignments, barcodes: dict[str, str],
                  lengths: dict[str, int], end_len: int = 30000,
                  min_shared: int = 5, min_len: int = 500,
                  ) -> ContigGraph:
    """arcs: count barcodes shared between contig *ends*; emit a
    distance-graph-shaped ContigGraph whose edges carry n = number of
    shared barcodes (feeds abyss-scaffold / scaffold_paths).

    An alignment is assigned to the head (sense 1 side) or tail
    (sense 0 side) of its contig when it falls within end_len of the
    respective end."""
    # barcode -> set of oriented contig ends
    ends_of_bc: dict[str, set] = defaultdict(set)
    for a in alignments:
        if a is None:
            continue
        bc = barcodes.get(a.qname) or barcodes.get(a.qname.split("/")[0])
        if bc is None:
            continue
        length = lengths.get(a.rname)
        if length is None or length < min_len:
            continue
        if a.pos < end_len:
            ends_of_bc[bc].add((a.rname, 1))  # head = the "-" end
        if a.pos > length - end_len:
            ends_of_bc[bc].add((a.rname, 0))  # tail = the "+" end
    pair_count: dict[tuple, int] = defaultdict(int)
    for bc, ends in ends_of_bc.items():
        ends = sorted(ends)
        if len(ends) > 8:   # promiscuous barcode: skip (arcs -m behavior)
            continue
        for i in range(len(ends)):
            for j in range(i + 1, len(ends)):
                (na, sa), (nb, sb) = ends[i], ends[j]
                if na == nb:
                    continue
                pair_count[(na, sa, nb, sb)] += 1
    g = ContigGraph()
    for name, length in lengths.items():
        if length >= min_len:
            g.add_contig(name, length)
    for (na, sa, nb, sb), n in pair_count.items():
        if n < min_shared:
            continue
        # tail(a)+ -> head(b)+ style orientation: the end a read maps to
        # is the end that faces its partner
        u = node(g.id_of(na), 0 if sa == 0 else 1)
        v = node(g.id_of(nb), 0 if sb == 1 else 1)
        prop = {"d": 100, "n": n, "sd": 1.0}
        g.add_edge(u, v, dict(prop))
        from ..graph.contig_graph import flip
        g.add_edge(flip(v), flip(u), dict(prop))
    return g


def rescaffold_linked(contigs: list[tuple[str, str]], read_files,
                      align_k: int = 32, max_dist: int = 50000,
                      min_spanning: int = 2, min_shared: int = 5,
                      end_len: int = 30000, min_pairs: int = 5,
                      min_len: int = 500, batch_size: int = 4096,
                      max_read_len: int = 512, device="cuda"):
    """The full lr= flow: map linked reads -> tigmint molecule cut ->
    re-map -> arcs barcode links -> scaffold, the mapping on `device`.
    Returns (scaffolds, stats dict)."""
    from ..align.mapper import KmerAligner
    from ..io import fastx, read_batches
    from . import paths as pathtools

    def map_all(target):
        al = KmerAligner(target, k=align_k, device=device)
        alns = []
        barcodes = {}
        for batch in read_batches(read_files, batch_size, max_read_len):
            res = al.align_batch(batch.codes,
                                 batch.lengths,
                                 batch.ids)
            alns.extend(res)
            for rid, comment in zip(batch.ids, batch.comments or []):
                bc = barcode_of(comment)
                if bc:
                    barcodes[rid] = bc
            if not getattr(batch, "comments", None):
                # barcode embedded in the read id as id_BX:Z:xxx fallback
                for rid in batch.ids:
                    if "BX:Z:" in rid:
                        barcodes[rid] = rid.split("BX:Z:")[1]
        return alns, barcodes

    alns, barcodes = map_all(contigs)
    molecules = infer_molecules(alns, barcodes, max_dist=max_dist)
    cut, n_cuts = cut_contigs(contigs, molecules,
                              min_spanning=min_spanning)
    alns2, barcodes2 = (alns, barcodes) if n_cuts == 0 else map_all(cut)
    dg = barcode_links(alns2, barcodes2, {n: len(s) for n, s in cut},
                       end_len=end_len, min_shared=min_shared,
                       min_len=min_len)
    chains = pathtools.scaffold_paths(dg, min_pairs, min_len)
    seqs = dict(cut)
    used = set()
    out = []
    next_id = 0
    for p in chains:
        seq = pathtools.materialize_path(p, dg, seqs)
        out.append((f"scaffold{next_id}", seq))
        next_id += 1
        used.update(v >> 1 for v in p)
    for cid in dg.contigs():
        if cid not in used:
            n = dg.names[cid]
            out.append((n, seqs[n]))
    stats = {"molecules": len(molecules), "cuts": n_cuts,
             "links": dg.num_edges() // 2, "scaffolds": len(chains)}
    return out, stats
