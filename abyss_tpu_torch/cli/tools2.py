"""More CLI entry points of the port (mirrors abyss_tpu/cli/tools2.py).

Covers (reference binary -> entry point here):
  abyss-map / KAligner      map_main        (Map/map.cc, KAligner/)
  abyss-index               index_main      (Map/index.cc)
  abyss-count               count_main      (FMIndex/count.cc)
  abyss-dawg                dawg_main       (FMIndex/dawg.cc)
  abyss-overlap             overlap_main    (Map/overlap.cc)
  abyss-layout              layout_main     (Layout/layout.cc)
  abyss-fixmate             fixmate_main    (ParseAligns/abyss-fixmate.cc)
  DistanceEst               distanceest_main(DistanceEst/DistanceEst.cpp)
  abyss-filtergraph         filtergraph_main(FilterGraph/FilterGraph.cc)
  PopBubbles                popbubbles_main (PopBubbles/PopBubbles.cpp)
  Overlap                   overlapcontigs_main (Overlap/Overlap.cpp)
  SimpleGraph               simplegraph_main(SimpleGraph/SimpleGraph.cpp)
  MergePaths                mergepaths_main (MergePaths/MergePaths.cpp)
  PathOverlap               pathoverlap_main(PathOverlap/PathOverlap.cpp)
  PathConsensus             pathconsensus_main (MergePaths/PathConsensus.cpp)
  MergeContigs              mergecontigs_main (MergePaths/MergeContigs.cpp)
  abyss-scaffold            scaffold_main   (Scaffold/scaffold.cc)
  abyss-junction            junction_main   (Scaffold/junction.cc)
  abyss-longseqdist         longseqdist_main(Scaffold/longseqdist.cpp)
  abyss-rresolver-short     rresolver_main  (RResolver/)
  Consensus                 consensus_main  (Consensus/Consensus.cpp)
  DAssembler                dassembler_main (DAssembler/)
  abyss-gapfill             gapfill_main    (GapFiller/gapfill.cpp)
  abyss-mergepairs          mergepairs_main (Align/mergepairs.cc)
  abyss-align               align_main      (Align/align.cc)
  abyss-paired-dbg          paireddbg_main  (PairedDBG/, ABYSS/abyss.cc K=)
  kmerprint                 kmerprint_main  (kmerprint/kmerprint.cc)
  logcounter                logcounter_main (LogKmerCount/logcounter.cc)
  abyss-samtobreak          samtobreak_main (Misc/samtobreak.hs)
  abyss-fatoagp             fatoagp_main    (bin/abyss-fatoagp)
  abyss-samtoafg            samtoafg_main   (bin/abyss-samtoafg)
  abyss-cstont              cstont_main     (colour-space converter)
  abyss-joindist            joindist_main   (bin/abyss-joindist)
  abyss-adjtodot            adjtodot_main   (bin/abyss-adjtodot.pl)
  abyss-tabtomd             tabtomd_main    (bin/abyss-tabtomd)
  tigmint / arcs            tigmint_main, arcs_main (linked reads)
  abyss-stack-size          stacksize_main  (bin/abyss-stack-size)

The tools whose work reaches a device take `--device cuda|cpu` (default
cuda; without a card, cuda raises): map, index, count, distanceest,
pathconsensus, rresolver, consensus, gapfill, paired-dbg, kmerprint,
logcounter, samtobreak, tigmint and arcs.  The rest run on the host.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import resolve_device


def _read_fa(path):
    from ..io import fastx
    return [(r.id, r.seq) for r in fastx.read_fastx(path)]


def _read_graph_any(path):
    from ..graph import graphio
    return graphio.read_graph(path)


def _write_graph_args(g, args, k):
    from ..graph import graphio
    fmt = "dot"
    if getattr(args, "adj", False):
        fmt = "adj"
    elif getattr(args, "gfa2", False):
        fmt = "gfa2"
    out = getattr(args, "out", "-") or "-"
    if out == "-":
        writer = {"dot": graphio.write_dot, "adj": graphio.write_adj,
                  "gfa2": graphio.write_gfa2}[fmt]
        kw = {"k": k} if fmt != "adj" else {}
        writer(g, sys.stdout, **kw)
    else:
        graphio.write_graph(g, out, k=k, fmt=fmt)


def _stream_alignments(p, contigs, read_files, k, batch_size=4096,
                       max_len=512, q=0, device="cuda"):
    from ..align.mapper import KmerAligner
    from ..io import read_batches
    al = KmerAligner(contigs, k=k, device=device)
    for batch in read_batches(read_files, batch_size, max_len, q=q):
        yield from al.align_batch(batch.codes,
                                  batch.lengths,
                                  batch.ids)


def map_main(argv=None):
    """abyss-map: map reads to contigs, SAM to stdout (Map/map.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch map")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("target", help="contig FASTA (last positional arg)")
    ap.add_argument("-l", "--seed-length", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..align import sam
    contigs = _read_fa(args.target)
    sys.stdout.write(sam.header({n: len(s) for n, s in contigs}))
    for a in _stream_alignments(None, contigs, args.reads,
                                args.seed_length, device=args.device):
        if a is not None:
            sys.stdout.write(sam.emit(a))
    return 0


def index_main(argv=None):
    """abyss-index: build an FM-index (.fm as npz) + .fai (Map/index.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch index")
    ap.add_argument("fasta")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    from ..align import fmindex
    from ..core import alphabet
    contigs = _read_fa(args.fasta)
    text = "$".join(s for _, s in contigs)
    fm = fmindex.FMIndex.build(alphabet.encode(text), device=args.device)
    np.savez_compressed(args.fasta + ".fm",
                        bwt=fm.bwt, C=fm.C, occ=fm.occ,
                        sa_sample=fm.sa_sample, sa_rate=fm.sa_rate)
    with open(args.fasta + ".fai", "w") as f:
        off = 0
        for n, s in contigs:
            f.write(f"{n}\t{len(s)}\t{off}\t{len(s)}\t{len(s) + 1}\n")
            off += len(s) + 1
    return 0


def count_main(argv=None):
    """abyss-count: k-mer occurrence counts of a FASTA via the sorted
    k-mer table (FMIndex/count.cc equivalent)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch count")
    ap.add_argument("-k", "--kmer", type=int, required=True)
    ap.add_argument("fasta")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..dbg import hash_dbg
    from ..core import alphabet
    contigs = _read_fa(args.fasta)
    max_len = max((len(s) for _, s in contigs), default=0)
    codes = np.full((len(contigs), max_len), alphabet.BAD, np.uint8)
    for i, (_, s) in enumerate(contigs):
        codes[i, :len(s)] = alphabet.encode(s)
    table = hash_dbg.count_kmers([codes], args.kmer, device=args.device)
    _print_kmer_table(table, args.kmer)
    return 0


def _print_kmer_table(table, k):
    from ..dbg import hash_dbg
    if table.wide:  # k > 32: sequence comes from the text side array
        for row, cnt in zip(table.text, table.counts):
            print(f"{hash_dbg.unpack_text(row, k)}\t{int(cnt)}")
    else:
        for km, cnt in zip(table.kmers, table.counts):
            print(f"{hash_dbg.unpack_kmer(int(km), k)}\t{int(cnt)}")


def dawg_main(argv=None):
    """abyss-dawg: directed acyclic word graph of a sequence set as dot
    (FMIndex/dawg.cc).  Suffix-automaton construction."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch dawg")
    ap.add_argument("fasta")
    args = ap.parse_args(argv)
    text = "".join(s for _, s in _read_fa(args.fasta))
    # suffix automaton (host; dawg is a debugging tool in the reference)
    sa_link = [-1]
    sa_len = [0]
    trans = [{}]
    last = 0
    for ch in text:
        cur = len(sa_len)
        sa_len.append(sa_len[last] + 1)
        sa_link.append(-1)
        trans.append({})
        p = last
        while p != -1 and ch not in trans[p]:
            trans[p][ch] = cur
            p = sa_link[p]
        if p == -1:
            sa_link[cur] = 0
        else:
            q = trans[p][ch]
            if sa_len[p] + 1 == sa_len[q]:
                sa_link[cur] = q
            else:
                clone = len(sa_len)
                sa_len.append(sa_len[p] + 1)
                sa_link.append(sa_link[q])
                trans.append(dict(trans[q]))
                while p != -1 and trans[p].get(ch) == q:
                    trans[p][ch] = clone
                    p = sa_link[p]
                sa_link[q] = clone
                sa_link[cur] = clone
        last = cur
    out = sys.stdout
    out.write("digraph dawg {\n")
    for u, t in enumerate(trans):
        for ch, v in sorted(t.items()):
            out.write(f'{u} -> {v} [label="{ch}"]\n')
    out.write("}\n")
    return 0


def overlap_main(argv=None):
    """abyss-overlap: suffix-prefix overlap graph of a FASTA
    (Map/overlap.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch overlap")
    ap.add_argument("fasta")
    ap.add_argument("-m", "--min-overlap", type=int, default=20)
    ap.add_argument("--adj", action="store_true")
    ap.add_argument("--gfa2", action="store_true")
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..graph.overlap_graph import build_overlap_graph_variable
    contigs = _read_fa(args.fasta)
    g = build_overlap_graph_variable(contigs, args.min_overlap)
    _write_graph_args(g, args, 0)
    return 0


def layout_main(argv=None):
    """abyss-layout: greedy layout of an overlap graph (Layout/layout.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch layout")
    ap.add_argument("fasta")
    ap.add_argument("-m", "--min-overlap", type=int, default=20)
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..graph.overlap_graph import layout
    from ..io import fastx
    contigs = _read_fa(args.fasta)
    merged = layout(contigs, args.min_overlap)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        for name, seq in merged:
            out.write(f">{name} {len(seq)}\n{seq}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def fixmate_main(argv=None):
    """abyss-fixmate: pair alignments from SAM on stdin, write the
    fragment histogram and cross-contig pair SAM
    (ParseAligns/abyss-fixmate.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch fixmate",
                                 add_help=False)
    ap.add_argument("--help", action="help")
    ap.add_argument("-h", "--hist", dest="hist", default=None,
                    help="write fragment-size histogram here")
    ap.add_argument("sam", nargs="?", default="-")
    args = ap.parse_args(argv)
    from ..align import fixmate as fx
    from ..align import sam
    f = sys.stdin if args.sam == "-" else open(args.sam)
    alns = []
    header_lines = []
    for line in f:
        if line.startswith("@"):
            header_lines.append(line)
            continue
        alns.append(sam.parse(line))
    if f is not sys.stdin:
        f.close()
    hist, links = fx.fixmate(alns)
    if args.hist:
        with open(args.hist, "w") as hf:
            hf.write(hist.to_text())
    sys.stdout.writelines(header_lines)
    for lk in links:
        sys.stdout.write(
            f"{lk.u_name}\t{lk.u_sense}\t{lk.p1}\t{lk.a1}\t"
            f"{lk.v_name}\t{lk.v_sense}\t{lk.p2}\t{lk.a2}\n")
    return 0


def distanceest_main(argv=None):
    """DistanceEst: fragment-MLE contig distances from mapped pairs."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch distanceest")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("--target", required=True, help="contig FASTA")
    ap.add_argument("-k", "--kmer", type=int, default=0,
                    help="k for the output dist.dot edge default")
    ap.add_argument("-l", "--seed-length", type=int, default=32)
    ap.add_argument("-n", "--min-pairs", type=int, default=10)
    ap.add_argument("--hist", default=None)
    ap.add_argument("--dot", action="store_true")
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("--db", default=None, help="SQLite telemetry file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..align import distance_est, fixmate as fx
    from ..io import formats
    contigs = _read_fa(args.target)
    alns = list(_stream_alignments(None, contigs, args.reads,
                                   args.seed_length, device=args.device))
    hist, links = fx.fixmate(alns)
    if args.hist:
        with open(args.hist, "w") as hf:
            hf.write(hist.to_text())
    est = distance_est.estimate_distances(
        links, hist, min_pairs=args.min_pairs, min_align=args.seed_length,
        device=args.device)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        if args.dot:
            distance_est.write_dist_dot(
                est, {n: len(s) for n, s in contigs}, out, k=args.kmer)
        else:
            formats.write_dist_text(est, out)
    finally:
        if out is not sys.stdout:
            out.close()
    from ..utils.db import open_db
    with open_db(args.db, "distanceest", argv) as db:
        db.add("alignments", len(alns))
        db.add("estimates", len(est))
    return 0


def filtergraph_main(argv=None):
    """abyss-filtergraph: drop tips/islands/short contigs, keep
    connectivity (FilterGraph/FilterGraph.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch filtergraph")
    ap.add_argument("graph")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("-t", "--tip-len", type=int, default=None)
    ap.add_argument("-i", "--island-len", type=int, default=None)
    ap.add_argument("--adj", action="store_true")
    ap.add_argument("--gfa2", action="store_true")
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..graph import algorithms
    g, k = _read_graph_any(args.graph)
    k = args.kmer or k
    tip = args.tip_len if args.tip_len is not None else 2 * k
    isl = args.island_len if args.island_len is not None else 2 * k
    n_tip = len(algorithms.prune_tips(g, tip))
    n_isl = len(algorithms.remove_islands(g, isl))
    print(f"removed {n_tip} tips, {n_isl} islands", file=sys.stderr)
    _write_graph_args(g, args, k)
    return 0


def popbubbles_main(argv=None):
    """PopBubbles: contig-level bubble popping with identity check."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch popbubbles")
    ap.add_argument("fasta")
    ap.add_argument("graph")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("-p", "--identity", type=float, default=0.9)
    ap.add_argument("-g", "--graph-out", default=None)
    args = ap.parse_args(argv)
    from ..graph import algorithms, graphio
    from ..align import nw
    g, k = _read_graph_any(args.graph)
    k = args.kmer or k
    seqs = dict(_read_fa(args.fasta))
    check = nw.identity_check_factory(seqs, g.names, args.identity)
    popped = algorithms.pop_bubbles(g, identity_check=check)
    for v in popped:
        print(g.name(v))
    if args.graph_out:
        graphio.write_graph(g, args.graph_out, k=k)
    print(f"popped {len(popped)} bubble branches", file=sys.stderr)
    return 0


def overlapcontigs_main(argv=None):
    """Overlap: add edges where blunt contigs overlap, guided by
    negative distance estimates (Overlap/Overlap.cpp)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch overlap-contigs")
    ap.add_argument("fasta")
    ap.add_argument("graph")
    ap.add_argument("dist")
    ap.add_argument("-k", "--kmer", type=int, required=True)
    ap.add_argument("--adj", action="store_true")
    ap.add_argument("--gfa2", action="store_true")
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..align import distance_est
    from ..graph import overlap_tool, graphio
    from ..io import formats
    g, k = _read_graph_any(args.graph)
    k = args.kmer or k
    seqs = dict(_read_fa(args.fasta))
    est = _load_estimates(args.dist, graphio, distance_est, formats)
    n = overlap_tool.add_overlap_edges(g, seqs, est)
    print(f"added {n} overlap edges", file=sys.stderr)
    _write_graph_args(g, args, k)
    return 0


def _load_estimates(path, graphio, distance_est, formats):
    est = {}
    if path.endswith(".dot"):
        dg, _ = graphio.read_dot(path)
        for u in dg.vertices():
            for v, prop in dg.out_edges(u):
                if not prop or "n" not in prop:
                    continue
                est[(dg.names[u >> 1], u & 1, dg.names[v >> 1], v & 1)] = \
                    distance_est.DistanceEstimate(
                        prop.get("d", 0), prop.get("n", 0),
                        float(prop.get("e", prop.get("sd", 0.0))))
    else:
        for key, (d, n, sd) in formats.read_dist_text(path).items():
            est[key] = distance_est.DistanceEstimate(d, n, sd)
    return est


def simplegraph_main(argv=None):
    """SimpleGraph: constrained path search over distance estimates;
    emits per-seed paths, using ambiguous `nN` entries when several
    solutions agree only on a prefix/suffix
    (SimpleGraph.cpp constructAmbiguousPath)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch simplegraph")
    ap.add_argument("graph")
    ap.add_argument("dist")
    ap.add_argument("fasta", nargs="?", default=None)
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..align import distance_est
    from ..graph import graphio
    from ..io import formats
    from ..scaffold import paths as pathtools
    g, k = _read_graph_any(args.graph)
    est = _load_estimates(args.dist, graphio, distance_est, formats)
    names_index = {g.names[c]: c for c in g.contigs()}
    seed_paths = pathtools.simple_graph_seed_paths(
        g, est, names_index, k=args.kmer or k)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        pathtools.write_paths(
            [p for _, p in sorted(seed_paths.items())], g, out,
            [g.name(u) for u in sorted(seed_paths)])
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _read_paths(path, g):
    """Read a .path file (vertex names per line, `name\tv0 v1 ...`,
    ambiguous entries as `<n>N`)."""
    from ..scaffold.paths import read_paths
    _, paths = read_paths(path, g)
    return paths


def mergepaths_main(argv=None):
    """MergePaths: merge consistent per-seed paths; the default is the
    non-greedy path-overlap-graph consensus (MergePaths.cpp
    assemblePathGraph), --greedy selects extendPaths."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch mergepaths")
    ap.add_argument("graph")
    ap.add_argument("paths")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("-s", "--seed-length", type=int, default=0)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--no-greedy", dest="greedy", action="store_false")
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..scaffold import path_algebra as pa
    from ..scaffold import paths as pathtools
    from ..scaffold.paths import read_paths
    g, k = _read_graph_any(args.graph)
    k = args.kmer or k or 1
    names, paths = read_paths(args.paths, g)
    # key by seed contig id (the reference's path file names the seed)
    by_cid = {}
    for name, p in zip(names, paths):
        try:
            cid = g.id_of(name.rstrip("+-"))
        except KeyError:
            cid = p[0] >> 1 if p and not pa.is_amb(p[0]) else None
        if cid is None or (args.seed_length and
                           g.lengths[cid] < args.seed_length):
            continue
        by_cid[cid] = p
    lengths_kmer = [max(1, ln - k + 1) for ln in g.lengths]
    merged = pa.merge_paths(lengths_kmer, by_cid, greedy=args.greedy)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        pathtools.write_paths(merged, g, out, start_id=0)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def pathoverlap_main(argv=None):
    """PathOverlap: --assemble merges overlapping paths; --overlap
    (default) emits the next-stage graph with paths as vertices;
    --trim cuts overlapped ends (PathOverlap/PathOverlap.cpp)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch pathoverlap")
    ap.add_argument("graph")
    ap.add_argument("paths")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("--assemble", dest="mode", action="store_const",
                    const="assemble", default="overlap")
    ap.add_argument("--overlap", dest="mode", action="store_const",
                    const="overlap")
    ap.add_argument("--trim", dest="mode", action="store_const",
                    const="trim")
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..graph import graphio
    from ..scaffold import path_overlap
    from ..scaffold import paths as pathtools
    from ..scaffold.paths import read_paths
    g, k = _read_graph_any(args.graph)
    names, paths = read_paths(args.paths, g)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        if args.mode == "assemble":
            merged = path_overlap.assemble_overlapping_paths(paths)
            pathtools.write_paths(merged, g, out, start_id=0)
        elif args.mode == "trim":
            trimmed = path_overlap.trim_overlaps(paths)
            pathtools.write_paths(trimmed, g, out, start_id=0)
        else:
            g2 = path_overlap.path_graph(g, paths, names)
            graphio.write_dot(g2, out, k=args.kmer or k)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def pathconsensus_main(argv=None):
    """PathConsensus: resolve ambiguous `nN` path segments through
    graph search + NW/MSA consensus, emitting new consensus contigs
    (MergePaths/PathConsensus.cpp)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch pathconsensus")
    ap.add_argument("fasta")
    ap.add_argument("graph")
    ap.add_argument("paths")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("-p", "--identity", type=float, default=0.9)
    ap.add_argument("-a", "--branches", type=int, default=4)
    ap.add_argument("-o", "--out", required=True,
                    help="output paths file")
    ap.add_argument("-s", "--consensus", required=True,
                    help="output consensus FASTA")
    ap.add_argument("-g", "--graph-out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..graph import graphio
    from ..scaffold import path_consensus
    from ..scaffold import paths as pathtools
    from ..scaffold.paths import read_paths
    g, k = _read_graph_any(args.graph)
    k = args.kmer or k
    seqs = dict(_read_fa(args.fasta))
    names, paths = read_paths(args.paths, g)
    res = path_consensus.resolve_paths(
        g, seqs, paths, k, identity=args.identity,
        num_branches=args.branches, device=args.device)
    with open(args.consensus, "w") as f:
        for n, s, c in res.new_contigs:
            f.write(f">{n} {len(s)} {c}\n{s}\n")
    pathtools.write_paths(res.paths, g, args.out,
                          names if len(names) == len(res.paths)
                          else 0)
    if args.graph_out:
        graphio.write_dot(g, args.graph_out, k=k)
    st = res.stats
    print(f"Ambiguous paths: {st.num_amb}\nMerged:          {st.merged}"
          f"\nNo paths:        {st.no_paths}"
          f"\nToo many paths:  {st.too_many}"
          f"\nToo complex:     {st.too_complex}"
          f"\nDissimilar:      {st.dissimilar}", file=sys.stderr)
    return 0


def mergecontigs_main(argv=None):
    """MergeContigs: materialize paths into contig sequences."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch mergecontigs")
    ap.add_argument("fasta")
    ap.add_argument("graph")
    ap.add_argument("paths", nargs="?", default=None)
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..scaffold import paths as pathtools
    g, _ = _read_graph_any(args.graph)
    seqs = dict(_read_fa(args.fasta))
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    used = set()
    try:
        next_id = 0
        if args.paths:
            for p in _read_paths(args.paths, g):
                seq = pathtools.materialize_path(p, g, seqs)
                out.write(f">{next_id} {len(seq)}\n{seq}\n")
                next_id += 1
                used.update(v >> 1 for v in p)
        for cid in g.contigs():
            if cid not in used:
                n = g.names[cid]
                if n in seqs:
                    out.write(f">{n} {len(seqs[n])}\n{seqs[n]}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def scaffold_main(argv=None):
    """abyss-scaffold: clean the distance graph (cycles, forks, tips,
    repeats, transitive, bubbles, weak edges) and assemble scaffold
    paths, grid/line-searching (n, s) to maximize N50
    (Scaffold/scaffold.cc:220-795,1138-1166)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch scaffold")
    ap.add_argument("dist", help="distance graph (.dist.dot)")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("-n", "--min-pairs", default="10",
                    help="N or Nmin-Nmax search range")
    ap.add_argument("-s", "--min-len", default="200",
                    help="S or Smin-Smax search range")
    ap.add_argument("--search", choices=["grid", "line"],
                    default="grid")
    ap.add_argument("-g", "--graph-out", default=None)
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("--db", default=None, help="SQLite telemetry file")
    args = ap.parse_args(argv)
    from ..graph import graphio
    from ..scaffold import paths as pathtools
    from ..scaffold import scaffolder

    def parse_range(text):
        if "-" in text:
            lo, hi = text.split("-", 1)
            return (int(lo), int(hi))
        return (int(text), int(text))

    dg, k = graphio.read_dot(args.dist)
    result = scaffolder.search_scaffold_params(
        dg, parse_range(args.min_pairs), parse_range(args.min_len),
        k=args.kmer or k, strategy=args.search, verbose=1)
    print(f"best n={result.n} s={result.s} N50={result.n50}",
          file=sys.stderr)
    from ..utils.db import open_db
    with open_db(args.db, "scaffold", argv) as db:
        db.add("n", result.n)
        db.add("s", result.s)
        db.add("N50", result.n50)
        db.add("scaffolds", len(result.paths))
    if args.graph_out:
        graphio.write_dot(result.graph, args.graph_out,
                          k=args.kmer or k)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        pathtools.write_paths(result.paths, dg, out, start_id=0)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def junction_main(argv=None):
    """abyss-junction: emit the junction vertices of a unitig graph
    (Scaffold/junction.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch junction")
    ap.add_argument("graph")
    args = ap.parse_args(argv)
    g, _ = _read_graph_any(args.graph)
    for u in g.vertices():
        if len(g.successors(u)) > 1:
            print(g.name(u))
    return 0


def longseqdist_main(argv=None):
    """abyss-longseqdist: SAM of long-read alignments -> distance graph
    (Scaffold/longseqdist.cpp)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch longseqdist")
    ap.add_argument("sam", nargs="?", default="-")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    ap.add_argument("-o", "--out", default="-")
    args = ap.parse_args(argv)
    from ..align import sam as sammod, distance_est
    f = sys.stdin if args.sam == "-" else open(args.sam)
    by_read: dict[str, list] = {}
    lengths: dict[str, int] = {}
    for line in f:
        if line.startswith("@"):
            if line.startswith("@SQ"):
                tags = dict(t.split(":", 1) for t in
                            line.rstrip().split("\t")[1:])
                lengths[tags["SN"]] = int(tags["LN"])
            continue
        a = sammod.parse(line)
        if a is not None:
            by_read.setdefault(a.qname, []).append(a)
    if f is not sys.stdin:
        f.close()
    # pairs of contigs linked by the same long read -> distance estimate
    est = {}
    for qname, alns in by_read.items():
        alns.sort(key=lambda a: a.qstart)
        for a, b in zip(alns, alns[1:]):
            if a.rname == b.rname:
                continue
            gap = b.qstart - a.qend
            d = gap - (lengths.get(a.rname, a.rlen) - a.target_end) - b.pos
            key = (a.rname, int(a.rev), b.rname, int(b.rev))
            cur = est.get(key)
            if cur is None:
                est[key] = distance_est.DistanceEstimate(d, 1, 1.0)
            else:
                n = cur.num_pairs + 1
                est[key] = distance_est.DistanceEstimate(
                    int((cur.distance * cur.num_pairs + d) / n), n,
                    cur.std_dev)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        distance_est.write_dist_dot(est, lengths, out, k=args.kmer)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def rresolver_main(argv=None):
    """abyss-rresolver-short: cut repeat junction paths unsupported by
    read-length r-mers (RResolver/)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch rresolver")
    ap.add_argument("fasta")
    ap.add_argument("graph")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-k", "--kmer", type=int, required=True)
    ap.add_argument("-t", "--threshold", type=int, default=4)
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("--adj", action="store_true")
    ap.add_argument("--gfa2", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..graph import rresolver
    from ..io import read_batches
    g, k = _read_graph_any(args.graph)
    k = args.kmer or k
    seqs = dict(_read_fa(args.fasta))
    first = next(read_batches(args.reads, 256, 512), None)
    if first is None or not first.num_reads:
        _write_graph_args(g, args, k)
        return 0
    r = int(np.median(first.lengths[:first.num_reads]))
    r = max(k + 10, min(r, first.codes.shape[1]))
    rmer = rresolver.build_rmer_filter(
        (b.codes for b in read_batches(args.reads, 4096, 512)),
        r=r, size=1 << 22, device=args.device)
    stats = rresolver.resolve_repeats(g, seqs, rmer, k,
                                      support_threshold=args.threshold)
    print(f"cut {stats.edges_cut} edges at {stats.junctions} junctions "
          f"(r={r})", file=sys.stderr)
    _write_graph_args(g, args, k)
    return 0


def consensus_main(argv=None):
    """Consensus: pileup base calling from read alignments
    (Consensus/Consensus.cpp)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch consensus")
    ap.add_argument("fasta")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-l", "--seed-length", type=int, default=32)
    ap.add_argument("--min-cov", type=int, default=1)
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..align.consensus import Pileup
    from ..io import read_batches
    from ..core import alphabet
    from ..align.mapper import KmerAligner
    contigs = _read_fa(args.fasta)
    pile = Pileup(contigs)
    al = KmerAligner(contigs, k=args.seed_length, device=args.device)
    for batch in read_batches(args.reads, 4096, 512):
        alns = al.align_batch(batch.codes,
                              batch.lengths, batch.ids)
        for i, a in enumerate(alns):
            if a is None:
                continue
            codes = batch.codes[i][:batch.lengths[i]]
            pile.add(a, alphabet.decode(codes))
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        for name, seq in pile.call(min_cov=args.min_cov):
            out.write(f">{name}\n{seq}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def dassembler_main(argv=None):
    """DAssembler: greedy localized assembly from a seed."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch dassembler")
    ap.add_argument("seed", help="seed sequence or FASTA path")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-m", "--min-overlap", type=int, default=30)
    args = ap.parse_args(argv)
    from ..dbg.dassembler import assemble_region
    from ..io import fastx
    import os
    if os.path.exists(args.seed):
        seed = next(iter(fastx.read_fastx(args.seed))).seq
    else:
        seed = args.seed
    reads = [r.seq for path in args.reads for r in fastx.read_fastx(path)]
    result = assemble_region(seed, reads, min_overlap=args.min_overlap)
    print(f">dassembled {len(result)}\n{result}")
    return 0


def gapfill_main(argv=None):
    """abyss-gapfill: close scaffold gaps with spanning reads
    (GapFiller/gapfill.cpp; here via the sealer engine)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch gapfill")
    ap.add_argument("scaffolds")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-k", "--kmer", type=int, action="append",
                    required=True)
    ap.add_argument("-b", "--bloom-size", default="64M")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..gap import sealer
    from ..io import fastx
    from .tools import parse_size
    scaffolds = _read_fa(args.scaffolds)
    sealed, stats = sealer.seal(
        scaffolds, args.reads, ks=args.kmer,
        bloom_bytes=parse_size(args.bloom_size), device=args.device)
    fastx.write_fasta(args.out, sealed)
    print(f"closed {stats.closed} of {stats.gaps} gaps", file=sys.stderr)
    return 0


def mergepairs_main(argv=None):
    """abyss-mergepairs: overlap-merge read pairs (Align/mergepairs.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch mergepairs")
    ap.add_argument("reads1")
    ap.add_argument("reads2")
    ap.add_argument("-m", "--min-overlap", type=int, default=10)
    ap.add_argument("-o", "--output-prefix", default="merged")
    args = ap.parse_args(argv)
    from ..align.mergepairs import merge_pairs
    from ..io import fastx
    r1 = list(fastx.read_fastx(args.reads1))
    r2 = list(fastx.read_fastx(args.reads2))
    pairs = [(a.seq, a.qual, b.seq, b.qual) for a, b in zip(r1, r2)]
    merged, stats = merge_pairs(pairs, min_overlap=args.min_overlap)
    with open(args.output_prefix + "_merged.fastq", "w") as f:
        for i, m in enumerate(merged):
            if m is None:
                continue
            seq, qual = (m if isinstance(m, tuple) else (m, None))
            f.write(f"@{r1[i].id}\n{seq}\n+\n{qual or 'I' * len(seq)}\n")
    print(f"merged {stats.merged} of {stats.pairs} pairs",
          file=sys.stderr)
    return 0


def align_main(argv=None):
    """abyss-align: global alignment of each pair of sequences in a
    FASTA (Align/align.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch align")
    ap.add_argument("fasta")
    args = ap.parse_args(argv)
    from ..align.dialign import nw_traceback, GAP
    from ..core import alphabet
    recs = _read_fa(args.fasta)
    for i in range(0, len(recs) - 1, 2):
        (na, sa), (nb, sb) = recs[i], recs[i + 1]
        ra, rb = nw_traceback(alphabet.encode(sa), alphabet.encode(sb))
        ta = "".join("-" if c == GAP else "ACGTN"[min(c, 4)] for c in ra)
        tb = "".join("-" if c == GAP else "ACGTN"[min(c, 4)] for c in rb)
        print(f">{na} vs {nb}\n{ta}\n{tb}")
    return 0


def paireddbg_main(argv=None):
    """abyss-paired-dbg: assemble with KmerPair vertices (PairedDBG/), on
    the GPU by default (--device cuda|cpu)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch paired-dbg")
    ap.add_argument("reads", nargs="+")
    # reference flag convention (bin/abyss-pe:556-564, abyss-paired-dbg):
    # -k is the SPAN of the k-mer pair, -K the SINGLE k-mer size
    ap.add_argument("-k", "--span", type=int, required=True,
                    help="k-mer pair span (reference -k)")
    ap.add_argument("-K", "--single", type=int, required=True,
                    help="single k-mer size (reference -K)")
    ap.add_argument("--kc", type=int, default=2)
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    if args.span < 2 * args.single:
        ap.error(f"k-mer pair span -k{args.span} must be >= twice the "
                 f"single k-mer size -K{args.single}")
    resolve_device(args.device)
    from ..dbg import paired_dbg
    from ..io import read_batches
    batches = [b.codes[:b.num_reads]
               for b in read_batches(args.reads, 4096, 512)]
    contigs = paired_dbg.assemble_pairs(batches, args.single, args.span,
                                        kc=args.kc, device=args.device)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        for i, (seq, _) in enumerate(contigs):
            out.write(f">{i} {len(seq)}\n{seq}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def kmerprint_main(argv=None):
    """kmerprint: dump the k-mer table of a read set as text."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch kmerprint")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-k", "--kmer", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..dbg import hash_dbg
    from ..io import read_batches
    batches = [b.codes[:b.num_reads]
               for b in read_batches(args.reads, 4096, 512)]
    table = hash_dbg.count_kmers(batches, args.kmer, device=args.device)
    _print_kmer_table(table, args.kmer)
    return 0


def logcounter(reads, k: int, size: int, device="cuda"):
    """Insert every valid k-mer of the reads into a PLC array of `size`
    cells on `device`, the cell of a k-mer being its canonical ntHash
    mod size.  Returns (the PLCArray, the k-mers inserted)."""
    import torch
    from .. import u64
    from ..io import read_batches
    from ..ops import nthash
    from ..ops.plc import PLCArray
    dev = resolve_device(device)
    plc = PLCArray(size, device=dev)
    n = 0
    for batch in read_batches(reads, 4096, 512):
        canon, valid = nthash.canonical_hashes(
            torch.from_numpy(batch.codes).to(dev), k)
        idx = u64.umod(canon.reshape(-1), size)[valid.reshape(-1)]
        plc.insert(idx)
        n += idx.shape[0]
    return plc, n


def logcounter_main(argv=None):
    """logcounter: probabilistic (PLC minifloat) k-mer counting
    (LogKmerCount/logcounter.cc)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch logcounter")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-k", "--kmer", type=int, required=True)
    ap.add_argument("-b", "--size", type=int, default=1 << 20)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    _, n = logcounter(args.reads, args.kmer, args.size, args.device)
    print(f"inserted {n} k-mers into a {args.size}-cell PLC array",
          file=sys.stderr)
    return 0


def samtobreak_main(argv=None):
    """abyss-samtobreak: contig breakpoint metrics.  With --sam the
    input is an external SAM of contig alignments (the Haskell tool's
    contract, Misc/samtobreak.hs); otherwise contigs are aligned here
    against the reference FASTA."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch samtobreak")
    ap.add_argument("genome", nargs="?", default=None,
                    help="reference FASTA (internal-alignment mode)")
    ap.add_argument("contigs", nargs="?", default=None)
    ap.add_argument("--sam", default=None,
                    help="external SAM of contig alignments")
    ap.add_argument("-l", "--seed-length", type=int, default=32)
    ap.add_argument("--min-align", type=int, default=100)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the internal alignment [cuda]")
    args = ap.parse_args(argv)
    if args.sam:
        from ..stats.samtobreak import sam_breakpoints
        stats = sam_breakpoints(args.sam, min_align=args.min_align)
    else:
        if not (args.genome and args.contigs):
            ap.error("need GENOME CONTIGS or --sam FILE")
        from ..stats.samtobreak import contig_breakpoints
        genome = _read_fa(args.genome)
        stats = contig_breakpoints(genome, _read_fa(args.contigs),
                                   k=args.seed_length, device=args.device)
    print(stats)
    return 0


def fatoagp_main(argv=None):
    """abyss-fatoagp: scaffold FASTA -> AGP 2.0 + scaftigs."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch fatoagp")
    ap.add_argument("fasta")
    ap.add_argument("-f", "--scaftigs-out", default=None)
    ap.add_argument("-s", "--min-contig", type=int, default=50)
    args = ap.parse_args(argv)
    from ..io.formats import fa_to_agp
    scaffolds = _read_fa(args.fasta)
    agp, scaftigs = fa_to_agp(scaffolds, min_contig=args.min_contig)
    for line in agp:
        print(line)
    if args.scaftigs_out:
        from ..io import fastx
        fastx.write_fasta(args.scaftigs_out, scaftigs)
    return 0


def samtoafg_main(argv=None):
    """abyss-samtoafg: SAM -> AMOS AFG message stream."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch samtoafg")
    ap.add_argument("sam", nargs="?", default="-")
    ap.add_argument("-e", "--eid", default="1")
    ap.add_argument("-i", "--iid", default="1")
    ap.add_argument("-m", "--mean", type=int, default=None)
    ap.add_argument("-s", "--sd", type=int, default=None)
    args = ap.parse_args(argv)
    from ..io.formats import sam_to_afg
    f = sys.stdin if args.sam == "-" else open(args.sam)
    try:
        sam_to_afg(f, sys.stdout, eid=args.eid, iid=args.iid,
                   mean=args.mean, sd=args.sd)
    finally:
        if f is not sys.stdin:
            f.close()
    return 0


def cstont_main(argv=None):
    """abyss-cstont: colour-space FASTA/FASTQ -> nucleotide space."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch cstont")
    ap.add_argument("files", nargs="*", default=["-"])
    args = ap.parse_args(argv)
    from ..core import alphabet
    from ..io import fastx
    for path in args.files or ["-"]:
        for rec in fastx.read_fastx(path):
            seq = rec.seq
            if alphabet.is_colour_space(seq):
                nt = alphabet.colour_to_nucleotide(seq[0], seq[1:])
            else:
                nt = seq
            sys.stdout.write(f">{rec.id}\n{nt}\n")
    return 0


def joindist_main(argv=None):
    """abyss-joindist: merge .dist files keeping min-stddev estimates."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch joindist")
    ap.add_argument("dists", nargs="+")
    args = ap.parse_args(argv)
    from ..io.formats import join_dist
    join_dist(args.dists, sys.stdout)
    return 0


def adjtodot_main(argv=None):
    """abyss-adjtodot: .adj -> .dot (bin/abyss-adjtodot.pl)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch adjtodot")
    ap.add_argument("adj")
    ap.add_argument("-k", "--kmer", type=int, default=0)
    args = ap.parse_args(argv)
    from ..graph import graphio
    g = graphio.read_adj(args.adj)
    graphio.write_dot(g, sys.stdout, k=args.kmer)
    return 0


def tigmint_main(argv=None):
    """tigmint-equivalent: infer linked-read molecule extents and cut
    contigs at low molecule coverage (bin/abyss-pe:752-805's external
    tigmint-molecule + tigmint-cut, implemented natively)."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch tigmint")
    ap.add_argument("contigs")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-l", "--seed-length", type=int, default=32)
    ap.add_argument("-d", "--max-dist", type=int, default=50000)
    ap.add_argument("-s", "--min-spanning", type=int, default=2)
    ap.add_argument("--bed", default=None, help="write molecule BED here")
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..scaffold import linked_reads as lr
    from ..align.mapper import KmerAligner
    from ..io import fastx, read_batches
    contigs = _read_fa(args.contigs)
    al = KmerAligner(contigs, k=args.seed_length, device=args.device)
    alns, barcodes = [], {}
    for batch in read_batches(args.reads, 4096, 512):
        alns.extend(al.align_batch(batch.codes,
                                   batch.lengths,
                                   batch.ids))
        for rid, c in zip(batch.ids, batch.comments or []):
            bc = lr.barcode_of(c)
            if bc:
                barcodes[rid] = bc
    molecules = lr.infer_molecules(alns, barcodes, max_dist=args.max_dist)
    if args.bed:
        with open(args.bed, "w") as f:
            for m in molecules:
                f.write(f"{m.rname}\t{m.start}\t{m.end}\t{m.barcode}\t"
                        f"{m.num_reads}\n")
    cut, n_cuts = lr.cut_contigs(contigs, molecules,
                                 min_spanning=args.min_spanning)
    fastx.write_fasta(args.out, cut)
    print(f"{len(molecules)} molecules, {n_cuts} cuts", file=sys.stderr)
    return 0


def arcs_main(argv=None):
    """arcs-equivalent: barcode-sharing links between contig ends,
    emitted as a distance graph for abyss-scaffold."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch arcs")
    ap.add_argument("contigs")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-l", "--seed-length", type=int, default=32)
    ap.add_argument("-e", "--end-len", type=int, default=30000)
    ap.add_argument("-n", "--min-shared", type=int, default=5)
    ap.add_argument("-s", "--min-len", type=int, default=500)
    ap.add_argument("-o", "--out", default="-")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on [cuda]")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    from ..scaffold import linked_reads as lr
    from ..align.mapper import KmerAligner
    from ..graph import graphio
    from ..io import read_batches
    contigs = _read_fa(args.contigs)
    al = KmerAligner(contigs, k=args.seed_length, device=args.device)
    alns, barcodes = [], {}
    for batch in read_batches(args.reads, 4096, 512):
        alns.extend(al.align_batch(batch.codes,
                                   batch.lengths,
                                   batch.ids))
        for rid, c in zip(batch.ids, batch.comments or []):
            bc = lr.barcode_of(c)
            if bc:
                barcodes[rid] = bc
    g = lr.barcode_links(alns, barcodes, {n: len(s) for n, s in contigs},
                         end_len=args.end_len, min_shared=args.min_shared,
                         min_len=args.min_len)
    out = sys.stdout if args.out == "-" else args.out
    if out is sys.stdout:
        graphio.write_dot(g, sys.stdout)
    else:
        graphio.write_dot(g, out)
    print(f"{g.num_edges() // 2} barcode link edges", file=sys.stderr)
    return 0


def tabtomd_main(argv=None):
    """abyss-tabtomd: stats .tab -> markdown table."""
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch tabtomd")
    ap.add_argument("tab", nargs="?", default="-")
    args = ap.parse_args(argv)
    f = sys.stdin if args.tab == "-" else open(args.tab)
    rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    if f is not sys.stdin:
        f.close()
    if not rows:
        return 0
    widths = [max(len(r[i]) if i < len(r) else 0 for r in rows)
              for i in range(len(rows[0]))]
    def fmt(r):
        return "| " + " | ".join(
            (r[i] if i < len(r) else "").ljust(widths[i])
            for i in range(len(widths))) + " |"
    print(fmt(rows[0]))
    print("|" + "|".join("-" * (w + 2) for w in widths) + "|")
    for r in rows[1:]:
        print(fmt(r))
    return 0


def stacksize_main(argv=None):
    """abyss-stack-size equivalent (bin/abyss-stack-size): run a tool
    with a raised stack/recursion budget.  The reference raises the C
    stack ulimit for deeply recursive tools (SimpleGraph,
    PathConsensus); the Python analogue raises the interpreter
    recursion limit and the OS stack rlimit, then dispatches."""
    import argparse
    import sys
    p = argparse.ArgumentParser(
        prog="stack-size",
        description="run TOOL with a raised stack/recursion budget")
    p.add_argument("size", help="stack size in bytes (e.g. 65536000)")
    p.add_argument("tool", help="abyss_tpu tool name to dispatch")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    nbytes = int(a.size)
    try:
        import resource
        soft, hard = resource.getrlimit(resource.RLIMIT_STACK)
        want = nbytes if hard == resource.RLIM_INFINITY else min(nbytes, hard)
        if soft != resource.RLIM_INFINITY and want > soft:
            resource.setrlimit(resource.RLIMIT_STACK, (want, hard))
    except (ImportError, ValueError, OSError):
        pass  # best-effort, like the reference's ulimit shim
    # ~1 recursion frame per KiB of C stack is the usual rule of thumb
    sys.setrecursionlimit(max(sys.getrecursionlimit(), nbytes // 1024))
    from .. import __main__ as dispatcher
    old = sys.argv
    sys.argv = [old[0], a.tool] + list(a.args)
    try:
        return dispatcher.main()
    finally:
        sys.argv = old
