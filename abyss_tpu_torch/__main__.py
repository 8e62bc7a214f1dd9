"""`python -m abyss_tpu_torch <tool>` -- dispatcher over the port's tool
suite (the counterpart of `python -m abyss_tpu`, the same 56 tools),
mirroring the reference's one-binary-per-stage layout.  The tools that
run on a device take `--device cuda|cpu` (`pe`: device=cuda|cpu) and
use the card unless asked for the CPU."""

import sys


TOOLS = {
    "pe": ("abyss-pe pipeline driver", "abyss_tpu_torch.pipeline.pe",
           "main"),
    "bloom-dbg": ("Bloom-filter de Bruijn graph assembler",
                  "abyss_tpu_torch.cli.tools", "bloom_dbg_main"),
    "assemble": ("exact hash-DBG assembler (ABYSS engine)",
                 "abyss_tpu_torch.cli.tools", "assemble_main"),
    "adjlist": ("contig overlap graph builder (AdjList)",
                "abyss_tpu_torch.cli.tools", "adjlist_main"),
    "fac": ("assembly contiguity statistics (abyss-fac)",
            "abyss_tpu_torch.stats.fac", "main"),
    "tofastq": ("format conversion (abyss-tofastq)",
                "abyss_tpu_torch.cli.tools", "tofastq_main"),
    "todot": ("graph format conversion (abyss-todot)",
              "abyss_tpu_torch.cli.tools", "todot_main"),
    "gc": ("graph statistics (abyss-gc)",
           "abyss_tpu_torch.cli.tools", "gc_main"),
    "konnector": ("connect read pairs through the Bloom DBG (konnector)",
                  "abyss_tpu_torch.cli.tools", "konnector_main"),
    "sealer": ("close scaffold gaps (abyss-sealer)",
               "abyss_tpu_torch.cli.tools", "sealer_main"),
    "db-txt": ("export telemetry database as text (abyss-db-txt)",
               "abyss_tpu_torch.cli.tools", "db_txt_main"),
    "db-csv": ("export telemetry database as CSV (abyss-db-csv)",
               "abyss_tpu_torch.cli.tools", "db_csv_main"),
    "bloom": ("Bloom filter utility (abyss-bloom: build/union/"
              "intersect/info/compare/kmers/trim/graph)",
              "abyss_tpu_torch.cli.bloom_tool", "main"),
    "map": ("map reads to contigs, SAM out (abyss-map/KAligner)",
            "abyss_tpu_torch.cli.tools2", "map_main"),
    "index": ("build FM-index + .fai (abyss-index)",
              "abyss_tpu_torch.cli.tools2", "index_main"),
    "count": ("k-mer occurrence counts (abyss-count)",
              "abyss_tpu_torch.cli.tools2", "count_main"),
    "dawg": ("directed acyclic word graph dump (abyss-dawg)",
             "abyss_tpu_torch.cli.tools2", "dawg_main"),
    "overlap": ("suffix-prefix overlap graph (abyss-overlap)",
                "abyss_tpu_torch.cli.tools2", "overlap_main"),
    "layout": ("greedy overlap layout (abyss-layout)",
               "abyss_tpu_torch.cli.tools2", "layout_main"),
    "fixmate": ("pair up alignments, fragment histogram (abyss-fixmate)",
                "abyss_tpu_torch.cli.tools2", "fixmate_main"),
    "distanceest": ("contig-pair distance MLE (DistanceEst)",
                    "abyss_tpu_torch.cli.tools2", "distanceest_main"),
    "filtergraph": ("prune tips/islands (abyss-filtergraph)",
                    "abyss_tpu_torch.cli.tools2", "filtergraph_main"),
    "popbubbles": ("contig-level bubble popping (PopBubbles)",
                   "abyss_tpu_torch.cli.tools2", "popbubbles_main"),
    "overlap-contigs": ("edges from negative distances (Overlap)",
                        "abyss_tpu_torch.cli.tools2", "overlapcontigs_main"),
    "simplegraph": ("constrained path search (SimpleGraph)",
                    "abyss_tpu_torch.cli.tools2", "simplegraph_main"),
    "mergepaths": ("merge consistent paths (MergePaths)",
                   "abyss_tpu_torch.cli.tools2", "mergepaths_main"),
    "pathoverlap": ("merge overlapping paths (PathOverlap)",
                    "abyss_tpu_torch.cli.tools2", "pathoverlap_main"),
    "pathconsensus": ("ambiguous path consensus (PathConsensus)",
                      "abyss_tpu_torch.cli.tools2", "pathconsensus_main"),
    "mergecontigs": ("materialize paths into contigs (MergeContigs)",
                     "abyss_tpu_torch.cli.tools2", "mergecontigs_main"),
    "scaffold": ("scaffold over the distance graph (abyss-scaffold)",
                 "abyss_tpu_torch.cli.tools2", "scaffold_main"),
    "junction": ("junction vertices of a graph (abyss-junction)",
                 "abyss_tpu_torch.cli.tools2", "junction_main"),
    "longseqdist": ("long-read SAM -> distance graph (abyss-longseqdist)",
                    "abyss_tpu_torch.cli.tools2", "longseqdist_main"),
    "rresolver": ("short-read repeat resolution (abyss-rresolver-short)",
                  "abyss_tpu_torch.cli.tools2", "rresolver_main"),
    "consensus": ("pileup base calling (Consensus)",
                  "abyss_tpu_torch.cli.tools2", "consensus_main"),
    "dassembler": ("greedy localized assembly (DAssembler)",
                   "abyss_tpu_torch.cli.tools2", "dassembler_main"),
    "gapfill": ("close scaffold gaps (abyss-gapfill)",
                "abyss_tpu_torch.cli.tools2", "gapfill_main"),
    "mergepairs": ("overlap-merge read pairs (abyss-mergepairs)",
                   "abyss_tpu_torch.cli.tools2", "mergepairs_main"),
    "align": ("global pairwise alignment (abyss-align)",
              "abyss_tpu_torch.cli.tools2", "align_main"),
    "paired-dbg": ("paired de Bruijn graph assembly (abyss-paired-dbg)",
                   "abyss_tpu_torch.cli.tools2", "paireddbg_main"),
    "kmerprint": ("dump the k-mer table as text (kmerprint)",
                  "abyss_tpu_torch.cli.tools2", "kmerprint_main"),
    "logcounter": ("probabilistic PLC k-mer counting (logcounter)",
                   "abyss_tpu_torch.cli.tools2", "logcounter_main"),
    "samtobreak": ("breakpoint metrics vs reference (abyss-samtobreak)",
                   "abyss_tpu_torch.cli.tools2", "samtobreak_main"),
    "fatoagp": ("scaffold FASTA -> AGP + scaftigs (abyss-fatoagp)",
                "abyss_tpu_torch.cli.tools2", "fatoagp_main"),
    "samtoafg": ("SAM -> AMOS AFG (abyss-samtoafg)",
                 "abyss_tpu_torch.cli.tools2", "samtoafg_main"),
    "cstont": ("colour-space -> nucleotide FASTA (abyss-cstont)",
               "abyss_tpu_torch.cli.tools2", "cstont_main"),
    "joindist": ("merge .dist files (abyss-joindist)",
                 "abyss_tpu_torch.cli.tools2", "joindist_main"),
    "adjtodot": (".adj -> .dot (abyss-adjtodot)",
                 "abyss_tpu_torch.cli.tools2", "adjtodot_main"),
    "tabtomd": ("stats table -> markdown (abyss-tabtomd)",
                "abyss_tpu_torch.cli.tools2", "tabtomd_main"),
    "tigmint": ("linked-read molecule cut (tigmint equivalent)",
                "abyss_tpu_torch.cli.tools2", "tigmint_main"),
    "arcs": ("linked-read barcode scaffolding links (arcs equivalent)",
             "abyss_tpu_torch.cli.tools2", "arcs_main"),
    "stack-size": ("run a tool with a raised stack/recursion budget "
                   "(abyss-stack-size)",
                   "abyss_tpu_torch.cli.tools2", "stacksize_main"),
    "bwa": ("bwa wrapper w/ native fallback (abyss-bwa)",
            "abyss_tpu_torch.align.wrappers", "bwa_main"),
    "bwamem": ("bwa-mem wrapper w/ native fallback (abyss-bwamem)",
               "abyss_tpu_torch.align.wrappers", "bwamem_main"),
    "bowtie2": ("bowtie2 wrapper w/ native fallback (abyss-bowtie2)",
                "abyss_tpu_torch.align.wrappers", "bowtie2_main"),
    "kaligner": ("k-mer seed aligner (KAligner/abyss-kaligner)",
                 "abyss_tpu_torch.align.wrappers", "kaligner_main"),
    "dida": ("distributed aligner wrapper (abyss-dida)",
             "abyss_tpu_torch.align.wrappers", "dida_main"),
}


def main():
    from .utils.sysinfo import signal_init
    signal_init()  # SIGSEGV/SIGBUS backtraces (Common/SignalHandler.cpp)
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m abyss_tpu_torch <tool> [args...]\n\ntools:")
        for name, (desc, _, _) in TOOLS.items():
            print(f"  {name:12s} {desc}")
        return 0
    tool = sys.argv[1]
    if tool not in TOOLS:
        print(f"unknown tool: {tool}", file=sys.stderr)
        return 1
    _, module, fn = TOOLS[tool]
    args = sys.argv[2:]

    # universal --db=FILE (the reference puts --db on EVERY binary,
    # DataBase/DB.h:31): the dispatcher strips it and records the
    # invocation, so each tool need not declare it.  Tools with their
    # own richer --db recording keep theirs (flag passed through).
    NATIVE_DB = {"pe", "bloom-dbg", "assemble", "distanceest", "scaffold"}
    db_path = None
    if tool not in NATIVE_DB:
        remaining = []
        i = 0
        while i < len(args):
            a = args[i]
            if a.startswith("--db="):
                db_path = a[5:]
            elif a == "--db" and i + 1 < len(args):
                db_path = args[i + 1]
                i += 1
            else:
                remaining.append(a)
            i += 1
        if db_path:
            args = remaining

    import importlib
    import time as _time
    m = importlib.import_module(module)
    t0 = _time.time()
    ok = False
    try:
        rc = getattr(m, fn)(args)
        ok = True
    finally:
        if db_path:
            from .utils.db import DB
            from .utils.sysinfo import memory_usage_bytes
            with DB(db_path, tool=tool,
                    command=" ".join(sys.argv[1:])) as db:
                db.add("wall_s", round(_time.time() - t0, 3))
                db.add("peak_rss_bytes", memory_usage_bytes())
                db.add("exit", "ok" if ok else "error")
    return rc


if __name__ == "__main__":
    sys.exit(main() or 0)
