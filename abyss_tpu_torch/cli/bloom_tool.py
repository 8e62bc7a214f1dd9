"""`abyss-bloom` equivalent: Bloom filter build/query utility.

Port of abyss_tpu/cli/bloom_tool.py (reference Bloom/bloom.cc:
subcommands build/union/intersect/info/compare/graph/kmers/trim, and
the windowed shard build of bin/abyss-bloom-dist.mk: `build -w i/N`
sets only the bits in window i of N; `union` merges the shards).  The
same flags, files (.npz in the JAX package's layout) and output, on the
GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import resolve_device
from ..core import alphabet
from ..io import fastx, read_batches
from ..ops import bloom as bloom_ops
from ..ops import nthash
from .tools import parse_size


def _batches(paths, k, device, batch_size=4096, max_len=512):
    for batch in read_batches(paths, batch_size, max_len):
        yield nthash.canonical_hashes(
            torch.from_numpy(batch.codes).to(device), k)


def build_main(args) -> int:
    dev = resolve_device(args.device)
    size_bytes = parse_size(args.bloom_size)
    size = 1 << (max(size_bytes, 2).bit_length() - 1)
    window = None
    if args.window:
        i, n = args.window.split("/")
        i, n = int(i), int(n)
        if not 1 <= i <= n:
            raise SystemExit(f"bad window {args.window}")
        w = size // n
        window = ((i - 1) * w, size if i == n else i * w)
    if args.type == "counting":
        f = bloom_ops.CountingBloomFilter.create(
            size, args.kmer, args.num_hashes, threshold=max(args.levels, 2),
            device=dev)
    elif args.type == "cascading" or args.levels >= 2:
        # reference `-l N` builds an N-level cascade
        # (Bloom/CascadingBloomFilter.h via Bloom/bloom.cc --levels)
        num_hashes = args.num_hashes
        if window is not None and num_hashes != 1:
            # windowed cascades are single-index (see insert_window)
            print("note: windowed cascading build forces -H 1 "
                  "(single-index cascade, CascadingBloomFilter.h)",
                  file=sys.stderr)
            num_hashes = 1
        f = bloom_ops.CascadingBloomFilter.create(
            size, args.kmer, num_hashes, depth=max(args.levels, 2),
            device=dev)
    else:
        f = bloom_ops.BitBloomFilter.create(size, args.kmer, args.num_hashes,
                                            device=dev)
    counting = isinstance(f, bloom_ops.CountingBloomFilter)
    for canon, valid in _batches(args.files, args.kmer, dev):
        if window is not None and not counting:
            f.insert_window(canon, window[0], window[1], valid)
        else:
            f.insert(canon, valid)
    if window is not None and counting:
        # zero the counters outside the window (windowed counting shard)
        f.counters[:window[0]] = 0
        f.counters[window[1]:] = 0
    bloom_ops.save_filter(args.out, f)
    return 0


def union_main(args) -> int:
    f = bloom_ops.load_filter(args.inputs[0], args.device)
    for path in args.inputs[1:]:
        f = bloom_ops.union(f, bloom_ops.load_filter(path, args.device))
    bloom_ops.save_filter(args.out, f)
    return 0


def intersect_main(args) -> int:
    f = bloom_ops.load_filter(args.inputs[0], args.device)
    for path in args.inputs[1:]:
        f = bloom_ops.intersect(f, bloom_ops.load_filter(path, args.device))
    bloom_ops.save_filter(args.out, f)
    return 0


def _fraction(mask: torch.Tensor) -> float:
    """Share of True entries (the numpy mean of a bool array)."""
    return int(mask.sum()) / mask.numel()


def info_main(args) -> int:
    f = bloom_ops.load_filter(args.file, args.device)
    if isinstance(f, bloom_ops.CountingBloomFilter):
        arr = f.counters[:-1]
        set_frac = _fraction(arr > 0)
        solid = _fraction(arr >= f.threshold)
        print(f"counting bloom filter: size={f.size} counters, "
              f"k={f.k}, hashes={f.num_hashes}, threshold={f.threshold}")
        print(f"occupancy: {set_frac:.4f} nonzero, {solid:.4f} >= threshold")
    elif isinstance(f, bloom_ops.CascadingBloomFilter):
        arr = f.levels[:, :-1]
        set_frac = _fraction(arr[-1] > 0)
        print(f"cascading bloom filter: size={f.size} bits x "
              f"{f.depth} levels, k={f.k}, hashes={f.num_hashes}")
        for i in range(f.depth):
            print(f"level {i + 1} occupancy: {_fraction(arr[i] > 0):.4f}")
    else:
        set_frac = _fraction(f.bits[:-1] > 0)
        print(f"bloom filter: size={f.size} bits, k={f.k}, "
              f"hashes={f.num_hashes}")
        print(f"occupancy: {set_frac:.4f}")
    # FPR = occupancy^H (BloomFilter.hpp FPR formula)
    print(f"FPR: {set_frac ** f.num_hashes * 100:.3f}%")
    return 0


def _occupied(f) -> torch.Tensor:
    if isinstance(f, bloom_ops.CountingBloomFilter):
        return f.counters[:-1] > 0
    if isinstance(f, bloom_ops.CascadingBloomFilter):
        return f.levels[0, :-1] > 0
    return f.bits[:-1] > 0


def compare_main(args) -> int:
    xa = _occupied(bloom_ops.load_filter(args.inputs[0], args.device))
    xb = _occupied(bloom_ops.load_filter(args.inputs[1], args.device))
    inter = int((xa & xb).sum())
    un = int((xa | xb).sum())
    if args.method == "jaccard":
        print(f"jaccard: {inter / un if un else 1.0:.6f}")
    elif args.method == "czekanowski":
        s = int(xa.sum()) + int(xb.sum())
        print(f"czekanowski: {2 * inter / s if s else 1.0:.6f}")
    else:
        print(f"forbes-like: a={int(xa.sum())} b={int(xb.sum())} "
              f"intersect={inter} union={un}")
    return 0


def _query_hits(f, query: str):
    """(record, sequence, hit, valid) of each query record at least k
    long: for each of its k-windows (numpy bool arrays), the filter's
    answer (False where the window holds an N) and whether it holds no
    N."""
    k = f.k
    for rec in fastx.read_fastx(query):
        seq = rec.seq.upper()
        if len(seq) < k:
            continue
        _, _, canon, valid = nthash.kmer_hashes_padded(alphabet.encode(seq),
                                                       k, f.device)
        yield (rec, seq, f.contains(canon, valid).cpu().numpy(),
               valid.cpu().numpy())


def kmers_main(args) -> int:
    """Print/report the k-mers of the query file present in the filter."""
    f = bloom_ops.load_filter(args.file, args.device)
    k = f.k
    n_hit = n_tot = 0
    for rec, seq, hit, valid in _query_hits(f, args.query):
        for i in range(len(seq) - k + 1):
            if not valid[i]:
                continue
            n_tot += 1
            if hit[i]:
                n_hit += 1
                if not args.count_only:
                    print(f"{seq[i:i + k]}\t{rec.id}:{i}")
    print(f"# {n_hit}/{n_tot} k-mers present", file=sys.stderr)
    return 0


def trim_main(args) -> int:
    """Trim reads to their longest run of filter-present k-mers
    (bloom.cc trim subcommand)."""
    f = bloom_ops.load_filter(args.file, args.device)
    k = f.k
    for rec, seq, hit, _ in _query_hits(f, args.query):
        nk = len(seq) - k + 1
        best_len = best_start = cur_len = cur_start = 0
        for i in range(nk):
            if hit[i]:
                if cur_len == 0:
                    cur_start = i
                cur_len += 1
                if cur_len > best_len:
                    best_len, best_start = cur_len, cur_start
            else:
                cur_len = 0
        if best_len == 0:
            continue
        trimmed = seq[best_start:best_start + best_len + k - 1]
        q = (rec.qual or "I" * len(seq))[
            best_start:best_start + best_len + k - 1]
        sys.stdout.write(f"@{rec.id}\n{trimmed}\n+\n{q}\n")
    return 0


def graph_main(args) -> int:
    """Dump the Bloom DBG as GraphViz dot (bloom.cc graph subcommand /
    Bloom/RollingBloomDBGVisitor.h): vertices = solid k-mers of the
    query sequences, edges = filter-supported extensions."""
    f = bloom_ops.load_filter(args.file, args.device)
    k = f.k
    kmers: set[str] = set()
    for rec, seq, hit, _ in _query_hits(f, args.query):
        for i in range(len(seq) - k + 1):
            if hit[i]:
                km = seq[i:i + k]
                kmers.add(min(km, alphabet.revcomp(km)))
        print(f"# {rec.id}: {len(kmers)} cumulative vertices",
              file=sys.stderr)
    out = sys.stdout
    out.write("digraph bloom_dbg {\n")
    for km in sorted(kmers):
        out.write(f'"{km}"\n')
    for km in sorted(kmers):
        for base in "ACGT":
            nxt = km[1:] + base
            if min(nxt, alphabet.revcomp(nxt)) in kmers:
                out.write(f'"{km}" -> "{nxt}"\n')
    out.write("}\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="abyss-tpu-torch bloom")
    sub = ap.add_subparsers(dest="cmd", required=True)
    # every subcommand runs on the GPU unless --device cpu is given
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="device to run on [cuda]")

    b = sub.add_parser("build", parents=[dev],
                       help="build a Bloom filter from reads")
    b.add_argument("-k", "--kmer", type=int, required=True)
    b.add_argument("-b", "--bloom-size", default="64M")
    b.add_argument("-H", "--num-hashes", type=int, default=4)
    b.add_argument("-l", "--levels", type=int, default=1,
                   help=">=2 builds an N-level cascading Bloom filter "
                        "(contains = seen >= N times; use -t counting "
                        "for min-counter semantics / additive union)")
    b.add_argument("-t", "--type", choices=["bit", "counting", "cascading"],
                   default="bit")
    b.add_argument("-w", "--window", default=None, metavar="i/N",
                   help="build only window i of N (sharded build)")
    b.add_argument("out")
    b.add_argument("files", nargs="+")
    b.set_defaults(fn=build_main)

    u = sub.add_parser("union", parents=[dev],
                       help="merge filters (bitwise OR / sum)")
    u.add_argument("out")
    u.add_argument("inputs", nargs="+")
    u.set_defaults(fn=union_main)

    x = sub.add_parser("intersect", parents=[dev])
    x.add_argument("out")
    x.add_argument("inputs", nargs="+")
    x.set_defaults(fn=intersect_main)

    i = sub.add_parser("info", parents=[dev])
    i.add_argument("file")
    i.set_defaults(fn=info_main)

    c = sub.add_parser("compare", parents=[dev])
    c.add_argument("-m", "--method", default="jaccard",
                   choices=["jaccard", "czekanowski", "raw"])
    c.add_argument("inputs", nargs=2)
    c.set_defaults(fn=compare_main)

    km = sub.add_parser("kmers", parents=[dev],
                        help="k-mers of query present in filter")
    km.add_argument("--count-only", action="store_true")
    km.add_argument("file")
    km.add_argument("query")
    km.set_defaults(fn=kmers_main)

    tr = sub.add_parser("trim", parents=[dev],
                        help="trim reads to solid k-mer runs")
    tr.add_argument("file")
    tr.add_argument("query")
    tr.set_defaults(fn=trim_main)

    gr = sub.add_parser("graph", parents=[dev],
                        help="dump the Bloom DBG as dot")
    gr.add_argument("file")
    gr.add_argument("query")
    gr.set_defaults(fn=graph_main)

    args = ap.parse_args(argv)
    return args.fn(args)
