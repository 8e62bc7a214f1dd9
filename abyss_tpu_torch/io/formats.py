"""Small format converters: .dist text, AGP, ASQG.

Reference: Graph/DistIO.h (write_dist), bin/abyss-fatoagp (Perl,
scaffolds -> AGP 2.0 + scaftigs), Graph/AsqgIO.h (SGA's ASQG overlap
graph format).
"""

from __future__ import annotations

import os
import re


def write_dist_text(estimates: dict, out):
    """The `.dist` text format (DistIO.h): one line per contig,
    `<name> <v>,<d>,<n>,<sd> ... ; <reverse-sense edges>`."""
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    ss = "+-"
    try:
        by_contig: dict[str, dict[int, list]] = {}
        for (un, su, vn, sv), e in estimates.items():
            by_contig.setdefault(un, {0: [], 1: []})[su].append(
                (vn, sv, e))
        for name in sorted(by_contig, key=str):
            f.write(name)
            for sense in (0, 1):
                if sense == 1:
                    f.write(" ;")
                for vn, sv, e in by_contig[name][sense]:
                    f.write(f" {vn}{ss[sv ^ sense]},{e.distance},"
                            f"{e.num_pairs},{e.std_dev:.1f}")
            f.write("\n")
    finally:
        if own:
            f.close()


def fa_to_agp(scaffolds: list[tuple[str, str]], min_gap: int = 1,
              min_contig: int = 50):
    """Scaffold FASTA -> (AGP 2.0 lines, scaftigs) like abyss-fatoagp:
    each N-run >= min_gap becomes a gap row; flanking runs become W rows
    referencing extracted scaftigs."""
    agp_lines = []
    scaftigs = []
    for name, seq in scaffolds:
        part = 1
        pos = 0
        idx = 0
        for m in re.finditer(rf"N{{{min_gap},}}|[^N]+", seq):
            s, e = m.span()
            if m.group(0).startswith("N"):
                agp_lines.append(
                    f"{name}\t{s + 1}\t{e}\t{part}\tN\t{e - s}\t"
                    f"scaffold\tyes\tpaired-ends")
            else:
                tig_name = f"{name}_{idx}"
                scaftigs.append((tig_name, m.group(0)))
                agp_lines.append(
                    f"{name}\t{s + 1}\t{e}\t{part}\tW\t{tig_name}\t1\t"
                    f"{e - s}\t+")
                idx += 1
            part += 1
    scaftigs = [(n, s) for n, s in scaftigs if len(s) >= min_contig]
    return agp_lines, scaftigs


def read_dist_text(path_or_file) -> dict:
    """Parse the `.dist` text format back into
    {(uname, usense, vname, vsense): (d, n, sd)} (Graph/DistIO.h)."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file) if own else path_or_file
    out = {}
    try:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            name = parts[0]
            sense = 0
            for tok in parts[1:]:
                if tok == ";":
                    sense = 1
                    continue
                m = re.match(r"(.+?)([+-]),(-?\d+),(\d+),([\d.]+)$", tok)
                if not m:
                    continue
                vn, vs, d, n, sd = m.groups()
                out[(name, sense, vn, (vs == "-") ^ sense)] = (
                    int(d), int(n), float(sd))
    finally:
        if own:
            f.close()
    return out


def join_dist(paths, out):
    """abyss-joindist: merge .dist files, keeping the estimate with the
    smallest stddev per (contig, neighbour) (bin/abyss-joindist:15-50)."""
    a: dict[str, dict] = {}
    b: dict[str, dict] = {}
    ids = []
    for path in paths:
        with open(path) as f:
            for line in f:
                parts = line.split(None, 1)
                if not parts:
                    continue
                cid, rest = parts[0], parts[1] if len(parts) > 1 else ""
                if cid not in a:
                    a[cid] = {}
                    b[cid] = {}
                    ids.append(cid)
                halves = rest.split(";", 1)
                for side, half in zip((a, b), halves):
                    for tok in half.split():
                        to, d, n, sd = tok.rsplit(",", 3)
                        cur = side[cid].get(to)
                        if cur is None or float(sd) < cur[2]:
                            side[cid][to] = (int(d), int(n), float(sd))
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        def keyf(x):
            return (0, int(x)) if x.lstrip("+-").isdigit() else (1, x)
        for cid in sorted(ids, key=keyf):
            f.write(cid)
            for to in sorted(a[cid], key=keyf):
                d, n, sd = a[cid][to]
                f.write(f" {to},{d},{n},{sd:g}")
            f.write(" ;")
            for to in sorted(b[cid], key=keyf):
                d, n, sd = b[cid][to]
                f.write(f" {to},{d},{n},{sd:g}")
            f.write("\n")
    finally:
        if own:
            f.close()


def sam_to_afg(sam_lines, out, eid: str = "1", iid: str = "1",
               mean: int | None = None, sd: int | None = None):
    """abyss-samtoafg: SAM (+ inline >contig records) -> AMOS AFG message
    stream with LIB/RED/FRG/CTG/TLE records (bin/abyss-samtoafg:29-160)."""
    from ..core.alphabet import revcomp
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        f.write(f"{{LIB\neid:{eid}\niid:{iid}\n")
        if mean is not None and sd is not None:
            f.write(f"{{DST\nmea:{mean}\nstd:{sd}\n}}\n")
        f.write("}\n")
        red_iid = [0]
        frg_iid = [0]
        reds: dict[str, int] = {}
        frgs: dict[str, int] = {}
        tles: dict[str, list] = {}
        ctg_eids: list[str] = []
        ctg_seqs: list[str] = []

        def create_read(rid, seq, qlt):
            red_iid[0] += 1
            my_red = red_iid[0]
            frg_eid = re.sub(r"/[12]$", "", rid)
            mate_iid = None
            if frg_eid in frgs:
                my_frg = frgs.pop(frg_eid)
                mate = (rid[:-1] + "2") if rid.endswith("/1") else \
                    (rid[:-1] + "1")
                mate_iid = reds.pop(mate, None)
            else:
                my_frg = frgs[frg_eid] = frg_iid[0] = frg_iid[0] + 1
                reds[rid] = my_red
            f.write(f"{{RED\nclr:0,{len(seq)}\niid:{my_red}\neid:{rid}\n"
                    f"frg:{my_frg}\nseq:\n{seq}\n.\nqlt:\n{qlt}\n.\n}}\n")
            if mate_iid is not None:
                f.write(f"{{FRG\nrds:{mate_iid},{my_red}\nlib:{iid}\n"
                        f"eid:{frg_eid}\niid:{my_frg}\ntyp:I\n}}\n")
            return my_red

        it = iter(sam_lines)
        for line in it:
            line = line.rstrip("\n")
            if not line or line.startswith(("#", "@")):
                continue
            if line.startswith(">"):
                ctg_eids.append(line[1:].split()[0])
                ctg_seqs.append(next(it).strip())
                continue
            fields = line.split("\t")
            qid, flag, tid, tstart, _mapq, cigar = fields[:6]
            qseq = fields[9] if len(fields) > 9 else "*"
            qqual = fields[10] if len(fields) > 10 else "I" * len(qseq)
            flag = int(flag)
            if flag & 0x100:
                continue
            if flag & 0x40:
                qid += "/1"
            if flag & 0x80:
                qid += "/2"
            rc = flag & 0x10
            if rc:
                qseq = revcomp(qseq)
                qqual = qqual[::-1]
            riid = create_read(qid, qseq, qqual)
            if flag & 0x4:
                continue
            mleft = re.match(r"^(\d+)S", cigar)
            mright = re.search(r"(\d+)S$", cigar)
            qstart = int(mleft.group(1)) if mleft else 0
            qend = len(qseq) - (int(mright.group(1)) if mright else 0)
            clr = f"{qend},{qstart}" if rc else f"{qstart},{qend}"
            tles.setdefault(tid, []).append(
                f"{{TLE\nclr:{clr}\noff:{int(tstart) - 1}\nsrc:{riid}\n}}\n")
        ctg_iid = 0
        for ctg_eid, seq in zip(ctg_eids, ctg_seqs):
            if not tles.get(ctg_eid):
                continue
            ctg_iid += 1
            qlt = "I" * len(seq)
            wrapped = "\n".join(seq[i:i + 60] for i in range(0, len(seq), 60))
            wqlt = "\n".join(qlt[i:i + 60] for i in range(0, len(qlt), 60))
            f.write(f"{{CTG\niid:{ctg_iid}\neid:{ctg_eid}\nseq:\n{wrapped}"
                    f"\n.\nqlt:\n{wqlt}\n.\n")
            for t in tles[ctg_eid]:
                f.write(t)
            f.write("}\n")
    finally:
        if own:
            f.close()


def read_asqg(path_or_file):
    """Read ASQG back: returns (ContigGraph, seqs) (Graph/AsqgIO.h)."""
    from ..graph.contig_graph import ContigGraph, flip, node
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file) if own else path_or_file
    g = ContigGraph()
    seqs: dict[str, str] = {}
    try:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if fields[0] == "VT":
                name, seq = fields[1], fields[2]
                g.add_contig(name, 0 if seq == "*" else len(seq))
                if seq != "*":
                    seqs[name] = seq
            elif fields[0] == "ED":
                t = fields[1].split()
                (un, vn, us, ue, ul, vs, ve, vl, rc) = t[:9]
                us, ue, ul = int(us), int(ue), int(ul)
                vs, ve, vl = int(vs), int(ve), int(vl)
                rc = int(rc)
                # u suffix overlaps v prefix when ue==ul-1
                usense = 0 if ue == ul - 1 else 1
                vsense = usense if not rc else 1 - usense
                u = node(g.id_of(un), usense)
                v = node(g.id_of(vn), vsense)
                o = ue - us + 1
                g.out[u][v] = {"d": -o}
                g.out[flip(v)][flip(u)] = {"d": -o}
    finally:
        if own:
            f.close()
    return g, seqs


def write_asqg(g, seqs: dict[str, str], out):
    """ASQG overlap graph (Graph/AsqgIO.h): HT header, VT vertices,
    ED edges with overlap coordinates."""
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        f.write("HT\tVN:i:1\tER:f:0\tOL:i:0\tIN:Z:abyss_tpu\n")
        for cid in g.contigs():
            name = g.names[cid]
            f.write(f"VT\t{name}\t{seqs.get(name, '*')}\n")
        seen = set()
        for u in g.vertices():
            for v, prop in g.out_edges(u):
                if ((v ^ 1), (u ^ 1)) in seen:
                    continue
                seen.add((u, v))
                d = (prop or {}).get("d", 0)
                o = max(-d, 0)
                lu = g.length(u)
                lv = g.length(v)
                su = 1 if (u & 1) else 0
                sv = 1 if (v & 1) else 0
                # ED: u v ustart uend ulen vstart vend vlen rc numdiff
                rc = 1 if su != sv else 0
                f.write(
                    f"ED\t{g.names[u >> 1]} {g.names[v >> 1]} "
                    f"{lu - o} {lu - 1} {lu} 0 {o - 1} {lv} {rc} 0\n")
    finally:
        if own:
            f.close()
