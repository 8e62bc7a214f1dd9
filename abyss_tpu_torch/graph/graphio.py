"""Contig-graph file IO: .dot (abyss dialect), .adj, .gfa2, .dist.

Format references:
  .dot  Graph/DotIO.h:75-140 (write), :250-330 (read)
  .adj  Graph/AdjIO.h:29-60
  .gfa2 Graph/GfaIO.h
  .dist Graph/DistIO.h / Common/Estimate.h ("d,n,sd" DIST format)
"""

from __future__ import annotations

import io
import os
import re
from typing import Iterable

from .contig_graph import ContigGraph, flip, node, parse_vertex_name


def _vprop_str(g: ContigGraph, cid: int) -> str:
    return f"l={g.lengths[cid]} C={g.coverages[cid]}"


def _eprop_str(prop: dict | None) -> str:
    if not prop:
        return ""
    if "n" in prop and "sd" in prop:  # DistanceEst edge
        return f"d={prop.get('d', 0)} e={prop['sd']:.1f} n={prop['n']}"
    if "d" in prop:
        return f"d={prop['d']}"
    return ""


def write_dot(g: ContigGraph, out, k: int = 0, graph_name: str = "adj"):
    """GraphViz dot in the reference dialect (DotIO.h:82-115)."""
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        f.write(f"digraph {graph_name} {{\n")
        if k > 0:
            f.write(f"graph [k={k}]\n")
            f.write(f"edge [d={-(k - 1)}]\n")
        for v in g.vertices():
            if v & 1 == 0:
                f.write(f'"{g.name(v)}" [{_vprop_str(g, v >> 1)}]\n')
                f.write(f'"{g.name(flip(v))}" [{_vprop_str(g, v >> 1)}]\n')
        default_d = -(k - 1) if k > 0 else None
        for u in g.vertices():
            edges = g.out_edges(u)
            if not edges:
                continue
            # edges with non-default properties are written one per line
            plain = [v for v, p in edges
                     if not p or (len(p) == 1 and p.get("d") == default_d)]
            special = [(v, p) for v, p in edges
                       if p and not (len(p) == 1 and p.get("d") == default_d)]
            if plain:
                f.write(f'"{g.name(u)}" ->')
                if len(plain) > 1:
                    f.write(" {")
                for v in plain:
                    f.write(f' "{g.name(v)}"')
                if len(plain) > 1:
                    f.write(" }")
                f.write("\n")
            for v, p in special:
                f.write(f'"{g.name(u)}" -> "{g.name(v)}" [{_eprop_str(p)}]\n')
        f.write("}\n")
    finally:
        if own:
            f.close()


_DOT_VERTEX = re.compile(r'^"([^"]+)"\s*(?:\[(.*)\])?\s*$')
_DOT_EDGE = re.compile(r'^"([^"]+)"\s*->\s*(.*)$')
_PROP = re.compile(r'(\w+)\s*=\s*("[^"]*"|[-\w.,]+)')


def _parse_props(s: str) -> dict:
    out = {}
    for m in _PROP.finditer(s or ""):
        key, val = m.group(1), m.group(2).strip('"')
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


def read_dot(path_or_file) -> tuple[ContigGraph, int]:
    """Read the abyss dot dialect. Returns (graph, k)."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file) if own else path_or_file
    g = ContigGraph()
    k = 0
    default_edge: dict = {}
    try:
        for line in f:
            line = line.strip().rstrip(";")
            if not line or line.startswith(("digraph", "}")):
                continue
            if line.startswith("graph ["):
                k = _parse_props(line).get("k", 0)
                continue
            if line.startswith("edge ["):
                default_edge = _parse_props(line)
                continue
            m = _DOT_EDGE.match(line)
            if m:
                uname = m.group(1)
                rest = m.group(2).strip()
                prop = default_edge.copy()
                pm = re.search(r'\[(.*)\]\s*$', rest)
                if pm:
                    prop.update(_parse_props(pm.group(1)))
                    rest = rest[:pm.start()].strip()
                targets = re.findall(r'"([^"]+)"', rest)
                u = _ensure_vertex(g, uname)
                for tname in targets:
                    v = _ensure_vertex(g, tname)
                    g.out[u][v] = dict(prop) if prop else None
                    g.out[flip(v)][flip(u)] = dict(prop) if prop else None
                continue
            m = _DOT_VERTEX.match(line)
            if m:
                vname = m.group(1)
                props = _parse_props(m.group(2) or "")
                v = _ensure_vertex(g, vname)
                if "l" in props:
                    g.lengths[v >> 1] = int(props["l"])
                if "C" in props:
                    g.coverages[v >> 1] = int(props["C"])
    finally:
        if own:
            f.close()
    return g, k


def _ensure_vertex(g: ContigGraph, vname: str) -> int:
    base = vname[:-1]
    if base not in g._index:
        g.add_contig(base)
    return parse_vertex_name(vname, g._index)


def write_adj(g: ContigGraph, out, with_props: bool = True):
    """The .adj adjacency format (AdjIO.h:29-60): one line per contig:
    `<name> l=<len> C=<cov>\\t; <fwd neighbours>\\t; <rev neighbours>`
    where rev neighbours are printed flipped."""
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        for cid in g.contigs():
            f.write(g.names[cid])
            if with_props:
                f.write(f" {_vprop_str(g, cid)}")
            for sense_ in (0, 1):
                f.write("\t;")
                u = node(cid, sense_)
                for v in g.successors(u):
                    f.write(f" {g.name(v ^ sense_)}")
            f.write("\n")
    finally:
        if own:
            f.close()


def read_adj(path_or_file) -> ContigGraph:
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file) if own else path_or_file
    g = ContigGraph()
    lines = []
    try:
        for line in f:
            if not line.strip():
                continue
            lines.append(line.rstrip("\n"))
        # first pass: create contigs
        for line in lines:
            head = line.split("\t")[0]
            parts = head.split()
            name = parts[0]
            props = _parse_props(" ".join(parts[1:]))
            g.add_contig(name, props.get("l", 0), props.get("C", 0))
        # second pass: edges
        for line in lines:
            fields = line.split("\t")
            name = fields[0].split()[0]
            cid = g.id_of(name)
            for sense_, fld in enumerate(fields[1:3]):
                fld = fld.lstrip(";").strip()
                u = node(cid, sense_)
                for vname in fld.split():
                    v = parse_vertex_name(vname, g._index) ^ sense_
                    g.out[u][v] = None
                    g.out[flip(v)][flip(u)] = None
    finally:
        if own:
            f.close()
    return g


def write_gfa2(g: ContigGraph, out, k: int, seqs: dict[str, str] | None = None):
    """GFA2 (Graph/GfaIO.h): S lines per contig, E lines per edge with
    k-1 overlap alignments."""
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        f.write("H\tVN:Z:2.0\n")
        for cid in g.contigs():
            seq = (seqs or {}).get(g.names[cid], "*")
            f.write(f"S\t{g.names[cid]}\t{g.lengths[cid]}\t{seq}\n")
        seen = set()
        for u in g.vertices():
            for v, p in g.out_edges(u):
                if (flip(v), flip(u)) in seen:
                    continue
                seen.add((u, v))
                d = (p or {}).get("d", -(k - 1))
                o = -d
                lu, lv = g.length(u), g.length(v)
                f.write(
                    f"E\t*\t{g.name(u)}\t{g.name(v)}\t"
                    f"{lu - o}\t{lu}$\t0\t{o}\t{o}M\n")
    finally:
        if own:
            f.close()


def write_gfa1(g: ContigGraph, out, k: int = 0):
    """GFA1 (Graph/GfaIO.h:20-67): S lines with LN:i/KC:i tags, L lines
    with `<overlap>M` CIGAR for the canonical orientation of each edge."""
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        f.write("H\tVN:Z:1.0\n")
        for cid in g.contigs():
            f.write(f"S\t{g.names[cid]}\t*\tLN:i:{g.lengths[cid]}")
            if g.coverages[cid] > 0:
                f.write(f"\tKC:i:{g.coverages[cid]}")
            f.write("\n")
        for u in g.vertices():
            for v, p in g.out_edges(u):
                if u > flip(v):  # canonical edge only (GfaIO.h:52)
                    continue
                d = (p or {}).get("d", -(k - 1) if k else 0)
                cig = f"{-d}M" if d <= 0 else "*"
                f.write(f"L\t{g.names[u >> 1]}\t{'-+'[1 - (u & 1)]}\t"
                        f"{g.names[v >> 1]}\t{'-+'[1 - (v & 1)]}\t{cig}\n")
    finally:
        if own:
            f.close()


def read_gfa(path_or_file) -> tuple[ContigGraph, int]:
    """Read GFA1 (S/L lines) or GFA2 (S/E lines) as written by this
    module / the reference (Graph/GfaIO.h:233-330)."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file) if own else path_or_file
    g = ContigGraph()
    k = 0
    try:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            tag = fields[0]
            if tag == "S":
                name = fields[1]
                length = 0
                cov = 0
                if len(fields) >= 3 and fields[2].isdigit():  # GFA2
                    length = int(fields[2])
                elif len(fields) >= 3 and fields[2] not in ("*", ""):
                    length = len(fields[2])
                for t in fields[3:]:
                    if t.startswith("LN:i:"):
                        length = int(t[5:])
                    elif t.startswith(("KC:i:", "RC:i:")):
                        cov = int(t[5:])
                if name not in g._index:
                    g.add_contig(name, length, cov)
                else:
                    g.lengths[g.id_of(name)] = length
                    g.coverages[g.id_of(name)] = cov
            elif tag == "L":
                u = _ensure_vertex(g, fields[1] + ("+-"[fields[2] == "-"]))
                v = _ensure_vertex(g, fields[3] + ("+-"[fields[4] == "-"]))
                m = re.match(r"(\d+)M", fields[5]) if len(fields) > 5 else None
                prop = {"d": -int(m.group(1))} if m else None
                g.out[u][v] = dict(prop) if prop else None
                g.out[flip(v)][flip(u)] = dict(prop) if prop else None
                if m and not k:
                    k = int(m.group(1)) + 1
            elif tag == "E":
                # E * u[+-] v[+-] ustart uend vstart vend cigar
                u = _ensure_vertex(g, fields[2])
                v = _ensure_vertex(g, fields[3])
                m = re.match(r"(\d+)M", fields[8]) if len(fields) > 8 else None
                prop = {"d": -int(m.group(1))} if m else None
                g.out[u][v] = dict(prop) if prop else None
                g.out[flip(v)][flip(u)] = dict(prop) if prop else None
                if m and not k:
                    k = int(m.group(1)) + 1
    finally:
        if own:
            f.close()
    return g, k


def write_sam_graph(g: ContigGraph, out, program: str = "abyss-tpu",
                    command_line: str = ""):
    """SAM-as-graph (Graph/SAMIO.h:18-75): @SQ per contig (XC = coverage),
    one alignment record per overlap edge (only distance <= 0 edges are
    representable)."""
    own = isinstance(out, (str, os.PathLike))
    f = open(out, "w") if own else out
    try:
        f.write("@HD\tVN:1.0\n")
        f.write(f"@PG\tID:{program}\tCL:{command_line}\n")
        for cid in g.contigs():
            f.write(f"@SQ\tSN:{g.names[cid]}\tLN:{g.lengths[cid]}")
            if g.coverages[cid] > 0:
                f.write(f"\tXC:{g.coverages[cid]}")
            f.write("\n")
        for u in g.vertices():
            for v, p in g.out_edges(u):
                d = (p or {}).get("d", 0)
                if d > 0:
                    continue
                flag = 0 if (u & 1) == (v & 1) else 0x10
                alen = -d
                pos = 1 + (0 if (u & 1) else g.length(u) - alen)
                vlen = g.length(v)
                clip = vlen - alen
                cigar = (f"{alen}M{clip}S" if (v & 1) == 0
                         else f"{clip}S{alen}M")
                f.write(f"{g.names[v >> 1]}\t{flag}\t{g.names[u >> 1]}\t"
                        f"{pos}\t255\t{cigar}\t*\t0\t0\t*\t*\n")
    finally:
        if own:
            f.close()


def read_sam_graph(path_or_file) -> tuple[ContigGraph, int]:
    """Read the SAM-as-graph dialect back (Graph/SAMIO.h:84-135)."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file) if own else path_or_file
    g = ContigGraph()
    try:
        for line in f:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    name = length = cov = None
                    for t in line.rstrip().split("\t")[1:]:
                        if t.startswith("SN:"):
                            name = t[3:]
                        elif t.startswith("LN:"):
                            length = int(t[3:])
                        elif t.startswith("XC:"):
                            cov = int(t[3:])
                    g.add_contig(name, length or 0, cov or 0)
                continue
            fields = line.rstrip("\n").split("\t")
            qname, flag, rname, pos, _, cigar = fields[:6]
            flag = int(flag)
            m = re.search(r"(\d+)M", cigar)
            alen = int(m.group(1)) if m else 0
            pos0 = int(pos) - 1
            usense = 0 if pos0 > 0 else 1
            vsense = usense if not (flag & 0x10) else 1 - usense
            u = node(g.id_of(rname), usense)
            v = node(g.id_of(qname), vsense)
            prop = {"d": -alen}
            g.out[u][v] = dict(prop)
            g.out[flip(v)][flip(u)] = dict(prop)
    finally:
        if own:
            f.close()
    return g, 0


def write_graph(g: ContigGraph, path: str, k: int = 0,
                fmt: str | None = None, **kw):
    """Dispatch on extension like GraphIO.h:102."""
    fmt = fmt or os.path.splitext(path)[1].lstrip(".")
    if fmt in ("dot", "gv"):
        write_dot(g, path, k=k)
    elif fmt == "adj":
        write_adj(g, path)
    elif fmt == "gfa1":
        write_gfa1(g, path, k=k)
    elif fmt in ("gfa", "gfa2"):
        write_gfa2(g, path, k=k, **kw)
    elif fmt == "sam":
        write_sam_graph(g, path)
    elif fmt == "asqg":
        from ..io.formats import write_asqg
        write_asqg(g, kw.get("seqs") or {}, path)
    else:
        raise ValueError(f"unknown graph format: {fmt}")


def read_graph(path: str) -> tuple[ContigGraph, int]:
    ext = os.path.splitext(path)[1].lstrip(".")
    if ext in ("dot", "gv"):
        return read_dot(path)
    if ext == "adj":
        return read_adj(path), 0
    if ext.startswith("gfa"):
        return read_gfa(path)
    if ext == "sam":
        return read_sam_graph(path)
    if ext == "asqg":
        from ..io.formats import read_asqg
        g, _seqs = read_asqg(path)
        return g, 0
    raise ValueError(f"unknown graph format: {ext}")
