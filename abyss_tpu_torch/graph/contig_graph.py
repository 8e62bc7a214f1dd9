"""Skew-symmetric contig graph (the reference's ContigGraph,
Graph/ContigGraph.h over DirectedGraph.h).

Vertices are oriented contigs (ContigNode, Common/ContigNode.h:19):
vertex index = 2 * contig_id + sense (sense 0 = '+', 1 = '-').  The
graph maintains the reverse-complement symmetry invariant: edge
(u -> v) exists iff (v^1 -> u^1) exists, with the same properties.

This layer is host-side by design: contig graphs are ~10^3-10^6
vertices (tiny next to the k-mer stage), and the pipeline's graph
algorithms are control-flow heavy.  Device kernels are used by the
*builders* (AdjList overlap join) and *scorers* (alignment), not the
graph bookkeeping.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator


SENSE_STR = "+-"


def node(contig_id: int, sense: int = 0) -> int:
    return 2 * contig_id + sense


def contig_id(v: int) -> int:
    return v >> 1


def sense(v: int) -> int:
    return v & 1


def flip(v: int) -> int:
    """ContigNode operator^ with orientation 1."""
    return v ^ 1


def vertex_name(v: int, names: list[str]) -> str:
    return f"{names[v >> 1]}{SENSE_STR[v & 1]}"


def parse_vertex_name(s: str, index: dict[str, int]) -> int:
    cid = index[s[:-1]]
    return node(cid, 0 if s[-1] == "+" else 1)


@dataclass
class ContigGraph:
    names: list[str] = field(default_factory=list)
    lengths: list[int] = field(default_factory=list)
    coverages: list[int] = field(default_factory=list)
    # out-adjacency per vertex: dict target -> edge property (dict or None)
    out: list[dict] = field(default_factory=list)
    removed: list[bool] = field(default_factory=list)
    _index: dict = field(default_factory=dict)

    # -- construction -------------------------------------------------------

    def add_contig(self, name: str, length: int = 0, coverage: int = 0) -> int:
        cid = len(self.names)
        self.names.append(str(name))
        self.lengths.append(int(length))
        self.coverages.append(int(coverage))
        self.out.append({})
        self.out.append({})
        self.removed.append(False)
        self._index[str(name)] = cid
        return cid

    def id_of(self, name: str) -> int:
        return self._index[str(name)]

    @property
    def num_contigs(self) -> int:
        return len(self.names)

    @property
    def num_vertices(self) -> int:
        return 2 * len(self.names)

    def add_edge(self, u: int, v: int, prop: dict | None = None):
        """Add u->v and its complement v^1 -> u^1."""
        self.out[u][v] = prop
        self.out[flip(v)][flip(u)] = prop

    def has_edge(self, u: int, v: int) -> bool:
        return v in self.out[u]

    def edge_prop(self, u: int, v: int):
        return self.out[u][v]

    def remove_edge(self, u: int, v: int):
        self.out[u].pop(v, None)
        self.out[flip(v)].pop(flip(u), None)

    # -- queries ------------------------------------------------------------

    def vertices(self) -> Iterator[int]:
        for v in range(self.num_vertices):
            if not self.removed[v >> 1]:
                yield v

    def contigs(self) -> Iterator[int]:
        for c in range(self.num_contigs):
            if not self.removed[c]:
                yield c

    def out_edges(self, u: int) -> list[tuple[int, dict | None]]:
        return list(self.out[u].items())

    def successors(self, u: int) -> list[int]:
        return list(self.out[u].keys())

    def predecessors(self, u: int) -> list[int]:
        """in-edges via skew symmetry: w -> u iff u^1 -> w^1."""
        return [flip(w) for w in self.out[flip(u)].keys()]

    def in_edges(self, u: int) -> list[tuple[int, dict | None]]:
        return [(flip(w), p) for w, p in self.out[flip(u)].items()]

    def out_degree(self, u: int) -> int:
        return len(self.out[u])

    def in_degree(self, u: int) -> int:
        return len(self.out[flip(u)])

    def length(self, v: int) -> int:
        return self.lengths[v >> 1]

    def coverage(self, v: int) -> int:
        return self.coverages[v >> 1]

    def name(self, v: int) -> str:
        return vertex_name(v, self.names)

    # -- mutation -----------------------------------------------------------

    def remove_contig(self, cid: int):
        """Remove a contig and all its edges (clear_vertex + remove,
        like DirectedGraph::clear_vertex)."""
        for v in (node(cid, 0), node(cid, 1)):
            for w in list(self.out[v].keys()):
                self.remove_edge(v, w)
            for w in self.predecessors(v):
                self.remove_edge(w, v)
        self.removed[cid] = True

    def copy(self) -> "ContigGraph":
        g = ContigGraph(
            names=list(self.names), lengths=list(self.lengths),
            coverages=list(self.coverages),
            out=[dict(d) for d in self.out],
            removed=list(self.removed), _index=dict(self._index))
        return g

    def num_edges(self) -> int:
        return sum(len(self.out[v]) for v in self.vertices())
