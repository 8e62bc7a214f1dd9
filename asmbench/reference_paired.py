"""The plain reference of the paired de Bruijn graph (ABySS's K-mode,
`abyss-pe k=<span> K=<k>`): the unitigs the pair graph of some reads
spells, from the definitions, with nothing of the program.

NumPy and plain Python alone; imports neither the program nor JAX.

A vertex is a k-mer pair P = (a, b): two k-mers (k <= 16) whose starts
are `span - k` apart in a read (PairedDBG/KmerPair.h), held as one
64-bit word, a in the high 2k bits, b in the low ones.  Its reverse
complement is rc(P) = (rc(b), rc(a)), and the graph keeps the lesser
of the two (unsigned) as the canonical pair.

- Count: every pair window of every read whose 2k bases are all ACGT,
  by canonical pair, exactly; counts capped at COVERAGE_MAX
  (Assembly/VertexData.h:33).  Pairs seen at least kc times are solid.
- Edges: a Dinuc (d1, d2) (PairedDBG/Dinuc.h) steps P one base right in
  both windows, Q = (a[1:] + d1, b[1:] + d2).  Q is a successor of P
  when its canonical pair is solid (and not trimmed).  The right
  Dinucs of the stored pair and its left Dinucs (the right ones of its
  reverse complement) are the 16 + 16 neighbours.  When span == 2k the
  two windows abut, and a step is consistent only if d1 is b's first
  base (removePairedDBGInconsistentEdges, PairedDBGAlgorithms.h).
- An oriented vertex is a solid pair read in one direction: (row,
  strand), strand 1 walking rc(P).  Its in-degree is its reverse
  complement's out-degree.
- Tips: a round takes the chains of the graph as it stands (below) and
  removes every chain whose head has no predecessor, that holds at
  most t vertices, and whose last vertex has at most one successor
  (TrimAlgorithm.h's removable ends); rounds repeat until one removes
  nothing.  t = span by default, as abyss-pe sets it.
- Links: P -> Q when Q is P's only successor, P is Q's only
  predecessor, and neither is its own reverse complement.  A chain is
  a maximal run of links from a vertex without a predecessor; a cycle
  starts at its least (2 row + strand).
- Spelling: a chain P_0 .. P_{L-1} covers L - 1 + span bases: a(P_j)
  at offset j and b(P_j) at offset j + span - k.  The a windows fix
  bases 0 .. L - 2 + k, the b windows the rest they cover, and bases
  that no window covers (L < span - 2k + 1) are N.
- Unitigs: each chain's sequence in canonical form (the lesser of it
  and its reverse complement), chains taken by head, the first of
  equal sequences kept; its coverage is the sum of its pairs' counts.

Where this departs from upstream's `abyss-paired-dbg`, as the program
does: no erosion, no low-coverage removal and no bubble popping (the
whole ABYSS assembly stack that upstream runs on KmerPair vertices);
trim rounds all run at t (upstream's performTrim first runs rounds at
1, 2, 4, ... below t); and `abyss-pe` writes the unitigs with coverage
0 in their headers, while `assemble` here returns the sums.
"""

from __future__ import annotations

import numpy as np

COVERAGE_MAX = 32767  # Assembly/VertexData.h:33
ROWS_PER_CHUNK = 8192
BASES = "ACGT"
COMPLEMENT = str.maketrans("ACGTN", "TGCAN")


def _kmer_words(reads: np.ndarray, k: int):
    """(fwd, rc, ok) uint64/bool [n, L - k + 1]: every k-window of
    `reads` (codes, 4 = N) packed 2 bits a base, first base highest, its
    reverse complement packed the same way, and whether it is all
    ACGT."""
    n, L = reads.shape
    W = L - k + 1
    codes = reads.astype(np.uint64)
    good = reads < 4
    fwd = np.zeros((n, W), np.uint64)
    rc = np.zeros((n, W), np.uint64)
    ok = np.ones((n, W), bool)
    for j in range(k):
        c = codes[:, j:j + W] & np.uint64(3)
        fwd |= c << np.uint64(2 * (k - 1 - j))
        rc |= (np.uint64(3) - c) << np.uint64(2 * j)
        ok &= good[:, j:j + W]
    return fwd, rc, ok


def rc_pair(p, k: int):
    """Reverse complement of packed pairs: (rc(b), rc(a))."""
    p = np.asarray(p, np.uint64)
    mask = np.uint64((1 << (2 * k)) - 1)
    return (_rc_word(p & mask, k) << np.uint64(2 * k)) | \
        _rc_word(p >> np.uint64(2 * k), k)


def _rc_word(w, k: int):
    out = np.zeros_like(w)
    for j in range(k):
        out |= (np.uint64(3) - ((w >> np.uint64(2 * j)) & np.uint64(3))) \
            << np.uint64(2 * (k - 1 - j))
    return out


def count_pairs(reads: list[np.ndarray], k: int, span: int):
    """(keys, counts): the canonical pairs of every read window, sorted
    (unsigned), and how often each was seen."""
    parts = []
    for r in reads:
        r = np.asarray(r, np.uint8)
        if r.shape[1] < span:
            continue
        for lo in range(0, r.shape[0], ROWS_PER_CHUNK):
            fwd, rc, ok = _kmer_words(r[lo:lo + ROWS_PER_CHUNK], k)
            W = r.shape[1] - span + 1
            off = span - k
            a, b = fwd[:, :W], fwd[:, off:off + W]
            ra, rb = rc[:, :W], rc[:, off:off + W]
            P = (a << np.uint64(2 * k)) | b
            R = (rb << np.uint64(2 * k)) | ra
            canon = np.minimum(P, R)[ok[:, :W] & ok[:, off:off + W]]
            parts.append(np.unique(canon, return_counts=True))
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    keys = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    uniq, inv = np.unique(keys, return_inverse=True)
    return uniq, np.bincount(inv.ravel(), weights=counts,
                             minlength=len(uniq)).astype(np.int64)


class PairGraph:
    """The solid pairs of some reads and the edges between them."""

    def __init__(self, reads: list[np.ndarray], k: int, span: int,
                 kc: int = 2):
        if k > 16 or span < 2 * k:
            raise ValueError(f"pairs of k <= 16 with span >= 2k; got k={k}, "
                             f"span={span}")
        self.k, self.span = k, span
        keys, counts = count_pairs(reads, k, span)
        solid = counts >= kc
        self.keys = keys[solid]
        self.cov = np.minimum(counts[solid], COVERAGE_MAX)
        n = len(self.keys)
        self.alive = np.ones(n, bool)
        # oriented vertex 2 row + strand; its pair in walk direction
        self.word = np.empty(2 * n, np.uint64)
        self.word[0::2] = self.keys
        self.word[1::2] = rc_pair(self.keys, k)
        self.palin = self.word[0::2] == self.word[1::2]
        self.succ = self._successors()

    def _successors(self) -> np.ndarray:
        """int64 [2n, 16]: the oriented vertex each Dinuc step of each
        oriented vertex reaches, -1 where its pair is not solid or the
        step is inconsistent."""
        k, n = self.k, len(self.keys)
        mask = np.uint64((1 << (2 * k)) - 1)
        w = self.word
        a, b = w >> np.uint64(2 * k), w & mask
        out = np.full((2 * n, 16), -1, np.int64)
        if n == 0:
            return out
        b_first = (b >> np.uint64(2 * (k - 1))) & np.uint64(3)
        for d in range(16):
            d1, d2 = np.uint64(d >> 2), np.uint64(d & 3)
            q = (((a << np.uint64(2)) | d1) & mask) << np.uint64(2 * k) | \
                (((b << np.uint64(2)) | d2) & mask)
            qc = np.minimum(q, rc_pair(q, k))
            row = np.searchsorted(self.keys, qc).clip(max=n - 1)
            hit = self.keys[row] == qc
            if self.span == 2 * k:
                hit &= b_first == d1
            strand = (q != self.keys[row]).astype(np.int64)
            out[:, d] = np.where(hit, 2 * row + strand, -1)
        return out

    def _links(self):
        """(nxt, outdeg): each oriented vertex's linked successor (-1
        where none) and its number of living successors."""
        alive_ov = np.repeat(self.alive, 2)
        live = (self.succ >= 0) & alive_ov[np.maximum(self.succ, 0)]
        live &= alive_ov[:, None]
        outdeg = live.sum(axis=1)
        indeg = outdeg[np.arange(len(outdeg)) ^ 1]
        only = np.where(live, self.succ, -1).max(axis=1)
        palin_ov = np.repeat(self.palin, 2)
        tgt = np.maximum(only, 0)
        link = (outdeg == 1) & ~palin_ov & (indeg[tgt] == 1) & \
            ~palin_ov[tgt]
        return np.where(link, only, -1), outdeg

    def chains(self):
        """(chains, outdeg): every chain of the living graph as a list of
        oriented vertices, heads in increasing order, and the degrees."""
        nxt, outdeg = self._links()
        has_prev = np.zeros(len(nxt), bool)
        has_prev[nxt[nxt >= 0]] = True
        alive_ov = np.repeat(self.alive, 2)
        nxt_l = nxt.tolist()
        done = np.zeros(len(nxt), bool)
        chains = []
        for v in np.flatnonzero(alive_ov & ~has_prev).tolist():
            chain = [v]
            while nxt_l[chain[-1]] >= 0:
                chain.append(nxt_l[chain[-1]])
            done[chain] = True
            chains.append(chain)
        # what is left are cycles, each started at its least vertex
        for v in np.flatnonzero(alive_ov & ~done).tolist():
            if done[v]:
                continue
            chain = [v]
            while nxt_l[chain[-1]] != v:
                chain.append(nxt_l[chain[-1]])
            done[chain] = True
            chains.append(chain)
        chains.sort(key=lambda c: c[0])
        return chains, outdeg

    def trim(self, t: int) -> None:
        """Tip rounds at t until one removes nothing."""
        while t > 0:
            chains, outdeg = self.chains()
            indeg = outdeg[np.arange(len(outdeg)) ^ 1]
            dead = [c for c in chains if indeg[c[0]] == 0 and len(c) <= t
                    and outdeg[c[-1]] <= 1]
            if not dead:
                break
            for c in dead:
                self.alive[np.asarray(c) >> 1] = False

    def spell(self, chain: list[int]) -> str:
        k, span = self.k, self.span
        sh, mask = 2 * k, (1 << (2 * k)) - 1
        words = [int(self.word[v]) for v in chain]
        # each step adds the last base of the next pair's a and of its b
        a = _unpack(words[0] >> sh, k) + \
            "".join(BASES[(w >> sh) & 3] for w in words[1:])
        b = _unpack(words[0] & mask, k) + \
            "".join(BASES[w & 3] for w in words[1:])
        seq = ["N"] * (len(chain) - 1 + span)
        seq[span - k:] = b
        seq[:len(a)] = a
        return "".join(seq)

    def unitigs(self) -> list[tuple[str, int]]:
        out, seen = [], set()
        chains, _ = self.chains()
        for c in chains:
            s = self.spell(c)
            canon = min(s, revcomp(s))
            if canon in seen:
                continue
            seen.add(canon)
            out.append((canon, int(self.cov[np.asarray(c) >> 1].sum())))
        return out


def _unpack(w: int, k: int) -> str:
    return "".join(BASES[(w >> (2 * (k - 1 - j))) & 3] for j in range(k))


def revcomp(s: str) -> str:
    return s.translate(COMPLEMENT)[::-1]


def assemble(reads: list[np.ndarray], k: int, span: int, kc: int = 2,
             tip_len: int | None = None) -> list[tuple[str, int]]:
    """The unitigs of `reads` (code arrays [n, L], A=0 C=1 G=2 T=3, 4 =
    N) in the pair graph of k-mers k at span `span`: [(sequence,
    coverage)]."""
    g = PairGraph(reads, k, span, kc)
    g.trim(span if tip_len is None else tip_len)
    return g.unitigs()
