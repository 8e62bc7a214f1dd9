"""Colour-space (SOLiD) pipeline flow — the `cs` branch of `pe`.

Reference: bin/abyss-pe:673-697.  With colour-space
input the reference assembles the COLOUR stream (opt::colourSpace),
runs the contig pipeline unchanged through `-4.path3`, skips
PathConsensus (`ifdef cs`: `-5` symlinks `-4`), merges paths into
`name-cs.fa` (colour contigs), and converts to nucleotides by aligning
the original reads back (`KAligner --seq -m`) and calling a per-position
consensus (`Consensus/Consensus.cpp:40-55`), whose decode primitive is
colourToNucleotideSpace (`Common/Sequence.cpp:113-138` — the same table
`abyss-cstont` uses).

TPU-native substitutions (documented):

  * colours '0123' are letter-encoded A/C/G/T and flow through the
    UNCHANGED letter-space engines.  A reverse-strand read of a locus
    carries the REVERSED colour stream (colours are complement-
    invariant), which in letter space is a *different* sequence than
    the forward stream — so each locus assembles once per strand, the
    strand-specific (`ss`) behaviour, and the final nucleotide contigs
    are deduplicated by canonical sequence.
  * a colour contig's nucleotide decode is fixed by ONE unknown base:
    nt[j+1] = nt[j] XOR colour[j], so the whole segment is S0 XOR d for
    the candidate decode S0 (started at code 0) and a constant d.
    Every aligned read's anchor base votes for d (the vectorized form
    of Consensus' per-position pileup — with exact colour matches all
    positions of a read vote identically, so one vote per read).
  * letter-space alignments may come back reverse-complemented (the
    letter engines canonicalize with revcomp, which has no colour-space
    meaning); per contig the majority alignment orientation picks the
    true colour stream (contigs are single-stream by construction, so
    orientations are near-unanimous), and minority-orientation
    alignments are dropped.

Port of abyss_tpu/pipeline/cs.py (no jax there): a copy whose only
change is the `device` (the pipeline's) of the KmerAligner that
`finish_nt` builds.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core import alphabet
from ..io import fastx

_COLOUR_TO_LETTER = {"0": "A", "1": "C", "2": "G", "3": "T"}


def detect(in_files) -> bool:
    """True when the first record of the first input looks colour-space
    (FastaReader's isColourSpace test: anchor base then digits)."""
    for path in in_files:
        for rec in fastx.read_fastx(path):
            return alphabet.is_colour_space(rec.seq)
    return False


def prepare(p) -> None:
    """Convert colour-space inputs to letter-encoded colour files for
    the letter-space stages; originals are kept for the consensus
    decode."""
    p.cs_orig_files = list(p.in_files)
    conv = []
    os.makedirs(p.outdir, exist_ok=True)
    for i, path in enumerate(p.in_files):
        out = os.path.join(p.outdir, f"{p.name}-csin{i}.fa")
        with open(out, "w") as f:
            for rec in fastx.read_fastx(path):
                colours = rec.seq[1:]
                letters = "".join(_COLOUR_TO_LETTER.get(ch, "N")
                                  for ch in colours)
                f.write(f">{rec.id}\n{letters}\n")
        conv.append(out)
    p.in_files = conv
    if p.libs:
        for lib in p.libs.values():
            lib.files = [conv[p.cs_orig_files.index(x)]
                         if x in p.cs_orig_files else x
                         for x in lib.files]


def _decode_s0(colours: np.ndarray):
    """Candidate nucleotide decode of a colour-code array: start every
    N-delimited segment at code 0; returns (S0 codes [M+1], seg id
    [M+1], valid [M+1])."""
    M = len(colours)
    nt = np.zeros(M + 1, np.uint8)
    seg = np.zeros(M + 1, np.int64)
    ok = np.zeros(M + 1, bool)
    s = 0
    for j in range(M):
        c = int(colours[j])
        if c >= 4:
            s += 1
            nt[j + 1] = 0
        else:
            nt[j + 1] = nt[j] ^ c
            ok[j] = True
            ok[j + 1] = True
        seg[j + 1] = s
    return nt, seg, ok


def finish_nt(p, cs_fa: str) -> str:
    """`name-cs.fa` (colour contigs) -> `name-6.fa` (nucleotides) via
    read alignment + anchored consensus (KAligner | Consensus,
    bin/abyss-pe:692-694); the alignment runs on `p.device`."""
    from ..align.mapper import KmerAligner

    contigs = [(rec.id, rec.seq) for rec in fastx.read_fastx(cs_fa)]
    out_path = os.path.join(p.outdir, f"{p.name}-6.fa")
    if not contigs:
        open(out_path, "w").close()
        return out_path
    map_k = min(p.k, 32)
    aligner = KmerAligner(contigs, k=map_k, min_seeds=2, device=p.device)

    # per contig: orientation votes and per-(segment, d) anchor votes
    n_orient = {n: np.zeros(2, np.int64) for n, _ in contigs}
    d_votes: dict[str, dict[tuple[int, int], int]] = \
        {n: {} for n, _ in contigs}
    lens = {n: len(s) for n, s in contigs}
    col_codes = {n: alphabet.encode(s) for n, s in contigs}
    decode = {}
    for n, s in contigs:
        decode[n] = {}
        for flip in (0, 1):
            c = col_codes[n] if not flip else \
                alphabet.revcomp_codes(col_codes[n])
            decode[n][flip] = _decode_s0(c)

    B, L = 1024, 512
    batch_reads: list[tuple[str, str]] = []

    def flush():
        if not batch_reads:
            return
        codes = np.full((B, L), 4, np.uint8)
        lengths = np.zeros(B, np.int64)
        ids = []
        for i, (rid, colours) in enumerate(batch_reads):
            cc = alphabet.encode("".join(
                _COLOUR_TO_LETTER.get(ch, "N") for ch in colours))[:L]
            codes[i, :len(cc)] = cc
            lengths[i] = len(cc)
            ids.append(rid)
        for (rid, colours), a in zip(
                batch_reads, aligner.align_batch(codes, lengths, ids)):
            if a is None:
                continue
            n_orient[a.rname][1 if a.rev else 0] += 1
        batch_reads.clear()

    # pass A: orientation votes
    anchors = {}
    reads = []
    for path in p.cs_orig_files:
        for rec in fastx.read_fastx(path):
            if not alphabet.is_colour_space(rec.seq):
                continue
            reads.append((rec.id, rec.seq[0], rec.seq[1:]))
    for rid, anchor, colours in reads:
        batch_reads.append((rid, colours))
        anchors[rid] = anchor
        if len(batch_reads) == B:
            flush()
    flush()
    flip_of = {n: int(v[1] > v[0]) for n, v in n_orient.items()}

    # pass B: anchor votes in the chosen orientation
    def flush_d():
        if not batch_reads:
            return
        codes = np.full((B, L), 4, np.uint8)
        lengths = np.zeros(B, np.int64)
        ids = []
        for i, (rid, colours) in enumerate(batch_reads):
            cc = alphabet.encode("".join(
                _COLOUR_TO_LETTER.get(ch, "N") for ch in colours))[:L]
            codes[i, :len(cc)] = cc
            lengths[i] = len(cc)
            ids.append(rid)
        for (rid, colours), a in zip(
                batch_reads, aligner.align_batch(codes, lengths, ids)):
            if a is None:
                continue
            flip = flip_of[a.rname]
            M = lens[a.rname]
            if flip:
                # flip alignment coords onto the flipped contig
                alen = a.qend - a.qstart
                pos = M - (a.pos + alen)
                rev = not a.rev
                qstart = a.read_len - a.qend
            else:
                pos, rev, qstart = a.pos, a.rev, a.qstart
            if rev:
                continue  # minority orientation: no cs meaning
            S0, seg, okv = decode[a.rname][flip]
            anchor = anchors.get(rid)
            if anchor is None or anchor not in "ACGT":
                continue
            ntr0 = alphabet.encode(anchor)[0]
            ccodes = alphabet.encode("".join(
                _COLOUR_TO_LETTER.get(ch, "N") for ch in colours))
            off = pos - qstart       # contig nt index of read nt 0
            t0 = max(0, -off, qstart)
            if off + t0 > M:
                continue
            # read nt at t0 by prefix XOR of its own colours
            ntr = ntr0
            bad = False
            for t in range(t0):
                c = int(ccodes[t])
                if c >= 4:
                    bad = True
                    break
                ntr ^= c
            if bad:
                continue
            d = int(ntr) ^ int(S0[off + t0])
            key = (int(seg[off + t0]), d)
            d_votes[a.rname][key] = d_votes[a.rname].get(key, 0) + 1
        batch_reads.clear()

    for rid, anchor, colours in reads:
        batch_reads.append((rid, colours))
        if len(batch_reads) == B:
            flush_d()
    flush_d()

    # emit: per segment apply the winning d; undecided segments -> N
    out = []
    seen = set()
    for n, _ in contigs:
        flip = flip_of[n]
        S0, seg, okv = decode[n][flip]
        votes = d_votes[n]
        best_d: dict[int, int] = {}
        best_c: dict[int, int] = {}
        for (sg, dd), cnt in votes.items():
            if cnt > best_c.get(sg, 0):
                best_c[sg], best_d[sg] = cnt, dd
        nt = np.full(len(S0), 4, np.uint8)
        for j in range(len(S0)):
            dd = best_d.get(int(seg[j]))
            if dd is not None and okv[j]:
                nt[j] = S0[j] ^ dd
        s = alphabet.decode(nt)
        canon = min(s, alphabet.revcomp(s))
        if canon in seen:
            continue
        seen.add(canon)
        out.append((n, s))
    with open(out_path, "w") as f:
        for n, s in out:
            f.write(f">{n} {len(s)} 0\n{s}\n")
    if p.verbose:
        print(f"[cs] {len(contigs)} colour contigs -> {len(out)} "
              f"nucleotide contigs", file=sys.stderr)
    return out_path
