"""Read -> contig mapper: batched k-mer seed-and-vote on the device.

Port of abyss_tpu/align/mapper.py, the replacement for the reference's
aligners (abyss-map's FM-index MUM search, Map/map.cc:33-75, and
KAligner's k-mer seed hash, KAligner/Aligner.h:25-50).  The index is a
sorted array of canonical k-mer hashes over the target contigs; each
read's seeds are looked up in it, and per-read (contig, strand,
diagonal) votes elect the alignment, replacing seed chaining.

Reads with ties between two different (contig, strand, diagonal) keys
are reported as multimapping (mapq 0), like abyss-map's unique-MUM rule.

The index lives on the aligner's device; hashes are int64 tensors with
the JAX package's uint64 bits (u64.py).  The vote is one function of
torch ops on that device (`_vote_kernel`); the seed chaining of
`align_batch` runs on the host, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device, u64
from ..core import alphabet
from ..dbg.hash_dbg import _trim_pad_columns
from ..ops import nthash
from ..ops.sort_join import join_rows
from ..utils import trace

DUP = 4            # max duplicate index hits examined per seed
DIAG_OFF = 1 << 20  # diagonal offset so keys stay positive


@dataclass
class KmerIndex:
    k: int
    hashes: torch.Tensor     # int64[N] canonical hashes, unsigned order
    contig: torch.Tensor     # int32[N]
    pos: torch.Tensor        # int32[N]
    is_fwd: torch.Tensor     # bool[N] canonical == forward hash at pos
    first_row: torch.Tensor  # int32[N] first row of each equal-hash run
    names: list
    lengths: list

    CHUNK = 1 << 18  # fixed shape of the index-hashing launches

    @property
    def device(self) -> torch.device:
        return self.hashes.device

    @staticmethod
    def build(contigs: list[tuple[str, str]], k: int,
              device="cuda") -> "KmerIndex":
        """Hash all contigs in fixed-shape [1, CHUNK] chunks of one
        concatenated code array (separator code 4 invalidates
        cross-contig windows) on `device`; the window -> (contig,
        offset) mapping and the stable sort of the hashes by unsigned
        order run on the host in numpy."""
        dev = resolve_device(device)
        C = KmerIndex.CHUNK
        keep = [(n, s) for n, s in contigs if len(s) >= k]
        if keep:
            parts = []
            starts = []  # global start of each contig's bases
            g = 0
            for n, s in keep:
                starts.append(g)
                parts.append(alphabet.encode(s))
                parts.append(np.full(1, 4, np.uint8))  # separator
                g += len(s) + 1
            big = np.concatenate(parts)
            starts = np.asarray(starts, np.int64)
            ends = starts + np.asarray([len(s) for _, s in keep],
                                       np.int64)
            hs_l, gpos_l, isf_l = [], [], []
            step = C - k + 1
            for lo in range(0, len(big), step):
                chunk = big[lo:lo + C]
                if len(chunk) < C:
                    chunk = np.concatenate(
                        [chunk, np.full(C - len(chunk), 4, np.uint8)])
                f, _, canon, valid = nthash.kmer_hashes(
                    torch.from_numpy(chunk[None]).to(dev), k)
                v = valid[0].cpu().numpy()
                idx = np.nonzero(v)[0]
                c = u64.to_numpy(canon[0])
                hs_l.append(c[idx])
                isf_l.append((u64.to_numpy(f[0]) == c)[idx])
                gpos_l.append(lo + idx)
            hs = np.concatenate(hs_l)
            gpos = np.concatenate(gpos_l)
            isf = np.concatenate(isf_l)
            cid = (np.searchsorted(starts, gpos, "right") - 1).astype(
                np.int32)
            # windows spanning a separator are already invalid, but a
            # window may start past its contig's end (inside a later
            # short gap): guard
            ok = gpos + k <= ends[cid]
            hs, gpos, isf, cid = hs[ok], gpos[ok], isf[ok], cid[ok]
            pos = (gpos - starts[cid]).astype(np.int32)
        else:
            hs = np.zeros(0, np.uint64)
            cid = pos = np.zeros(0, np.int32)
            isf = np.zeros(0, bool)
        order = np.argsort(hs, kind="stable")
        hs, cid, pos, isf = hs[order], cid[order], pos[order], isf[order]
        # pad to a power of two, as the JAX package does (its vote
        # program compiles per index length); the all-ones sentinel
        # sorts last and never equals a real hash
        P = max(1 << max(len(hs) - 1, 1).bit_length(), 1024)
        padn = P - len(hs)
        hs = np.concatenate(
            [hs, np.full(padn, np.uint64(0xFFFFFFFFFFFFFFFF))])
        cid = np.concatenate([cid, np.zeros(padn, np.int32)])
        pos = np.concatenate([pos, np.zeros(padn, np.int32)])
        isf = np.concatenate([isf, np.zeros(padn, bool)])
        # first row of each equal-hash run: the DUP probe window starts
        # there (duplicate k-mers = repeats; probing them all is how
        # multimapping ties are detected)
        rows = np.arange(len(hs), dtype=np.int32)
        runstart = np.concatenate([[True], hs[1:] != hs[:-1]])
        first = np.maximum.accumulate(np.where(runstart, rows, 0))
        # cid indexes the >=k subset: report names/lengths of that subset
        from ..convert import kmer_index_from_numpy
        return kmer_index_from_numpy(
            k, hs, cid, pos, isf, first,
            names=[n for n, s in contigs if len(s) >= k],
            lengths=[len(s) for _, s in contigs if len(s) >= k],
            device=dev)


@dataclass
class Alignment:
    """One read->contig alignment (the reference's SAMRecord payload)."""
    qname: str
    rname: str
    rev: bool
    pos: int        # 0-based target start of the aligned (seeded) segment
    qstart: int     # read coordinate of first seeded base
    qend: int       # read coordinate past last seeded base
    read_len: int
    score: int      # number of supporting k-mer seeds
    mapq: int
    rlen: int       # target contig length
    # explicit CIGAR for gapped (indel) alignments from seed chaining;
    # None = ungapped (emit derives clips + one M run)
    cigar: str | None = None

    @property
    def target_end(self) -> int:
        return self.pos + (self.qend - self.qstart)


def _vote_kernel(index: KmerIndex, codes: torch.Tensor, k: int):
    """Per-read best (contig, strand, diagonal) vote, in torch ops on the
    index's device.  codes: uint8 [B, L] on that device.

    Returns per read (tensors of [B]): best key, seed count, runner-up
    count, qstart, qend, runner-up key, its qstart and qend.

    The JAX program relies on its gathers clamping out-of-range indices;
    here each index is clamped explicitly, into the same range."""
    hashes, contig, pos = index.hashes, index.contig, index.pos
    is_fwd, first_row = index.is_fwd, index.first_row
    dev = hashes.device
    f, _, canon, valid = nthash.kmer_hashes(codes, k)
    read_fwd = f == canon
    B, W = canon.shape
    N = hashes.shape[0]

    # first matching index row (-1 on a miss), remapped to the first row
    # of its equal-hash run, where the DUP probes start.  A miss's probes
    # land on rows 0..DUP-2 and fail the equality test below
    hit_row = join_rows(hashes, canon.reshape(-1)).long()
    base = torch.where(hit_row >= 0,
                       first_row[hit_row.clamp(min=0)].long(),
                       -1).reshape(B, W)
    cand = base[None] + torch.arange(DUP, device=dev)[:, None, None]
    cand = cand.clamp(0, max(N - 1, 0))
    hit = (hashes[cand] == canon[None]) & valid[None] & (N > 0)

    c_contig = contig[cand].long()
    c_pos = pos[cand].long()
    c_fwd = is_fwd[cand]
    w = torch.arange(W, dtype=torch.int64, device=dev)[None, None, :]
    strand = (c_fwd != read_fwd[None]).long()
    diag = torch.where(strand == 0, c_pos - w, c_pos + w)
    key = (((c_contig << 1) | strand) << 22) + diag + DIAG_OFF
    key = torch.where(hit, key, -1)                        # [DUP, B, W]

    # vote: sort keys per read (signed: a miss is -1 and sorts first),
    # run-length encode, take the mode
    M = W * DUP
    flat = torch.sort(key.permute(1, 0, 2).reshape(B, M), dim=1).values
    start = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       flat[:, 1:] != flat[:, :-1]], dim=1)
    posm = torch.arange(M, device=dev)
    run_start = torch.cummax(torch.where(start, posm[None, :], -1),
                             dim=1).values
    ends = torch.cat([run_start[:, 1:] != run_start[:, :-1],
                      torch.ones((B, 1), dtype=torch.bool, device=dev)],
                     dim=1)
    run_len = torch.where(ends, posm[None, :] - run_start + 1, 0)
    run_len = torch.where(flat >= 0, run_len, 0)
    # argmax takes the first maximum in torch as in JAX: among tied runs,
    # the one with the smallest key
    best_i = torch.argmax(run_len, dim=1, keepdim=True)
    best_count = run_len.gather(1, best_i)[:, 0]
    best_key = flat.gather(1, best_i)[:, 0]
    # runner-up: best among runs with a different key (its key + span
    # feed the indel seed-chaining in align_batch)
    run_len2 = torch.where(flat == best_key[:, None], 0, run_len)
    second_i = torch.argmax(run_len2, dim=1, keepdim=True)
    second_count = run_len2.gather(1, second_i)[:, 0]
    second_key = flat.gather(1, second_i)[:, 0]

    # seed spans in read coordinates for both keys ([DUP, B, W])
    wb = w.expand(key.shape)

    def span(which):
        sel = (key == which[None, :, None]) & hit
        lo = torch.where(sel, wb, W).amin(dim=2).amin(dim=0)
        hi = torch.where(sel, wb, -1).amax(dim=2).amax(dim=0) + k
        return lo, hi

    qstart, qend = span(best_key)
    qstart2, qend2 = span(second_key)
    return (best_key, best_count, second_count, qstart, qend,
            second_key, qstart2, qend2)


MAX_CHAIN_INDEL = 64  # largest indel the two-diagonal chain bridges


def _chain_blocks(strand, diag1, qs1, qe1, diag2, qs2, qe2, k,
                  read_len):
    """Chain two seed blocks on parallel diagonals into one gapped
    alignment.  Returns (tstart, qstart, qend, cigar) or None when the
    blocks do not chain cleanly (overlapping or out of order)."""
    # order blocks by read coordinate
    if qs2 < qs1:
        (diag1, qs1, qe1), (diag2, qs2, qe2) = \
            (diag2, qs2, qe2), (diag1, qs1, qe1)
    if qs2 < qe1:
        # seed spans may overlap by up to a seed width at the indel
        # boundary (a chimeric window voting with either block); clip
        # the first block.  Bigger overlaps are genuinely ambiguous.
        if qe1 - qs2 > k or qs2 <= qs1:
            return None
        qe1 = qs2
    if strand == 0:
        t1, t2 = diag1 + qs1, diag2 + qs2
        tend1 = t1 + (qe1 - qs1)
        tgap = t2 - tend1
        b1, b2 = qe1 - qs1, qe2 - qs2
        lead, tail = qs1, read_len - qe2
    else:
        # reverse strand: later read coords map to earlier contig
        # coords; the contig-leftmost block is the read-rightmost
        t2 = diag2 - (qe2 - k)
        t1 = diag1 - (qe1 - k)
        tend2 = t2 + (qe2 - qs2)
        tgap = t1 - tend2
        b1, b2 = qe2 - qs2, qe1 - qs1
        lead, tail = read_len - qe2, qs1
        t1 = t2  # alignment starts at the contig-leftmost block
    qgap = qs2 - qe1
    if tgap < 0:
        return None
    cigar = []
    if lead:
        cigar.append(f"{lead}S")
    cigar.append(f"{b1}M")
    if qgap:
        cigar.append(f"{qgap}I")
    if tgap:
        cigar.append(f"{tgap}D")
    cigar.append(f"{b2}M")
    if tail:
        cigar.append(f"{tail}S")
    return t1, qs1, qe2, "".join(cigar)


class KmerAligner:
    """Batched aligner over a KmerIndex (the abyss-map / KAligner role),
    on `device` (default "cuda"; raises without a card unless "cpu")."""

    def __init__(self, contigs: list[tuple[str, str]], k: int = 32,
                 min_seeds: int = 2, device="cuda"):
        self.index = KmerIndex.build(contigs, k, device)
        self.k = k
        self.min_seeds = min_seeds

    def align_batch(self, codes: np.ndarray, lengths: np.ndarray,
                    ids: list[str]) -> list[Alignment | None]:
        """Align a padded [B, L] read batch; one best alignment per read
        (None if unmapped/ambiguous).  Only the first len(ids) results
        are returned.  The vote (upload, `_vote_kernel`, copy back) is
        the span `align.vote`, the per-read host loop `align.chain`."""
        with trace.span("align.vote", device=True):
            codes = _trim_pad_columns(np.asarray(codes), self.k)
            codes_t = torch.from_numpy(
                np.ascontiguousarray(codes, np.uint8)).to(self.index.device)
            (best_key, count, second, qstart, qend, second_key, qstart2,
             qend2) = (t.cpu().numpy() for t in _vote_kernel(
                 self.index, codes_t, self.k))
        with trace.span("align.chain"):
            return self._chain(ids, lengths, best_key, count, second,
                               qstart, qend, second_key, qstart2, qend2)

    def _chain(self, ids, lengths, best_key, count, second, qstart, qend,
               second_key, qstart2, qend2) -> list[Alignment | None]:
        """Each read's alignment from its vote: the seed chaining of an
        indel across two diagonals, the CIGAR and the mapq."""
        out = []
        for i, qname in enumerate(ids):
            if count[i] < self.min_seeds or best_key[i] < 0:
                out.append(None)
                continue
            key = int(best_key[i])
            diag = (key & ((1 << 22) - 1)) - DIAG_OFF
            strand = (key >> 22) & 1
            cidx = key >> 23
            qs, qe = int(qstart[i]), int(qend[i])

            # seed chaining across a nearby parallel diagonal of the
            # SAME contig+strand: an indel in the read splits its seeds
            # over two diagonals; chain them into one gapped alignment
            # with an explicit I/D CIGAR (KAligner chains seeds)
            chained = None
            k2 = int(second_key[i])
            if k2 >= 0 and second[i] >= self.min_seeds and \
                    (k2 >> 23) == cidx and ((k2 >> 22) & 1) == strand:
                ddiag = ((k2 & ((1 << 22) - 1)) -
                         (key & ((1 << 22) - 1)))
                if 0 < abs(ddiag) <= MAX_CHAIN_INDEL:
                    qs2, qe2 = int(qstart2[i]), int(qend2[i])
                    chained = _chain_blocks(
                        strand, diag, qs, qe, diag + ddiag, qs2, qe2,
                        self.k, int(lengths[i]))
            if chained is not None:
                tstart, qs, qe, cigar = chained
                score = int(count[i]) + int(second[i])
                mapq = min(60, 20 + 2 * score // 2)
            else:
                cigar = None
                score = int(count[i])
                if strand == 0:
                    tstart = diag + qs
                else:
                    # reverse: read k-mer at w maps to contig pos
                    # diag - w; leftmost contig coord comes from the
                    # *last* seed
                    tstart = diag - (qe - self.k)
                # multimapping rule (abyss-map unique-match analogue):
                # a runner-up location with close support zeroes mapq
                mapq = 0 if second[i] >= 0.9 * count[i] else \
                    min(60, 20 + 2 * (int(count[i]) - int(second[i])))
            out.append(Alignment(
                qname=qname, rname=self.index.names[cidx],
                rev=bool(strand), pos=int(tstart), qstart=qs, qend=qe,
                read_len=int(lengths[i]), score=score, mapq=mapq,
                rlen=self.index.lengths[cidx], cigar=cigar))
        return out
