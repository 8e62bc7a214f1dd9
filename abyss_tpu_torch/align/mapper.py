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
the JAX package's uint64 bits (u64.py).  The vote (`_vote_kernel`) and
each read's alignment from it (`_decide`: the seed chaining of an indel
across two diagonals, the target start, the mapq) are torch ops over the
batch on that device; the host gets one int32 block a batch
(`align_columns`), which `fixmate.fixmate_columns` pairs as it stands
and `align_batch` turns into Alignment objects.
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
DIAG_MASK = (1 << 22) - 1  # the diagonal's bits of a vote key

# rows of the int32 block `_decide` returns, one column a read: whether
# the read maps, the contig's index, the strand, the target start, the
# seeded read span, score and mapq; whether the two-diagonal indel chain
# engaged, and for chained reads the CIGAR's parts (lead clip, first
# block, insertion, deletion, second block, tail clip; 0 otherwise)
FIELDS = ("mapped", "contig", "rev", "pos", "qstart", "qend", "score",
          "mapq", "chained", "lead", "b1", "qgap", "tgap", "b2", "tail")
(MAPPED, CONTIG, REV, POS, QSTART, QEND, SCORE, MAPQ, CHAINED, LEAD, B1,
 QGAP, TGAP, B2, TAIL) = range(len(FIELDS))


def _decide(vote, lengths: torch.Tensor, k: int, min_seeds: int):
    """Each read's alignment from its vote, as torch ops over the batch
    on the vote's device: the seed chaining of an indel across two
    diagonals, the target start and the mapq.  vote: `_vote_kernel`'s
    eight [B] tensors; lengths: int64 [B] read lengths.  Returns the
    int32 [len(FIELDS), B] block (all zeros for an unmapped read)."""
    best_key, count, second, qs, qe, key2, qs2, qe2 = vote
    mapped = (count >= min_seeds) & (best_key >= 0)
    diag = (best_key & DIAG_MASK) - DIAG_OFF
    strand = (best_key >> 22) & 1
    cidx = best_key >> 23
    fwd = strand == 0

    # seed chaining across a nearby parallel diagonal of the SAME
    # contig+strand: an indel in the read splits its seeds over two
    # diagonals; chain them into one gapped alignment with an explicit
    # I/D CIGAR (KAligner chains seeds)
    ddiag = (key2 & DIAG_MASK) - (best_key & DIAG_MASK)
    chained = (mapped & (key2 >= 0) & (second >= min_seeds)
               & ((key2 >> 23) == cidx) & (((key2 >> 22) & 1) == strand)
               & (ddiag != 0) & (ddiag.abs() <= MAX_CHAIN_INDEL))
    # order the two blocks by read coordinate: block a first, then b
    swap = qs2 < qs
    d_a = torch.where(swap, diag + ddiag, diag)
    d_b = torch.where(swap, diag, diag + ddiag)
    s_a, s_b = torch.where(swap, qs2, qs), torch.where(swap, qs, qs2)
    e_a, e_b = torch.where(swap, qe2, qe), torch.where(swap, qe, qe2)
    # seed spans may overlap by up to a seed width at the indel boundary
    # (a chimeric window voting with either block): clip the first
    # block.  Bigger overlaps are genuinely ambiguous
    over = s_b < e_a
    chained &= ~over | ((e_a - s_b <= k) & (s_b > s_a))
    e_a = torch.where(over, s_b, e_a)
    len_a, len_b = e_a - s_a, e_b - s_b
    # forward: block a lies first on the contig too.  Reverse: later
    # read coords map to earlier contig coords; the contig-leftmost
    # block is the read-rightmost, and the alignment starts there
    t_a = torch.where(fwd, d_a + s_a, d_a - (e_a - k))
    t_b = torch.where(fwd, d_b + s_b, d_b - (e_b - k))
    tgap = torch.where(fwd, t_b - (t_a + len_a), t_a - (t_b + len_b))
    chained &= tgap >= 0
    c_pos = torch.where(fwd, t_a, t_b)
    b1, b2 = torch.where(fwd, len_a, len_b), torch.where(fwd, len_b, len_a)
    lead = torch.where(fwd, s_a, lengths - e_b)
    tail = torch.where(fwd, lengths - e_b, s_a)
    c_score = count + second
    c_mapq = (20 + 2 * c_score // 2).clamp(max=60)

    # ungapped: a reverse read's k-mer at w maps to contig pos diag - w,
    # so the leftmost contig coord comes from the *last* seed
    u_pos = torch.where(fwd, diag + qs, diag - (qe - k))
    # multimapping rule (abyss-map unique-match analogue): a runner-up
    # location with close support zeroes mapq (float64, as on the host)
    multi = second.double() >= 0.9 * count.double()
    u_mapq = torch.where(multi, 0, (20 + 2 * (count - second)).clamp(max=60))

    def ch(x, y):
        return torch.where(chained, x, y)

    zero = torch.zeros_like(count)
    cols = [mapped.long(), cidx, strand, ch(c_pos, u_pos), ch(s_a, qs),
            ch(e_b, qe), ch(c_score, count), ch(c_mapq, u_mapq),
            chained.long(), ch(lead, zero), ch(b1, zero),
            ch(s_b - e_a, zero), ch(tgap, zero), ch(b2, zero),
            ch(tail, zero)]
    return torch.where(mapped, torch.stack(cols), 0).to(torch.int32)


def _cigar(lead, b1, qgap, tgap, b2, tail) -> str:
    """The CIGAR of a read chained over two blocks."""
    return "".join((f"{lead}S" if lead else "", f"{b1}M",
                    f"{qgap}I" if qgap else "", f"{tgap}D" if tgap else "",
                    f"{b2}M", f"{tail}S" if tail else ""))


def _alignments(cols: np.ndarray, ids: list[str], lengths,
               names: list, rlens: list) -> list[Alignment | None]:
    """The list form of `_decide`'s columns: each read's Alignment, None
    where it does not map.  names and rlens are the index's."""
    out: list[Alignment | None] = [None] * len(ids)
    m = np.flatnonzero(cols[MAPPED])
    for i, (_, c, rev, pos, qs, qe, score, mapq, chained, *parts) in zip(
            m.tolist(), cols[:, m].T.tolist()):
        out[i] = Alignment(
            qname=ids[i], rname=names[c], rev=bool(rev), pos=pos,
            qstart=qs, qend=qe, read_len=int(lengths[i]), score=score,
            mapq=mapq, rlen=rlens[c],
            cigar=_cigar(*parts) if chained else None)
    return out


class KmerAligner:
    """Batched aligner over a KmerIndex (the abyss-map / KAligner role),
    on `device` (default "cuda"; raises without a card unless "cpu")."""

    def __init__(self, contigs: list[tuple[str, str]], k: int = 32,
                 min_seeds: int = 2, device="cuda"):
        self.index = KmerIndex.build(contigs, k, device)
        self.k = k
        self.min_seeds = min_seeds

    def align_columns(self, codes: np.ndarray, lengths: np.ndarray,
                      n: int) -> np.ndarray:
        """The first n reads of a padded [B, L] batch as `_decide`'s
        int32 [len(FIELDS), n] block: the upload, `_vote_kernel`, the
        decision and one copy down, the span `align.vote`.  With tracing
        on it counts `align.mapped` and `align.chained` (reads whose
        indel chain engaged)."""
        with trace.span("align.vote", device=True):
            codes = _trim_pad_columns(np.asarray(codes), self.k)
            dev = self.index.device
            codes_t = torch.from_numpy(
                np.ascontiguousarray(codes, np.uint8)).to(dev)
            vote = [t[:n] for t in _vote_kernel(self.index, codes_t, self.k)]
            lens = torch.from_numpy(
                np.asarray(lengths[:n], np.int64)).to(dev)
            cols = _decide(vote, lens, self.k, self.min_seeds).cpu().numpy()
        if trace.enabled():
            trace.count("align.mapped", cols[MAPPED].sum())
            trace.count("align.chained", cols[CHAINED].sum())
        return cols

    def align_batch(self, codes: np.ndarray, lengths: np.ndarray,
                    ids: list[str]) -> list[Alignment | None]:
        """Align a padded [B, L] read batch; one best alignment per read
        (None if unmapped/ambiguous).  Only the first len(ids) results
        are returned: `align_columns` in the list form."""
        cols = self.align_columns(codes, lengths, len(ids))
        return _alignments(cols, ids, lengths, self.index.names,
                           self.index.lengths)
