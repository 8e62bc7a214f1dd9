"""The plain reference: exact k-mer counts of the reads and the genome,
joined with the k-mers of the program's FASTA output.

Plain PyTorch on whatever device it is given, imports nothing of the
program, and takes nothing the program made but the FASTA it wrote.  A
k-mer is held exactly, as ceil(k / 32) words of 2 bits a base; its
canonical form is the lesser of it and its reverse complement in the
lexicographic order of the words (any fixed order gives one
representative a pair).  Counting is a sort of all keys and a run-length
count, as a textbook k-mer counter does.

From the join, `unitig_numbers` and `scaffold_numbers` give the numbers
that decide `correct` (check.py, against the traffic file's limits),
and one reading without a limit:

- cov_mismatch: unitigs whose header coverage (ABySS's `<id> <length>
  <coverage>`, the sum of the multiplicities of its k-mers, each capped
  at COVERAGE_MAX as Assembly/VertexData.h caps it) differs from the sum
  the reference counts in the reads;
- unsolid_kmers: unitig k-mers seen fewer than kc times in the reads
  (every k-mer of the graph has to be solid);
- genome_miss: the share of the genome's k-mer positions whose k-mer is
  in no unitig;
- scaffold_novel_kmers (a reading): scaffold k-mers (windows without
  N) found neither in the genome nor in any read;
- scaffold_miss: the share of the genome's k-mer positions whose k-mer
  is in no scaffold;
- scaffold_ng50_kbp: the scaffolds' NG50 against the genome's length
  (contiguity.py), which falls where the stages that join contigs into
  scaffolds leave them apart; scaffold_miss cannot see that, since
  unjoined contigs still cover the genome.
"""

from __future__ import annotations

import numpy as np
import torch

from .contiguity import ng50

COVERAGE_MAX = 32767  # Assembly/VertexData.h:33
WORD = 32             # bases a 64-bit word holds


def flat_codes(seqs: list[np.ndarray]) -> np.ndarray:
    """One code array of the sequences, each followed by a 4."""
    parts = []
    for s in seqs:
        parts.append(np.asarray(s, np.uint8))
        parts.append(np.full(1, 4, np.uint8))
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def rows_flat(rows: np.ndarray) -> np.ndarray:
    """Rows of equal length [n, L] as one array, each followed by a 4."""
    n, L = rows.shape
    out = np.full((n, L + 1), 4, np.uint8)
    out[:, :L] = rows
    return out.reshape(-1)


def _pack(c: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """word[p] = codes c[p:p+width] packed 2 bits a base, first base
    highest, for p < n."""
    acc = torch.zeros(n, dtype=torch.int64, device=c.device)
    for b in range(width):
        acc |= (c[b:b + n] & 3) << (2 * (width - 1 - b))
    return acc


def kmer_keys(codes: np.ndarray, k: int, device) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """(keys int64 [M, ceil(k/32)], starts int64 [M]): the canonical
    k-mers of every window of `codes` that holds no code 4, in order."""
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device).to(
        torch.int64)
    T = c.shape[0]
    nw = -(-k // WORD)
    if T < k:
        return (torch.zeros((0, nw), dtype=torch.int64, device=device),
                torch.zeros(0, dtype=torch.int64, device=device))
    n = T - k + 1
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                     torch.cumsum((c >= 4).to(torch.int64), 0)])
    starts = torch.nonzero(bad[k:k + n] == bad[:n]).flatten()
    rc = torch.where(c < 4, 3 - c, c).flip(0)
    widths = [WORD] * (nw - 1) + [k - WORD * (nw - 1)]
    fwd, rev = [], []
    for j, w in enumerate(widths):
        off = WORD * j
        m = T - off - w + 1
        fwd.append(_pack(c[off:], w, m)[starts])
        # the reverse complement of window i is window T-k-i of rc
        rev.append(_pack(rc[off:], w, m)[T - k - starts])
    lt = torch.zeros_like(starts, dtype=torch.bool)
    eq = torch.ones_like(lt)
    for f, r in zip(fwd, rev):
        lt |= eq & (f < r)
        eq &= f == r
    take = lt | eq
    keys = torch.stack([torch.where(take, f, r) for f, r in zip(fwd, rev)],
                       dim=1)
    return keys, starts


def join_counts(sets: list[torch.Tensor]) -> list[torch.Tensor]:
    """For each row of sets[1:], how many rows of each set hold its key:
    int64 [M_i, len(sets)] a set (sets[0], the largest, is only
    counted)."""
    dev = sets[0].device
    ns = len(sets)
    keys = torch.cat(sets)
    tag = torch.cat([torch.full((s.shape[0],), i, dtype=torch.int64,
                                device=dev) for i, s in enumerate(sets)])
    order = torch.arange(keys.shape[0], device=dev)
    # lexicographic order: stable sorts from the last word to the first
    for j in range(keys.shape[1] - 1, -1, -1):
        _, idx = torch.sort(keys[order, j], stable=True)
        order = order[idx]
    sk = keys[order]
    new = torch.ones(sk.shape[0], dtype=torch.bool, device=dev)
    if sk.shape[0] > 1:
        new[1:] = (sk[1:] != sk[:-1]).any(dim=1)
    del sk
    gid = torch.cumsum(new.to(torch.int64), 0) - 1
    ngroups = int(gid[-1]) + 1 if gid.numel() else 0
    stag = tag[order]
    table = torch.bincount(gid * ns + stag,
                           minlength=ngroups * ns).view(ngroups, ns)
    row_gid = torch.empty_like(gid)
    row_gid[order] = gid
    out, lo = [], sets[0].shape[0]
    for s in sets[1:]:
        out.append(table[row_gid[lo:lo + s.shape[0]]])
        lo += s.shape[0]
    return out


class Reference:
    """The reads' and the genome's k-mers, counted once a run."""

    def __init__(self, reads: list[np.ndarray], genome: np.ndarray, k: int,
                 device):
        self.k = k
        self.device = device
        self.read_keys = torch.cat([kmer_keys(rows_flat(r), k, device)[0]
                                    for r in reads])
        self.genome_keys, _ = kmer_keys(flat_codes([genome]), k, device)
        self.genome_len = len(genome)

    def _seq_keys(self, seqs: list[bytes]):
        from .gen import encode
        codes = [encode(s) for s in seqs]
        lens = np.array([len(s) + 1 for s in codes], np.int64)
        offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)[:-1]])
                                   ).to(self.device)
        keys, starts = kmer_keys(flat_codes(codes), self.k, self.device)
        # the record each window lies in
        return keys, torch.searchsorted(offsets, starts, right=True) - 1

    def unitig_numbers(self, records: list[tuple[str, bytes]], kc: int
                       ) -> dict:
        """cov_mismatch, unsolid_kmers and genome_miss of unitigs
        (records of `<id> <length> <coverage> ...` headers)."""
        keys, rec = self._seq_keys([s for _, s in records])
        in_reads, in_genome = join_counts(
            [self.read_keys, keys, self.genome_keys])
        nrec = len(records)
        cnt = in_reads[:, 0].clamp(max=COVERAGE_MAX)
        sums = torch.zeros(nrec, dtype=torch.int64, device=self.device)
        sums.index_add_(0, rec, cnt)
        stated = torch.tensor([int(h.split()[2]) for h, _ in records],
                              dtype=torch.int64, device=self.device)
        return {
            "cov_mismatch": int((sums != stated).sum()),
            "unsolid_kmers": int((in_reads[:, 0] < kc).sum()),
            "genome_miss": _share(in_genome[:, 1] == 0),
        }

    def scaffold_numbers(self, records: list[tuple[str, bytes]]) -> dict:
        """scaffold_novel_kmers, scaffold_miss and scaffold_ng50_kbp of
        scaffolds."""
        keys, _ = self._seq_keys([s for _, s in records])
        in_scaf, in_genome = join_counts(
            [self.read_keys, keys, self.genome_keys])
        novel = (in_scaf[:, 0] == 0) & (in_scaf[:, 2] == 0)
        return {
            "scaffold_novel_kmers": int(novel.sum()),
            "scaffold_miss": _share(in_genome[:, 1] == 0),
            "scaffold_ng50_kbp": ng50([len(q) for _, q in records],
                                      self.genome_len) / 1e3,
        }


def _share(mask: torch.Tensor) -> float:
    n = mask.numel()
    return float(mask.sum()) / n if n else 1.0
