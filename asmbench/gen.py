"""The benchmark's inputs: a genome and paired reads, in NumPy alone.

Frozen copies, so that the yardstick stays put when the program moves:

- `genome_with_repeats` is `abyss_tpu_torch/sim.py:genome_with_repeats`
  (a uniform random genome with exact copies of one segment), with the
  alphabet written out here.
- `simulate_pairs` is `chip_smoke.py:simulate_reads` (a vectorised
  wgsim-style sampler: FR pairs, normal fragment lengths, substitution
  errors), returning code arrays instead of writing files.
- `write_fastq` is `chip_smoke.py:_write_fastq` with one join per file;
- `arrival_order` puts one sample's pairs in the order a run's seed
  draws.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
CODE = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    CODE[_ch] = _i
    CODE[_ch + 32] = _i


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII bases to codes A=0 C=1 G=2 T=3, anything else 4."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return ASCII[np.minimum(codes, 4)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis (4 stays 4)."""
    comp = np.where(codes < 4, 3 - codes.astype(np.int16), 4)
    return comp.astype(np.uint8)[..., ::-1]


def genome_with_repeats(length: int, seed: int, n_repeats: int,
                        repeat_len: int) -> np.ndarray:
    """Codes of a random genome with n_repeats exact copies of one
    repeat_len segment at random places (sim.genome_with_repeats)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=length, dtype=np.uint8).copy()
    if n_repeats > 1 and length > repeat_len * (n_repeats + 1):
        src = rng.integers(0, length - repeat_len)
        unit = codes[src:src + repeat_len].copy()
        for _ in range(n_repeats):
            dst = rng.integers(0, length - repeat_len)
            codes[dst:dst + repeat_len] = unit
    return codes


def simulate_pairs(genome: np.ndarray, n_pairs: int, read_len: int,
                   fragment_mean: float, fragment_sd: float,
                   error_rate: float, seed: int):
    """(r1, r2): uint8 [n_pairs, read_len] codes of FR pairs; read 1 from
    the forward strand at the fragment start, read 2 reverse-complemented
    from its end, each base substituted with probability error_rate."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    frag = np.clip(rng.normal(fragment_mean, fragment_sd, n_pairs),
                   read_len + 2, G).astype(np.int64)
    start = (rng.random(n_pairs) * (G - frag + 1)).astype(np.int64)
    pos = np.arange(read_len)[None, :]
    r1 = genome[start[:, None] + pos]
    r2 = revcomp_codes(genome[(start + frag - read_len)[:, None] + pos])
    r2 = np.ascontiguousarray(r2)
    for r in (r1, r2):
        errs = rng.random(r.shape) < error_rate
        r[errs] = (r[errs] + rng.integers(1, 4, int(errs.sum()))) % 4
    return r1, r2


def arrival_order(reads, seed: int):
    """The same pairs in the order `seed` draws: (r1, r2) permuted
    alike, so every seed carries the same work."""
    perm = np.random.default_rng(seed).permutation(len(reads[0]))
    return tuple(np.ascontiguousarray(r[perm]) for r in reads)


def write_fastq(path: str, reads: np.ndarray, mate: int) -> None:
    """Write reads (uint8 [n, L] codes) as FASTQ records sim_<i>/<mate>
    with quality 'I'."""
    n, L = reads.shape
    qual = b"I" * L
    rows = ASCII[np.minimum(reads, 4)]
    data = b"".join(b"@sim_%d/%d\n%s\n+\n%s\n" % (i, mate, row.tobytes(), qual)
                    for i, row in enumerate(rows))
    with open(path, "wb") as f:
        f.write(data)


def parse_fasta(data: bytes) -> list[tuple[str, bytes]]:
    """(header, sequence) of every record of FASTA text."""
    out = []
    for rec in data.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        out.append((head.rstrip(b"\r").decode(),
                    body.replace(b"\n", b"").replace(b"\r", b"")))
    return out
