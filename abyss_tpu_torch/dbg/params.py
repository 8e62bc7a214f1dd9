"""Assembly parameters (the reference's AssemblyParams,
BloomDBG/AssemblyParams.h:16-92, plus extension knobs)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AssemblyParams:
    k: int = 25
    num_hashes: int = 4          # -H, default 4 (AssemblyParams.h:79)
    min_cov: int = 2             # --kc, counting-filter threshold (ibid.)
    trim: int | None = None      # -t; defaults to k (bloom-dbg.cc:323-324)
    fp_trim: int = 5             # false-positive lookahead (bloom-dbg.h:661)
    fp_look_ahead: int = 5       # blunt-end lookahead (bloom-dbg.h:501)
    bloom_bytes: int = 64 << 20  # -b total Bloom memory budget
    # solid-kmer structure: "sorted" = exact sorted-table counter (fast on
    # device: sort-based, no scatter); "bloom" = counting Bloom filter
    # (reference-parity memory behaviour for huge genomes)
    filter_mode: str = "sorted"
    q: int = 0                   # quality trim threshold
    batch_size: int = 4096       # reads per device batch
    max_read_len: int = 512
    # extension engine shape knobs (static; trade FLOPs for fidelity)
    chunk: int = 1024            # bases extended per device super-step
    chunk_max: int = 1 << 15     # super-step budget cap (doubles per chunk)
    # initial seeds extended per batch round: at genome scale every read
    # of a fresh batch is eligible at once, and uncapped seeding walks
    # the same megabase unitig from thousands of lanes (round-4 DNF);
    # the cap grows 4x per round while walks stay short, so shattered
    # graphs still drain in a few rounds
    seeds_per_round: int = 256
    lookahead_width: int = 16    # BFS frontier cap in branch resolution
    max_contig_len: int = 20_000_000
    verbose: int = 0
    # checkpoint/resume (BloomDBG/Checkpoint.h): save every N reads in
    # pass 2 (0 = disabled)
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    # per-read trace TSV path (-T/--read-log, bloom-dbg.h:186-334)
    read_log: str | None = None

    def __post_init__(self):
        if self.trim is None:
            self.trim = self.k

    @property
    def trim_len(self) -> int:
        return self.trim if self.trim is not None else self.k
