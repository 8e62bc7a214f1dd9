"""abyss-sealer: close scaffold N-gaps with the Konnector engine.

Port of abyss_tpu/gap/sealer.py (Sealer/sealer.cc:55-100): for each
N-gap in the scaffolds, extract the flanking sequences and try to
connect them through filters built at multiple k values (largest k
first, like the `sealer_ks` sweep in bin/abyss-pe:855-861); on success,
splice the connecting sequence into the scaffold.  The filters and the
searches live on `device` ("cuda" by default).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..core import alphabet
from ..dbg import bloom_dbg
from ..dbg.params import AssemblyParams
from ..io import read_batches as io_read_batches
from . import konnector

GAP_RE = re.compile(r"N+")


@dataclass
class SealStats:
    gaps: int = 0
    closed: int = 0


def find_gaps(seq: str, flank: int):
    """Yield (start, end, left_flank, right_flank) for each N-run with
    adequate flanks."""
    for m in GAP_RE.finditer(seq):
        s, e = m.span()
        left = seq[max(0, s - flank):s]
        right = seq[e:e + flank]
        if "N" in left or "N" in right:
            continue
        yield s, e, left, right


def seal(scaffolds: list[tuple[str, str]], read_files, ks: list[int],
         bloom_bytes: int = 64 << 20, flank: int = 100,
         max_gap: int = 800, batch_size: int = 4096,
         max_read_len: int = 512, device="cuda",
         ) -> tuple[list[tuple[str, str]], SealStats]:
    """Close gaps in (name, seq) scaffolds. Returns (new scaffolds, stats).

    Bloom filters are built once per k (pass over the reads), largest k
    first; gaps unclosed at one k fall through to the next.
    """
    stats = SealStats()
    gaps = []  # (scaffold_idx, start, end, left, right)
    for si, (name, seq) in enumerate(scaffolds):
        for s, e, left, right in find_gaps(seq, flank):
            gaps.append([si, s, e, left, right, None])
            stats.gaps += 1

    for k in sorted(ks, reverse=True):
        open_gaps = [g for g in gaps if g[5] is None]
        if not open_gaps:
            break
        params = AssemblyParams(k=k, bloom_bytes=bloom_bytes,
                                batch_size=batch_size,
                                max_read_len=max_read_len)
        cbf = bloom_dbg.load_filter(
            io_read_batches(read_files, batch_size, max_read_len),
            params, device=device)
        # konnector expects (read1, read2-as-sequenced); our right flank
        # is already fragment-oriented, so pass its rc as "read2"
        pairs = [(g[3], alphabet.revcomp(g[4])) for g in open_gaps]
        results = konnector.connect_pairs(cbf, pairs, k, max_gap=max_gap)
        for g, r in zip(open_gaps, results):
            if r.reason == "CONNECTED":
                g[5] = r.seq
                stats.closed += 1

    out = []
    for si, (name, seq) in enumerate(scaffolds):
        my_gaps = sorted((g for g in gaps if g[0] == si and
                          g[5] is not None),
                         key=lambda g: g[1], reverse=True)
        new_seq = seq
        for _, s, e, left, right, merged in my_gaps:
            # merged = left + path + right; splice the path between flanks
            interior = merged[len(left):len(merged) - len(right)]
            new_seq = new_seq[:s] + interior + new_seq[e:]
        out.append((name, new_seq))
    return out, stats
