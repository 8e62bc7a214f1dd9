"""Integer histogram + assembly contiguity statistics.

Reimplements the reference's Common/Histogram.h: median/percentiles,
weighted percentiles (N50/N75/N25), E-size (expectedValue), first local
minimum (drives the coverage-threshold heuristic,
Assembly/CoverageAlgorithm.h), trimLow, and the contiguity stats table
printed by abyss-fac (Histogram.h:320-376, DataLayer/fac.cc).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Iterable


@dataclass
class Histogram:
    counts: Counter = field(default_factory=Counter)

    @staticmethod
    def of(values: Iterable[int]) -> "Histogram":
        h = Histogram()
        for v in values:
            h.insert(int(v))
        return h

    def insert(self, value: int, count: int = 1):
        self.counts[value] += count

    def __len__(self):
        return len(self.counts)

    @property
    def empty(self) -> bool:
        return not self.counts

    def size(self) -> int:
        """Number of samples."""
        return sum(self.counts.values())

    def sum(self) -> int:
        return sum(k * v for k, v in self.counts.items())

    def minimum(self) -> int:
        return min(self.counts) if self.counts else 0

    def maximum(self) -> int:
        return max(self.counts) if self.counts else 0

    def count(self, lo: int, hi: int | None = None) -> int:
        """Number of samples in [lo, hi]."""
        hi = hi if hi is not None else max(self.counts, default=0)
        return sum(v for k, v in self.counts.items() if lo <= k <= hi)

    def percentile(self, p: float) -> int:
        """Smallest value x such that #samples <= x is >= p * total."""
        n = int(p * self.size())
        total = 0
        for k in sorted(self.counts):
            total += self.counts[k]
            if total > n:
                return k
        return self.maximum()

    def median(self) -> int:
        return self.percentile(0.5)

    def arg_min(self, x: int) -> int:
        """Smallest value v where the partial weighted sum reaches x
        (Histogram.h:156-165)."""
        total = 0
        for k in sorted(self.counts):
            total += k * self.counts[k]
            if total >= x:
                return k
        return self.maximum()

    def weighted_percentile(self, p: float) -> int:
        import math
        return self.arg_min(math.ceil(p * self.sum()))

    def n50(self) -> int:
        return self.weighted_percentile(0.5)

    def expected_value(self) -> float:
        """E-size: expected contig size of a random base
        (Histogram.h:174-185)."""
        acc = self.sum()
        if not acc:
            return 0.0
        return sum(k * k * v for k, v in self.counts.items()) / acc

    def first_local_minimum(self) -> int:
        """First local minimum with smoothing 4 (Histogram.h:190-208);
        0 if none."""
        smoothing = 4
        if self.empty:
            return 0
        keys = sorted(self.counts)
        min_key = keys[0]
        min_val = self.counts[min_key]
        count = 0
        for k in keys:
            v = self.counts[k]
            if v <= min_val:
                min_key, min_val = k, v
                count = 0
            else:
                count += 1
                if count >= smoothing:
                    break
        if min_key == self.maximum():
            return 0
        return min_key

    def trim_low(self, threshold: int) -> "Histogram":
        h = Histogram()
        for k, v in self.counts.items():
            if k >= threshold:
                h.counts[k] = v
        return h

    def trim_fraction(self, fraction: float) -> "Histogram":
        """Remove the fraction of samples with the lowest values
        (Histogram::trimFraction, used by the coverage model)."""
        cut = fraction * self.sum()
        total = 0
        h = Histogram()
        for k in sorted(self.counts):
            total += k * self.counts[k]
            if total > cut:
                h.counts[k] = self.counts[k]
        return h

    def remove_noise(self) -> "Histogram":
        """Drop isolated samples (h[x-1] == 0 and h[x+1] == 0),
        Histogram.h:220-236."""
        h = Histogram()
        if len(self.counts) <= 1:
            h.counts = Counter(self.counts)
            return h
        for k, v in self.counts.items():
            if self.counts.get(k - 1, 0) or self.counts.get(k + 1, 0):
                h.counts[k] = v
        if not h.counts:
            h.counts = Counter(self.counts)
        return h

    def to_text(self) -> str:
        """The `.hist` file format: "<value>\t<count>" lines."""
        return "".join(f"{k}\t{self.counts[k]}\n" for k in sorted(self.counts))

    @staticmethod
    def from_text(text: str) -> "Histogram":
        h = Histogram()
        for line in text.splitlines():
            if line.strip():
                k, v = line.split()
                h.counts[int(k)] += int(v)
        return h


def _to_eng(x) -> str:
    """Reference's toEng prints plain integers below 10^7 and engineering
    notation above; we keep plain integers (fac -t gives the same)."""
    if isinstance(x, float):
        return str(int(x))
    return str(x)


STAT_COLUMNS = ["n", "n:{min}", "L50", "min", "N75", "N50", "N25", "E-size",
                "max", "sum", "name"]


def contiguity_stats(lengths: Iterable[int], min_size: int = 500,
                     exp_size: int = 0, name: str = "") -> dict:
    """abyss-fac statistics for a set of sequence lengths
    (printContiguityStats, Histogram.h:342-376)."""
    h0 = Histogram.of(lengths)
    h = h0.trim_low(min_size)
    n50 = h.n50()
    row = {
        "n": h0.size(),
        f"n:{min_size}": h.size(),
        "L50": h.count(n50, None),
        "min": h.minimum(),
        "N75": h.weighted_percentile(1 - 0.75),
        "N50": n50,
        "N25": h.weighted_percentile(1 - 0.25),
        "E-size": int(h.expected_value()),
        "max": h.maximum(),
        "sum": h.sum(),
        "name": name,
    }
    if exp_size > 0:
        s = h.sum()
        ng50 = h.minimum() if s < exp_size // 2 else h.arg_min(s - exp_size // 2)
        row["NG50"] = ng50
        row["LG50"] = h.count(ng50, None)
    return row


def format_stats_table(rows: list[dict], sep: str = "\t") -> str:
    """Tab-separated table in the reference's column order."""
    if not rows:
        return ""
    min_key = next(k for k in rows[0] if k.startswith("n:"))
    cols = ["n", min_key, "L50"]
    if "NG50" in rows[0]:
        cols += ["LG50", "NG50"]
    cols += ["min", "N75", "N50", "N25", "E-size", "max", "sum", "name"]
    lines = [sep.join(cols)]
    for r in rows:
        lines.append(sep.join(_to_eng(r.get(c, "")) for c in cols))
    return "\n".join(lines) + "\n"
