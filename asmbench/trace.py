"""What a traced run (--trace 1) records, all from the benchmark's side:

- spans: wrappers set on functions of the program for the length of the
  window.  Each synchronises the card before it reads the clock, so a
  span holds the device work its call started, and each is also a
  `torch.profiler.record_function` range named `asmbench.<span>`;
- calls: the arguments of functions that launch kernels (no
  synchronisation), so a reader can compute the bytes a launch moves;
- the profiler's device operations over one whole job, reduced here to
  busy time (the union of their intervals), the idle gaps between them
  and the innermost span open during each gap.

Metrics (metrics/*.py) declare the spans and calls they read.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict

PREFIX = "asmbench."


class Recorder:
    """Spans and calls of a traced window, kept per job."""

    def __init__(self, sync):
        self._sync = sync
        self.jobs: list[dict] = []     # per job: span name -> seconds
        self.calls: list[dict] = []    # per job: call name -> [args]
        self._span = defaultdict(float)
        self._call = defaultdict(list)
        self._undo: list = []

    def _span_wrapper(self, name, fn):
        from torch.profiler import record_function

        def wrapper(*args, **kwargs):
            self._sync()
            t0 = time.perf_counter()
            try:
                with record_function(PREFIX + name):
                    return fn(*args, **kwargs)
            finally:
                self._sync()
                self._span[name] += time.perf_counter() - t0
        return wrapper

    def _call_wrapper(self, name, fn):
        def wrapper(*args, **kwargs):
            self._call[name].append(_describe(args))
            return fn(*args, **kwargs)
        return wrapper

    def install(self, spans: dict, calls: dict) -> None:
        """spans, calls: name -> (module, attribute)."""
        for table, make in ((spans, self._span_wrapper),
                            (calls, self._call_wrapper)):
            for name, (modname, attr) in sorted(table.items()):
                mod = importlib.import_module(modname)
                orig = getattr(mod, attr)
                setattr(mod, attr, make(name, orig))
                self._undo.append((mod, attr, orig))

    def remove(self) -> None:
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo = []

    @contextlib.contextmanager
    def job(self):
        from torch.profiler import record_function
        self._span = defaultdict(float)
        self._call = defaultdict(list)
        try:
            with record_function(PREFIX + "job"):
                yield
        finally:
            self.jobs.append(dict(self._span))
            self.calls.append(dict(self._call))


def _describe(args) -> tuple:
    """Shapes of tensor arguments and the values of plain ones."""
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            out.append(tuple(shape))
        elif a is None or isinstance(a, (bool, int, float, str)):
            out.append(a)
        else:
            out.append(type(a).__name__)
    return tuple(out)


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


class Profile:
    """One profiled job: device operations and the spans open on the
    host, as (name, start_s, end_s) on the profiler's clock."""

    def __init__(self, device_ops, spans, window):
        self.device_ops = device_ops
        self.spans = spans
        self.window = window      # (start_s, end_s) of the job

    @classmethod
    def from_profiler(cls, prof) -> "Profile":
        from torch.autograd import DeviceType
        ops, spans, window = [], [], None
        for e in prof.events():
            name = e.name
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == DeviceType.CUDA:
                if not name.startswith(PREFIX):
                    ops.append((name, s, t))
            elif name == PREFIX + "job":
                window = (s, t)
            elif name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], s, t))
        return cls(ops, spans, window)

    def clipped_ops(self):
        lo, hi = self.window
        return [(n, max(s, lo), min(t, hi)) for n, s, t in self.device_ops
                if t > lo and s < hi]

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_seconds([(s, t) for _, s, t in self.clipped_ops()])

    def kernel_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts
        (summed, not merged: one kernel runs at a time on the stream)."""
        return sum(t - s for n, s, t in self.clipped_ops() if match(n))

    def top_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for name, s, t in self.clipped_ops():
            tot[name] += t - s
        return sorted(([k[:200], v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_by_span(self, n: int = 10) -> list:
        """Idle seconds summed by the innermost span open at each gap's
        middle ("job" where none is)."""
        lo, hi = self.window
        gaps = idle_gaps([(s, t) for _, s, t in self.clipped_ops()], lo, hi)
        tot = defaultdict(float)
        for gs, ge in gaps:
            mid = (gs + ge) / 2
            inner = None
            for name, s, t in self.spans:
                if s <= mid < t and (inner is None or s >= inner[1]):
                    inner = (name, s)
            tot[inner[0] if inner else "job"] += ge - gs
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]
