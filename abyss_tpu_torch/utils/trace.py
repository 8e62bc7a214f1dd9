"""One tracer for the whole port: spans and counters of an assembly.

    from abyss_tpu_torch.utils import trace

    trace.enable(True)
    pe.run(params)                      # one job
    records = trace.take()              # its spans and counts, cleared
    trace.span_seconds(records)         # {"pe.unitigs": 21.8, ...}
    trace.counter_totals(records)       # {"walk.lane_steps": ..., ...}

A span (`with trace.span(name, device=...)`) is a named interval with
its parent span and its job; a counter (`trace.count(name, n)`) adds n
to a named count where the work happens.  A job is one top-level
`pe.run` or `pe.stage_unitigs_1` call, or what a caller opens with
`trace.job()`.

Tracing is off by default.  Off, a span reads `time.perf_counter_ns`
when it opens and when it closes and does nothing else (its `seconds`
feed pe's `[wall]` log lines); `count` returns at once, and code that
feeds a counter from the device asks `enabled()` first.  On:

- every span is also a `torch.profiler.record_function` range named
  `abyss.<name>`, so under a profiler the spans lie on the same clock
  as the device's operations and an idle stretch of the card can be
  put down to the host work open over it;
- a `device=True` span synchronises the CUDA devices when it opens and
  when it closes, so it holds the device work its code started;
  host-only spans (parsing, writing, host loops) never synchronise.

Records stay in memory until `take()`.  Spans nest per thread.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Iterable, Iterator, NamedTuple

import torch

PREFIX = "abyss."


class SpanRecord(NamedTuple):
    name: str
    start_ns: int          # time.perf_counter_ns at open
    end_ns: int            # and at close
    id: int
    parent: int | None     # id of the span open around it
    job: int               # 0 outside any job

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class CountRecord(NamedTuple):
    name: str
    n: int
    span: int | None       # id of the span open where it was counted
    job: int


_on = False
_records: list = []
_ids = itertools.count(1)
_jobs = itertools.count(1)
_local = threading.local()


def enable(on: bool = True) -> None:
    """Turn tracing on or off (it starts off)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def take() -> list:
    """The records made since the last take, oldest first; clears them."""
    global _records
    out, _records = _records, []
    return out


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _job() -> int:
    return getattr(_local, "job", 0)


def _sync() -> None:
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class Span:
    """One timed interval; `seconds` is its length (so far, while open)."""

    __slots__ = ("name", "device", "start_ns", "end_ns", "id", "_range",
                 "_keep")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.device = device
        self.end_ns = None
        self._range = None
        self._keep = True

    def __enter__(self) -> "Span":
        if _on:
            if self.device:
                _sync()
            self.id = next(_ids)
            _stack().append(self.id)
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is None:
            self.end_ns = time.perf_counter_ns()
            return
        if self.device:
            _sync()
        self.end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        st = _stack()
        st.pop()
        if self._keep:
            _records.append(SpanRecord(self.name, self.start_ns, self.end_ns,
                                       self.id, st[-1] if st else None,
                                       _job()))

    def drop(self) -> None:
        """Record nothing for this span when it closes."""
        self._keep = False

    @property
    def seconds(self) -> float:
        end = self.end_ns if self.end_ns is not None \
            else time.perf_counter_ns()
        return (end - self.start_ns) * 1e-9


def span(name: str, device: bool = False) -> Span:
    """A span named `name`; device=True where its code runs device work
    (it then holds that work when tracing is on)."""
    return Span(name, device)


def count(name: str, n) -> None:
    """Add n to counter `name` (nothing when tracing is off)."""
    if not _on:
        return
    st = _stack()
    _records.append(CountRecord(name, int(n), st[-1] if st else None,
                                _job()))


@contextlib.contextmanager
def job():
    """Open a job unless one is open already (then a no-op), so the
    records of one assembly share a job id."""
    if _job():
        yield
        return
    _local.job = next(_jobs)
    try:
        yield
    finally:
        _local.job = 0


@contextlib.contextmanager
def recording():
    """Tracing on for the block: yields a list that receives the
    block's records when it ends.  Records pending before the block
    stay pending, and tracing is left on or off as it was."""
    global _records
    was, pending = _on, take()
    out: list = []
    enable(True)
    try:
        yield out
    finally:
        enable(was)
        out.extend(take())
        _records = pending


def each(name: str, items: Iterable) -> Iterator:
    """Yield `items`, each one's production inside its own span `name`,
    closed before the item is handed on: the consumer's time between
    items is never inside it."""
    it = iter(items)
    try:
        while True:
            with span(name) as s:
                try:
                    item = next(it)
                except StopIteration:
                    s.drop()
                    return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def span_seconds(records: Iterable) -> dict:
    """Seconds by span name, summed over the records."""
    out = defaultdict(float)
    for r in records:
        if isinstance(r, SpanRecord):
            out[r.name] += r.seconds
    return dict(out)


def self_seconds(records: Iterable) -> dict:
    """Seconds by span name net of the spans recorded inside them (a
    span's self time: its length less its children's)."""
    spans = [r for r in records if isinstance(r, SpanRecord)]
    out = defaultdict(float)
    for r in spans:
        out[r.name] += r.seconds
    names = {r.id: r.name for r in spans}
    for r in spans:
        if r.parent in names:
            out[names[r.parent]] -= r.seconds
    return dict(out)


def counter_totals(records: Iterable) -> dict:
    """Counts by counter name, summed over the records."""
    out = defaultdict(int)
    for r in records:
        if isinstance(r, CountRecord):
            out[r.name] += r.n
    return dict(out)
