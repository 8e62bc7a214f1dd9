"""Leveled logging + phase timers.

Reimplements Common/Log.h (`logger(level)`) and Common/Timer.h (RAII
wall-time-per-phase logging at verbosity >= 2) from the reference.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager

VERBOSITY = 0


def set_verbosity(level: int):
    global VERBOSITY
    VERBOSITY = level


def logger(level: int, msg: str):
    """Print msg when the global verbosity is >= level (Common/Log.h:6)."""
    if VERBOSITY >= level:
        print(msg, file=sys.stderr)


@contextmanager
def timer(name: str, level: int = 2):
    """Phase timer: logs `name: <seconds>s` at exit (Common/Timer.cpp:7-18)."""
    t0 = time.time()
    try:
        yield
    finally:
        logger(level, f"{name}: {time.time() - t0:.2f}s")
