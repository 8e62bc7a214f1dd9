"""Leveled logging.

Reimplements Common/Log.h (`logger(level)`) from the reference; the
role of Common/Timer.h is utils/trace's spans.
"""

from __future__ import annotations

import sys

VERBOSITY = 0


def set_verbosity(level: int):
    global VERBOSITY
    VERBOSITY = level


def logger(level: int, msg: str):
    """Print msg when the global verbosity is >= level (Common/Log.h:6)."""
    if VERBOSITY >= level:
        print(msg, file=sys.stderr)

