"""Crash backtraces + memory telemetry.

Reference: Common/SignalHandler.cpp installs SIGSEGV/SIGBUS backtrace
printers; Common/MemoryUtil.h reads the process RSS for the hash-load
progress messages (Assembly/DBG.h:267-274).
"""

from __future__ import annotations

import os


def signal_init() -> None:
    """Install fault backtraces (SignalHandler::signalInit parity):
    SIGSEGV/SIGBUS/SIGABRT dump Python tracebacks of all threads."""
    import faulthandler
    faulthandler.enable(all_threads=True)


def memory_usage_bytes() -> int:
    """Current RSS in bytes (MemoryUtil getMemoryUsage parity)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource
            return resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:
            return 0


def format_bytes(n: int) -> str:
    for unit in ("B", "kB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"
