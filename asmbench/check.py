"""The comparison that decides `correct`: each number the reference
gives (reference.py) against its limit from the traffic file, and the
jobs of the window against the first job's output.  A number passes
when it is at most its limit, or, where the limit is written
{"min": x}, at least x."""

from __future__ import annotations

import hashlib


def job_numbers(outputs: list[dict | None]) -> dict:
    """failed_jobs (raised) and fasta_differs (final FASTA not the first
    finished job's, byte for byte)."""
    done = [o for o in outputs if o is not None]
    first = hashlib.sha256(done[0]["final"]).hexdigest() if done else None
    return {
        "failed_jobs": len(outputs) - len(done),
        "fasta_differs": sum(hashlib.sha256(o["final"]).hexdigest() != first
                             for o in done),
    }


def compare(numbers: dict, limits: dict) -> list[tuple[str, float, str,
                                                       float]]:
    """(name, value, op, limit) for every number that has a limit, op
    "<=" or ">=".  A limit whose number was not read fails the run
    (value inf, or -inf under a minimum); a number without a limit is a
    reading only."""
    rows = []
    for name, limit in sorted(limits.items()):
        if isinstance(limit, dict):
            rows.append((name, numbers.get(name, float("-inf")), ">=",
                         limit["min"]))
        else:
            rows.append((name, numbers.get(name, float("inf")), "<=", limit))
    return rows


def ok(value: float, op: str, limit: float) -> bool:
    return value >= limit if op == ">=" else value <= limit


def passed(rows) -> bool:
    return all(ok(value, op, limit) for _, value, op, limit in rows)
