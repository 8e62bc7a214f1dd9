"""SQLite run telemetry.

Reimplements DataBase/DB.{h,cc}: every tool can take a --db=FILE; counters
are collected in insertion order (InsOrderedMap) and flushed as rows
keyed by a run id, then exported as text/CSV (abyss-db-txt, db-csv.cc).
"""

from __future__ import annotations

import os
import socket
import sqlite3
import time
import uuid


SCHEMA = """
CREATE TABLE IF NOT EXISTS runs (
    run_id TEXT PRIMARY KEY,
    time_started TEXT,
    host TEXT,
    command TEXT
);
CREATE TABLE IF NOT EXISTS stats (
    run_id TEXT,
    tool TEXT,
    seq INTEGER,
    key TEXT,
    value TEXT
);
"""


class DB:
    """Per-run stat collector flushed to SQLite (DataBase/DB.h:31-60)."""

    def __init__(self, path: str, tool: str = "", command: str = ""):
        self.path = path
        self.tool = tool
        self.run_id = str(uuid.uuid4())[:8]
        self._pending: list[tuple[str, str]] = []
        conn = self._connect()
        with conn:
            conn.executescript(SCHEMA)
            conn.execute(
                "INSERT INTO runs VALUES (?, ?, ?, ?)",
                (self.run_id, time.strftime("%Y-%m-%d %H:%M:%S"),
                 socket.gethostname(), command))
        conn.close()

    def _connect(self):
        return sqlite3.connect(self.path)

    def add(self, key: str, value):
        """addToDb: record a counter in insertion order."""
        self._pending.append((key, str(value)))

    def flush(self):
        conn = self._connect()
        with conn:
            for i, (k, v) in enumerate(self._pending):
                conn.execute(
                    "INSERT INTO stats VALUES (?, ?, ?, ?, ?)",
                    (self.run_id, self.tool, i, k, v))
        conn.close()
        self._pending = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()


def open_db(path: str | None, tool: str, argv=None):
    """Per-tool `--db=FILE` support (reference: every tool's getopt has
    --db, DataBase/DB.h).  Returns a DB or a no-op recorder."""
    if not path:
        class _Null:
            def add(self, *a, **k):
                pass

            def flush(self):
                pass

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                pass
        return _Null()
    import sys
    cmd = " ".join(argv if argv is not None else sys.argv)
    return DB(path, tool=tool, command=cmd)


def export_text(path: str) -> str:
    """abyss-db-txt equivalent: dump all stats as tab-separated text."""
    conn = sqlite3.connect(path)
    rows = conn.execute(
        "SELECT s.run_id, s.tool, s.key, s.value FROM stats s "
        "ORDER BY s.run_id, s.seq").fetchall()
    conn.close()
    return "".join("\t".join(r) + "\n" for r in rows)


def export_csv(path: str) -> str:
    """abyss-db-csv equivalent."""
    conn = sqlite3.connect(path)
    rows = conn.execute(
        "SELECT s.run_id, s.tool, s.key, s.value FROM stats s "
        "ORDER BY s.run_id, s.seq").fetchall()
    conn.close()
    out = ["run_id,tool,key,value"]
    out += [",".join(r) for r in rows]
    return "\n".join(out) + "\n"
