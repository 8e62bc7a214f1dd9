"""Native components of the port, built on demand.

Shared libraries go to the package's own build directory
(`abyss_tpu_torch/_build/`, listed in .gitignore), named by a hash of
their sources and compiler command, so an edited source or flag builds
a new library and an unchanged one is reused.  The JAX package's loader
writes its libraries beside its own sources; the port never calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(__file__)
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}


def build_library(name: str, cmd: list[str], sources: list[str],
                  deps: list[str] = (), libs: list[str] = ()) -> str:
    """Compile `sources` with `cmd` (compiler and flags, no -o) into
    BUILD_DIR/lib<name>-<hash>.so unless it exists; returns its path.

    `deps` are further files (headers) whose content keys the hash.
    Raises RuntimeError with the compiler's output if the build fails."""
    h = hashlib.sha256(" ".join([*cmd, *libs]).encode())
    for path in [*sources, *deps]:
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, publish atomically: concurrent
    # processes may build the same library
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", tmp, *sources, *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    with open(so + ".log", "w") as f:  # compiler notes, e.g. ptxas -v
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load_library(name: str, sources: list[str], libs: list[str] = (),
                 ) -> ctypes.CDLL | None:
    """Compile (if needed) and load a host library from native/ sources
    with g++; None when no toolchain is available, so callers can fall
    back to their pure-Python implementation."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        srcs = [os.path.join(_DIR, s) for s in sources]
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
        try:
            so = build_library(name, cmd, srcs,
                               libs=[f"-l{l}" for l in libs])
            _LIBS[name] = ctypes.CDLL(so)
        except (OSError, RuntimeError):
            _LIBS[name] = None
        return _LIBS[name]
