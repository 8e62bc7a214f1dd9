"""ctypes bindings for the native FASTX reader (native/fastx.cpp).

Produces the same ReadBatch objects as the Python reader in fastx.py,
but with all per-base work (parsing, quality trim, 2-bit encoding)
done in C++.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Sequence

import numpy as np

from ..native import load_library
from . import fastx as pyfastx


def _lib():
    lib = load_library("fastx", ["fastx.cpp"], libs=["z"])
    if lib is None:
        return None
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.fastx_next_batch.restype = ctypes.c_long
    lib.fastx_next_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _lib() is not None


def read_batches(paths: Sequence[str] | str, batch_size: int = 16384,
                 max_len: int = 512, q: int = 0, chastity: bool = True,
                 ) -> Iterator[pyfastx.ReadBatch]:
    """Native-backed equivalent of fastx.read_batches."""
    lib = _lib()
    if lib is None:
        yield from pyfastx.read_batches(paths, batch_size, max_len, q,
                                        chastity)
        return
    if isinstance(paths, str):
        paths = [paths]
    names_cap = batch_size * 256
    pending_codes = np.full((batch_size, max_len), 4, np.uint8)
    pending_len = np.zeros(batch_size, np.int32)
    pending_ids: list[str] = []
    pending_comments: list[str] = []

    def emit():
        nonlocal pending_codes, pending_len, pending_ids, pending_comments
        out = pyfastx.ReadBatch(pending_codes, pending_len, pending_ids,
                                pending_comments)
        pending_codes = np.full((batch_size, max_len), 4, np.uint8)
        pending_len = np.zeros(batch_size, np.int32)
        pending_ids = []
        pending_comments = []
        return out

    codes = np.empty((batch_size, max_len), np.uint8)
    lengths = np.empty(batch_size, np.int32)
    names = ctypes.create_string_buffer(names_cap)
    for path in paths:
        h = lib.fastx_open(path.encode(), q, int(chastity))
        if not h:
            raise FileNotFoundError(path)
        try:
            while True:
                want = batch_size - len(pending_ids)
                n = lib.fastx_next_batch(
                    h,
                    codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    names, names_cap, want, max_len)
                if n == -1:
                    raise ValueError(f"{path}: parse error")
                if n == -2:
                    raise ValueError(f"{path}: read names too long")
                if n <= 0:
                    break
                got = int(n)
                base = len(pending_ids)
                pending_codes[base:base + got] = codes[:got]
                pending_len[base:base + got] = lengths[:got]
                raw = names.raw
                pos = 0
                for _ in range(got):
                    end = raw.index(b"\0", pos)
                    packed = raw[pos:end].decode()
                    rid, tab, comment = packed.partition("\t")
                    pending_ids.append(rid)
                    pending_comments.append(comment)
                    pos = end + 1
                if len(pending_ids) == batch_size:
                    yield emit()
        finally:
            lib.fastx_close(h)
    if pending_ids:
        yield emit()
