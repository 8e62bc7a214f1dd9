"""Build, bind and count the port's CUDA kernels.

The kernels are CUDA C++ under `abyss_tpu_torch/csrc/`, compiled at
first use with `nvcc` for sm_90a into a shared library with a plain C
interface (cached by source hash in the package's build directory) and
called through ctypes on PyTorch's current stream.  Nothing here runs a
kernel's plain PyTorch version: a wrapper given a tensor that is not on
a CUDA device raises, and a failed build or launch raises.

`launches` counts each wrapper's kernel launches, so a run can show
that its main path went through the kernels (chip_smoke.py resets it
before the run and reads it after).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..native import build_library

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {"nthash": 0, "walk": 0, "branch": 0}
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, PATH, or /usr/local/cuda; raises if none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _load(name: str, source: str, deps: list[str], bind) -> ctypes.CDLL:
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
    # build outside the lock, so that build_all's nvcc runs overlap
    t0 = time.perf_counter()
    so = build_library(name, [nvcc_path(), *NVCC_FLAGS],
                       [os.path.join(CSRC, source)],
                       deps=[os.path.join(CSRC, d) for d in deps])
    lib = ctypes.CDLL(so)
    bind(lib)
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = lib
            build_seconds[name] = time.perf_counter() - t0
            if os.path.exists(so + ".log"):
                with open(so + ".log") as f:
                    build_logs[name] = f.read()
        return _LIBS[name]


def build_all() -> None:
    """Build every kernel library at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(nthash_lib), pool.submit(walk_lib)]:
            fut.result()


def _bind_nthash(lib: ctypes.CDLL) -> None:
    lib.nthash_launch.restype = ctypes.c_int
    lib.nthash_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.nthash_tile.restype = ctypes.c_int
    lib.nthash_tile.argtypes = []


def nthash_lib() -> ctypes.CDLL:
    """Build (first call) and bind csrc/nthash.cu."""
    return _load("nthash", "nthash.cu", ["nthash.cuh"], _bind_nthash)


def nthash(codes: torch.Tensor, k: int, strands: bool = False):
    """Canonical ntHash of every k-window of each row (csrc/nthash.cu).

    codes: uint8 [B, L] contiguous CUDA tensor (codes >= 4 mark N or
    padding).  Returns (canon int64 [B, W], valid bool [B, W], fwd, rev)
    with W = L - k + 1; fwd/rev (int64 [B, W]) only when `strands`,
    else None.  The same values as ops/nthash.kmer_hashes_plain."""
    if not codes.is_cuda:
        raise ValueError("nthash kernel: codes must be a CUDA tensor")
    if codes.dtype != torch.uint8:
        raise TypeError(f"nthash kernel: codes must be uint8, "
                        f"got {codes.dtype}")
    if codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError("nthash kernel: codes must be a contiguous "
                         "[B, L] tensor")
    B, L = codes.shape
    if not 1 <= k <= L:
        raise ValueError(f"nthash kernel: need 1 <= k <= L, got k={k}, "
                         f"L={L}")
    W = L - k + 1
    dev = codes.device
    canon = torch.empty((B, W), dtype=torch.int64, device=dev)
    valid = torch.empty((B, W), dtype=torch.bool, device=dev)
    fwd = torch.empty_like(canon) if strands else None
    rev = torch.empty_like(canon) if strands else None
    if B == 0:
        return canon, valid, fwd, rev
    lib = nthash_lib()
    tile = lib.nthash_tile()
    if B * -(-W // tile) >= 1 << 31 or k > 32768:
        raise ValueError(f"nthash kernel: shape [{B}, {L}] with k={k} "
                         "exceeds the launch grid")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nthash_launch(
            codes.data_ptr(), B, L, k, canon.data_ptr(), valid.data_ptr(),
            fwd.data_ptr() if strands else None,
            rev.data_ptr() if strands else None, stream)
    if err != 0:
        raise RuntimeError(f"nthash kernel launch failed: CUDA error {err}")
    launches["nthash"] += 1
    return canon, valid, fwd, rev


def _bind_walk(lib: ctypes.CDLL) -> None:
    lib.walk_launch.restype = ctypes.c_int
    lib.walk_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p]
    lib.branch_launch.restype = ctypes.c_int
    lib.branch_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def walk_lib() -> ctypes.CDLL:
    """Build (first call) and bind csrc/walk.cu."""
    return _load("walk", "walk.cu", ["walk.cuh", "nthash.cuh"], _bind_walk)


def _check(kernel: str, dev: torch.device, args: dict) -> None:
    """Each (tensor, dtype) of args lies on dev, has dtype, and is
    contiguous; raises otherwise."""
    for name, (t, dtype) in args.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{kernel} kernel: {name} must be a CUDA "
                             f"tensor on the others' device, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel} kernel: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} must be contiguous")


def _table_size(kernel: str, tab: torch.Tensor) -> int:
    size = tab.shape[0] - 8
    if tab.dim() != 1 or size < 1 or size & (size - 1):
        raise ValueError(f"{kernel} kernel: tab must be [size + 8], size a "
                         "power of two")
    return size


def walk(tab: torch.Tensor, buf: torch.Tensor, length: torch.Tensor,
         f: torch.Tensor, r: torch.Tensor, status: torch.Tensor,
         seed_canon: torch.Tensor, has_prev: torch.Tensor, k: int,
         max_steps: int) -> None:
    """Run every ACTIVE lane up to max_steps extension steps, in place
    (csrc/walk.cu): the same lane states as max_steps lock steps of
    dbg/extend.fast_extend's plain loop.

    tab: int64 [size + 8] walk table (ops/hash_probe.build); buf: uint8
    [P, BUF]; length/f/r/seed_canon: int64 [P]; status: int8 [P];
    has_prev: bool [P]; all contiguous on one CUDA device."""
    args = dict(tab=(tab, torch.int64), buf=(buf, torch.uint8),
                length=(length, torch.int64), f=(f, torch.int64),
                r=(r, torch.int64), status=(status, torch.int8),
                seed_canon=(seed_canon, torch.int64),
                has_prev=(has_prev, torch.bool))
    dev = buf.device
    _check("walk", dev, args)
    if buf.dim() != 2:
        raise ValueError("walk kernel: buf must be [P, BUF]")
    P, BUF = buf.shape
    for name in ("length", "f", "r", "status", "seed_canon", "has_prev"):
        if tuple(args[name][0].shape) != (P,):
            raise ValueError(f"walk kernel: {name} must have shape [{P}]")
    size = _table_size("walk", tab)
    if not 1 <= k <= BUF or P >= 1 << 31:
        raise ValueError(f"walk kernel: need 1 <= k <= BUF and P < 2^31, "
                         f"got k={k}, buf [{P}, {BUF}]")
    if P == 0 or max_steps <= 0:
        return
    lib = walk_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.walk_launch(
            buf.data_ptr(), P, BUF, length.data_ptr(), f.data_ptr(),
            r.data_ptr(), status.data_ptr(), seed_canon.data_ptr(),
            has_prev.data_ptr(), tab.data_ptr(), size, k, max_steps, stream)
    if err != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
    launches["walk"] += 1


def branch(tab: torch.Tensor, roots: torch.Tensor, f0: torch.Tensor,
           r0: torch.Tensor, k: int, max_depth: int, width: int,
           probes: torch.Tensor | None = None) -> torch.Tensor:
    """Forward look-ahead depth of each root k-mer (csrc/walk.cu
    branch_kernel): the same int32 [N] as dbg/extend.branch_depths_plain.

    tab: int64 [size + 8] walk table; roots: uint8 [N, k]; f0/r0: int64
    [N] the roots' hashes; all contiguous on one CUDA device.  `probes`
    (int64 [N]), if given, receives the table probes each root made."""
    dev = roots.device
    args = dict(tab=(tab, torch.int64), roots=(roots, torch.uint8),
                f0=(f0, torch.int64), r0=(r0, torch.int64))
    if probes is not None:
        args["probes"] = (probes, torch.int64)
    _check("branch", dev, args)
    if roots.dim() != 2 or roots.shape[1] != k or k < 1:
        raise ValueError(f"branch kernel: roots must be [N, k={k}]")
    N = roots.shape[0]
    for name in ("f0", "r0", "probes"):
        if name in args and tuple(args[name][0].shape) != (N,):
            raise ValueError(f"branch kernel: {name} must have shape [{N}]")
    size = _table_size("branch", tab)
    if width < 1 or max_depth < 0 or N >= 1 << 31:
        raise ValueError(f"branch kernel: need width >= 1, max_depth >= 0 "
                         f"and N < 2^31, got {width}, {max_depth}, {N}")
    depth = torch.zeros(N, dtype=torch.int32, device=dev)
    if N == 0:
        return depth
    H = max(max_depth - k, 0)
    fs = torch.empty(2 * width * N, dtype=torch.int64, device=dev)
    rs = torch.empty_like(fs)
    hist = torch.empty(2 * width * H * N, dtype=torch.uint8, device=dev) \
        if H else None
    lib = walk_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.branch_launch(
            roots.data_ptr(), N, k, f0.data_ptr(), r0.data_ptr(),
            tab.data_ptr(), size, max_depth, width, fs.data_ptr(),
            rs.data_ptr(), hist.data_ptr() if H else None, H,
            depth.data_ptr(), probes.data_ptr() if probes is not None
            else None, stream)
    if err != 0:
        raise RuntimeError(f"branch kernel launch failed: CUDA error {err}")
    launches["branch"] += 1
    return depth
