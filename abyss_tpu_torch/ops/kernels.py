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
import functools
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

launches = {"nthash": 0, "walk": 0, "branch": 0, "walk_bloom": 0,
            "branch_bloom": 0, "walk_cascade": 0, "branch_cascade": 0,
            "walk_sharded": 0, "branch_sharded": 0, "scatter_max": 0}
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
    libs = (nthash_lib, walk_lib, scatter_max_lib)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        for fut in [pool.submit(lib) for lib in libs]:
            fut.result()


def _bind_nthash(lib: ctypes.CDLL) -> None:
    lib.nthash_launch.restype = ctypes.c_int
    lib.nthash_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.geometry = nthash_geometry(lib)


def nthash_geometry(lib: ctypes.CDLL) -> tuple[int, int, int]:
    """(THREADS, STRIP, PACK_CODES) of csrc/nthash.cuh, as a library
    built from it (the CUDA kernel's, or the g++ harness's) reports."""
    lib.nthash_geometry.restype = None
    lib.nthash_geometry.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    lib.nthash_geometry(out)
    return tuple(out)


def nthash_layout(B: int, L: int, k: int, geometry: tuple[int, int, int],
                  sms: int) -> tuple[int, int]:
    """(rows, seg) of an ntHash launch over [B, L] codes (csrc/nthash.cu):
    rows > 1 whole rows a block (packed, seg = W) when at least two rows'
    strips and bases fit a block, else one segment of seg windows of one
    row a block (tile).  A tile is a block's worth of strips, or fewer
    while the grid has fewer blocks than the card's `sms` multiprocessors
    (a few long rows), down to a warp's worth: the rows then spread over
    more of the card, each block's chain of phases is shorter."""
    threads, strip, pack_codes = geometry
    W = L - k + 1
    rows = min(threads // -(-W // strip), pack_codes // L, B)
    if rows >= 2:
        return rows, W
    seg = threads * strip
    while seg > 32 * strip and B * -(-W // seg) < sms:
        seg //= 2
    return 1, min(W, seg)


@functools.lru_cache(maxsize=None)
def device_sms(index: int) -> int:
    """Multiprocessors of CUDA device `index`, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def nthash_lib() -> ctypes.CDLL:
    """Build (first call) and bind csrc/nthash.cu."""
    return _load("nthash", "nthash.cu", ["nthash.cuh"], _bind_nthash)


def nthash(codes: torch.Tensor, k: int, strands: bool = False):
    """Canonical ntHash of every k-window of each row (csrc/nthash.cu).

    codes: uint8 [B, L] contiguous CUDA tensor (codes >= 4 mark N or
    padding).  Returns (canon int64 [B, W], valid bool [B, W], fwd, rev)
    with W = L - k + 1; fwd/rev (int64 [B, W]) only when `strands`,
    else None.  The same values as ops/nthash.kmer_hashes_plain.  The
    launch's layout follows the shape (nthash_layout)."""
    return nthash_launch(codes, k, strands, None)


def nthash_launch(codes: torch.Tensor, k: int, strands: bool, layout):
    """nthash in a given layout (rows, seg), or (None) nthash_layout's."""
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
    rows, seg = layout or nthash_layout(B, L, k, lib.geometry,
                                        device_sms(dev.index))
    if -(-B // rows) * -(-W // seg) >= 1 << 31 or k > 32768:
        raise ValueError(f"nthash kernel: shape [{B}, {L}] with k={k} "
                         "exceeds the launch grid")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nthash_launch(
            codes.data_ptr(), B, L, k, rows, seg, canon.data_ptr(),
            valid.data_ptr(), fwd.data_ptr() if strands else None,
            rev.data_ptr() if strands else None, stream)
    if err != 0:
        raise RuntimeError(f"nthash kernel launch failed: CUDA error {err}")
    launches["nthash"] += 1
    return canon, valid, fwd, rev


def _bind_walk(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lane = [P, I64, I64, P, P, P, P, P, P]
    root = [P, I64, I, P, P]
    branch_rest = [I, I, I, P, P, P, P]
    for name, res, args in (
            ("walk_launch", I, lane + [P, I64, I, I64, P]),
            ("walk_bloom_launch", I, lane + [P, I64, I, I, I, I, I64, P]),
            ("walk_cascade_launch", I, lane + [P, I64, I, I, I, I, I64, P]),
            ("branch_launch", I, root + [P, I64] + branch_rest),
            ("branch_bloom_launch", I, root + [P, I64, I, I, I] + branch_rest),
            ("branch_cascade_launch", I,
             root + [P, I64, I, I, I] + branch_rest),
            ("walk_sharded_launch", I,
             lane + [P, I64, I, I, I, I, I, I64, P]),
            ("branch_sharded_launch", I,
             root + [P, I64, I, I, I, I] + branch_rest),
            ("walk_enable_peer", I, [I]),
            ("walk_blocks", I64, [I64, I]), ("branch_blocks", I64, [I64]),
            ("branch_scratch_bytes", I64, [I, I, I])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def walk_lib() -> ctypes.CDLL:
    """Build (first call) and bind csrc/walk.cu."""
    return _load("walk", "walk.cu", ["walk.cuh", "nthash.cuh"], _bind_walk)


def walk_blocks(P: int, k: int) -> int:
    """Blocks of a walk launch over P lanes of k-mers of k bases
    (csrc/walk.cu)."""
    return walk_lib().walk_blocks(P, k)


def branch_blocks(N: int) -> int:
    """Blocks of a look-ahead launch over N roots (csrc/walk.cu)."""
    return walk_lib().branch_blocks(N)


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


def _sharded(kernel: str, solid, dev: torch.device):
    """The launch arguments of ShardedSolid for a sharded counting filter
    (parallel/distributed.ShardedCountingFilter) probed from CUDA device
    `dev`: its shards (uint8 [size / n_shard] each, n_shard a power of
    two) lie on `dev` or on cards whose memory `dev` can read, which this
    turns on; raises otherwise."""
    shards = solid.shards
    n = len(shards)
    shard_len = solid.size // n
    if n & (n - 1) or shard_len & (shard_len - 1) or shard_len < 1:
        raise ValueError(f"{kernel} kernel: a sharded filter needs a power "
                         "of two of shards of a power of two of counters")
    if not (0 < solid.num_hashes < 1 << 16 and 0 <= solid.k < 1 << 16
            and -(1 << 16) < solid.threshold < 1 << 16):
        raise ValueError(f"{kernel} kernel: filter parameters out of range")
    for s in shards:
        if not s.is_cuda or dev.type != "cuda":
            raise ValueError(f"{kernel} kernel: shard on {s.device}, probed "
                             f"from {dev}: both must be CUDA devices")
        if s.dtype != torch.uint8 or not s.is_contiguous() or \
                tuple(s.shape) != (shard_len,):
            raise ValueError(f"{kernel} kernel: each shard must be a "
                             f"contiguous uint8 [{shard_len}] tensor")
    lib = walk_lib()
    for s in shards:
        if s.device != dev:
            with torch.cuda.device(dev):
                err = lib.walk_enable_peer(s.device.index)
            if err != 0:
                raise RuntimeError(
                    f"{kernel} kernel: {dev} cannot read the shard on "
                    f"{s.device} (peer access: CUDA error {err})")
    ptrs = solid.shard_pointers(dev)
    return [ptrs.data_ptr(), solid.size, shard_len.bit_length() - 1,
            solid.k, solid.num_hashes, solid.threshold], kernel + "_sharded"


def _solid(kernel: str, solid, args: dict, dev: torch.device):
    """The launch arguments and launch-count name of a walk kernel's
    solidity test: `solid` is the walk table (int64 [size + 8], size a
    power of two, ops/hash_probe.ProbeSet.tab), a counting Bloom filter
    (its counters uint8 [size + 1], size a power of two, and its k,
    num_hashes and threshold), a cascading Bloom filter (its levels
    uint8 [depth, size + 1], and its k and num_hashes) or a sharded
    counting filter (_sharded).  Adds the array to `args` for _check."""
    if hasattr(solid, "shards"):
        return _sharded(kernel, solid, dev)
    if isinstance(solid, torch.Tensor):
        size = solid.shape[0] - 8
        if solid.dim() != 1 or size < 1 or size & (size - 1):
            raise ValueError(f"{kernel} kernel: tab must be [size + 8], size "
                             "a power of two")
        args["tab"] = (solid, torch.int64)
        return [solid.data_ptr(), size], kernel
    cascade = hasattr(solid, "levels")
    arr = solid.levels if cascade else solid.counters
    size = arr.shape[-1] - 1
    if arr.dim() != (2 if cascade else 1) or size < 1 or size & (size - 1):
        raise ValueError(f"{kernel} kernel: filter array must be "
                         f"[{'depth, ' if cascade else ''}size + 1], size a "
                         "power of two")
    last = solid.depth if cascade else solid.threshold
    if not (0 < solid.num_hashes < 1 << 16 and 0 <= solid.k < 1 << 16
            and -(1 << 16) < last < 1 << 16):
        raise ValueError(f"{kernel} kernel: filter parameters out of range")
    args["levels" if cascade else "counters"] = (arr, torch.uint8)
    return [arr.data_ptr(), size, solid.k, solid.num_hashes, last], \
        kernel + ("_cascade" if cascade else "_bloom")


def walk(solid, buf: torch.Tensor, length: torch.Tensor,
         f: torch.Tensor, r: torch.Tensor, status: torch.Tensor,
         seed_canon: torch.Tensor, has_prev: torch.Tensor, k: int,
         max_steps: int) -> None:
    """Run every ACTIVE lane up to max_steps extension steps, in place
    (csrc/walk.cu): the same lane states as max_steps lock steps of
    dbg/extend.fast_extend's plain loop.

    solid: the walk table (int64 [size + 8], ops/hash_probe.solid_table), a
    CountingBloomFilter or a CascadingBloomFilter (ops/bloom) or a
    ShardedCountingFilter (parallel/distributed), whose variants count
    as launches["walk_bloom"], ["walk_cascade"] and ["walk_sharded"];
    buf: uint8 [P, BUF]; length/f/r/seed_canon:
    int64 [P]; status: int8 [P]; has_prev: bool [P]; all contiguous on
    one CUDA device."""
    args = dict(buf=(buf, torch.uint8),
                length=(length, torch.int64), f=(f, torch.int64),
                r=(r, torch.int64), status=(status, torch.int8),
                seed_canon=(seed_canon, torch.int64),
                has_prev=(has_prev, torch.bool))
    dev = buf.device
    solid_args, name = _solid("walk", solid, args, dev)
    _check("walk", dev, args)
    if buf.dim() != 2:
        raise ValueError("walk kernel: buf must be [P, BUF]")
    P, BUF = buf.shape
    for n in ("length", "f", "r", "status", "seed_canon", "has_prev"):
        if tuple(args[n][0].shape) != (P,):
            raise ValueError(f"walk kernel: {n} must have shape [{P}]")
    if not (1 <= k <= BUF and k < 4096 and P < 1 << 31):
        raise ValueError(f"walk kernel: need 1 <= k <= BUF, k < 4096 and "
                         f"P < 2^31, got k={k}, buf [{P}, {BUF}]")
    if P == 0 or max_steps <= 0:
        return
    lib = walk_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name + "_launch")(
            buf.data_ptr(), P, BUF, length.data_ptr(), f.data_ptr(),
            r.data_ptr(), status.data_ptr(), seed_canon.data_ptr(),
            has_prev.data_ptr(), *solid_args, k, max_steps, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def branch(solid, roots: torch.Tensor, f0: torch.Tensor,
           r0: torch.Tensor, k: int, max_depth: int, width: int,
           probes: torch.Tensor | None = None) -> torch.Tensor:
    """Forward look-ahead depth of each root k-mer (csrc/walk.cu
    branch_kernel): the same int32 [N] as dbg/extend.branch_depths_plain.

    solid: the walk table, a CountingBloomFilter, a CascadingBloomFilter
    or a ShardedCountingFilter, as for `walk` (the filter variants count
    as launches["branch_bloom"], ["branch_cascade"] and
    ["branch_sharded"]); roots: uint8
    [N, k]; f0/r0: int64 [N] the roots' hashes; all contiguous on one
    CUDA device.  `probes` (int64 [N]), if given, receives each root's
    solidity tests as a sequential scan of each step's children in
    (parent, base) order makes them, up to the step's width-th solid
    child (the kernel's group of threads tests a step's children all at
    once).  A root's frontier lives in shared memory, or in scratch
    allocated here when a block's frontiers do not fit there."""
    dev = roots.device
    args = dict(roots=(roots, torch.uint8),
                f0=(f0, torch.int64), r0=(r0, torch.int64))
    if probes is not None:
        args["probes"] = (probes, torch.int64)
    solid_args, name = _solid("branch", solid, args, dev)
    _check("branch", dev, args)
    if roots.dim() != 2 or roots.shape[1] != k or k < 1:
        raise ValueError(f"branch kernel: roots must be [N, k={k}]")
    N = roots.shape[0]
    for n in ("f0", "r0", "probes"):
        if n in args and tuple(args[n][0].shape) != (N,):
            raise ValueError(f"branch kernel: {n} must have shape [{N}]")
    if not (1 <= width < 1 << 24 and 0 <= max_depth < 1 << 31
            and N < 1 << 31):
        raise ValueError(f"branch kernel: need 1 <= width < 2^24, "
                         f"0 <= max_depth < 2^31 and N < 2^31, got {width}, "
                         f"{max_depth}, {N}")
    depth = torch.zeros(N, dtype=torch.int32, device=dev)
    if N == 0:
        return depth
    H = max(max_depth - k, 0)
    lib = walk_lib()
    # frontiers live in shared memory unless a block's do not fit there
    per_root = lib.branch_scratch_bytes(width, H, k)
    scratch = torch.empty(N * per_root, dtype=torch.uint8, device=dev) \
        if per_root else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name + "_launch")(
            roots.data_ptr(), N, k, f0.data_ptr(), r0.data_ptr(),
            *solid_args, max_depth, width, H,
            scratch.data_ptr() if per_root else None, depth.data_ptr(),
            probes.data_ptr() if probes is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return depth


def _bind_scatter_max(lib: ctypes.CDLL) -> None:
    lib.scatter_max_launch.restype = ctypes.c_int
    lib.scatter_max_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p]


def scatter_max_lib() -> ctypes.CDLL:
    """Build (first call) and bind csrc/scatter_max.cu."""
    return _load("scatter_max", "scatter_max.cu", ["scatter_max.cuh"],
                 _bind_scatter_max)


def scatter_max(counters: torch.Tensor, idx: torch.Tensor,
                val: torch.Tensor) -> None:
    """counters[i] <- max(counters[i], val[j]) for every idx[j] == i, in
    place (csrc/scatter_max.cu), dropping every idx[j] outside [0, S),
    S the largest power of two <= len(counters): the same as
    ops/scatter_max.scatter_max_u8_plain.

    counters: uint8 [n]; idx: int64 [Q]; val: uint8 [Q]; all contiguous
    on one CUDA device."""
    dev = counters.device
    _check("scatter_max", dev, dict(counters=(counters, torch.uint8),
                                    idx=(idx, torch.int64),
                                    val=(val, torch.uint8)))
    if counters.dim() != 1 or counters.shape[0] < 1:
        raise ValueError("scatter_max kernel: counters must be [n], n >= 1")
    if idx.dim() != 1 or tuple(val.shape) != tuple(idx.shape):
        raise ValueError("scatter_max kernel: idx and val must be [Q]")
    S = 1 << (counters.shape[0].bit_length() - 1)
    Q = idx.shape[0]
    if Q == 0:
        return
    lib = scatter_max_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scatter_max_launch(counters.data_ptr(), S, idx.data_ptr(),
                                     val.data_ptr(), Q, stream)
    if err != 0:
        raise RuntimeError(f"scatter_max kernel launch failed: CUDA error "
                           f"{err}")
    launches["scatter_max"] += 1
