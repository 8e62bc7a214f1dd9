"""ntHash rolling DNA hash on torch int64 tensors.

Port of abyss_tpu/ops/nthash.py.  Each base maps to a fixed 64-bit
seed, and the k-mer hash is the XOR of the seeds split-rotated by their
distance from the k-mer end; `srol` rotates the low 33 and the high 31
bits independently, so it has period lcm(33, 31) = 1023.  Values are bit-identical to the JAX
package's uint64 hashes, held in int64 (u64.py).

Two implementations of the window hashes:

  * `kmer_hashes_plain`: the closed form of the JAX package — per
    position pre-rotated seeds, a prefix XOR along the read (a log-step
    doubling scan: torch has no XOR associative_scan), and one final
    rotation per window.  Plain tensor ops; the CPU path and the
    reference the CUDA kernel is held against.
  * the hand-written CUDA kernel `csrc/nthash.cu` (ops/kernels.nthash),
    which `kmer_hashes` and `canonical_hashes` launch for a tensor on a
    CUDA device.  A failed build or launch raises; nothing falls back.

`roll_right`/`roll_left` are the O(1) incremental rolls of the
extension engine (NTC64 / NTC64L semantics).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import u64
from . import kernels

# 64-bit per-base seeds of the published ntHash algorithm
# (reference nthash.hpp:24-28; the ntHash paper, Mohamadi et al. 2016).
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456

MULTI_SEED = 0x90B45D39FB6DA1FA  # nthash.hpp multiSeed
MULTI_SHIFT = 27  # nthash.hpp multiShift

SROL_PERIOD = 1023  # lcm(33, 31)

_M33 = (1 << 33) - 1
_M31 = (1 << 31) - 1

# index 4 (N / padding) hashes to 0, like seedN in the reference table
_FWD_TAB = (SEED_A, SEED_C, SEED_G, SEED_T, 0)
# reverse-complement table: seed of the complement base
_REV_TAB = (SEED_T, SEED_G, SEED_C, SEED_A, 0)

# The independent alternate seed table of the wide-mode text checksum
# (`kmer_hashes_alt`): splitmix64 mixes of the primary seeds, so a
# primary collision does not carry over, with the complement pairing
# R2[c] = F2[3 - c] kept, so rev2(seq) == fwd2(rc(seq)).
ALT_A = 0x9E2C61E1E2B1A3D7
ALT_C = 0x6F1D7D3E85A97C15
ALT_G = 0xB46E2D9C0F53A681
ALT_T = 0x1C84F3B6D92E074A
_TABLES = {"f": _FWD_TAB, "r": _REV_TAB,
           "af": (ALT_A, ALT_C, ALT_G, ALT_T, 0),
           "ar": (ALT_T, ALT_G, ALT_C, ALT_A, 0)}


def _srol_int(v: int, n: int) -> int:
    """Split-rotate of one Python int (for the constant tables)."""
    n33, n31 = n % 33, n % 31
    lo, hi = v & _M33, v >> 33
    lo = ((lo << n33) | (lo >> (33 - n33))) & _M33
    hi = ((hi << n31) | (hi >> (31 - n31))) & _M31
    return (hi << 33) | lo


@functools.lru_cache(maxsize=64)
def _table(strand: str, k: int, device: str) -> torch.Tensor:
    """int64[5] seed table ("f"/"r", or the alternate "af"/"ar"),
    split-rotated by k, on device.

    Cached per device: building it is a host-to-device copy, which
    inside the walk loop would be a synchronisation per step."""
    tab = _TABLES[strand]
    return torch.tensor([u64.s64(_srol_int(v, k)) for v in tab],
                        dtype=torch.int64, device=device)


def srol(v: torch.Tensor, n) -> torch.Tensor:
    """Split-rotate left of int64 words by n (int or integer tensor,
    any non-negative value; reduced mod 33 / 31 internally)."""
    n33 = n % 33
    n31 = n % 31
    lo = v & _M33
    hi = u64.srl(v, 33)
    # lo and hi are non-negative, so >> is already a logical shift
    lo = ((lo << n33) | (lo >> (33 - n33))) & _M33
    hi = ((hi << n31) | (hi >> (31 - n31))) & _M31
    return (hi << 33) | lo


def sror1(v: torch.Tensor) -> torch.Tensor:
    """Inverse of one split-rotation (ror1 + swapbits3263)."""
    return srol(v, SROL_PERIOD - 1)


def _prefix_xor(a: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix XOR along the last axis, [..., L] -> [..., L+1],
    by log-step doubling (Hillis-Steele)."""
    L = a.shape[-1]
    s = 1
    while s < L:
        b = a.clone()
        b[..., s:] ^= a[..., :-s]
        a = b
        s *= 2
    return torch.cat([torch.zeros_like(a[..., :1]), a], dim=-1)


def _window_count(codes: torch.Tensor, k: int) -> int:
    W = codes.shape[-1] - k + 1
    if W <= 0:
        raise ValueError(f"read length {codes.shape[-1]} < k={k}")
    return W


def _window_hashes(codes: torch.Tensor, k: int, tables=("f", "r")):
    """(fwd, rev) of every k-window under the seed tables `tables`, by
    the closed form: per position pre-rotated seeds, a prefix XOR along
    the read and one final rotation per window."""
    L = codes.shape[-1]
    W = _window_count(codes, k)
    dev = codes.device
    safe = codes.clamp(max=4).long()
    p = torch.arange(L, device=dev)
    y = srol(_table(tables[0], 0, str(dev))[safe], (-p) % SROL_PERIOD)
    z = srol(_table(tables[1], 0, str(dev))[safe], p % SROL_PERIOD)
    Py = _prefix_xor(y)
    Pz = _prefix_xor(z)
    wy = Py[..., k:] ^ Py[..., :W]  # XOR over window [i, i+k)
    wz = Pz[..., k:] ^ Pz[..., :W]
    i = torch.arange(W, device=dev)
    fwd = srol(wy, (k - 1 + i) % SROL_PERIOD)
    rev = srol(wz, (SROL_PERIOD - i % SROL_PERIOD) % SROL_PERIOD)
    return fwd, rev


def valid_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """bool [..., L-k+1]: window [i, i+k) holds only ACGT codes."""
    W = _window_count(codes, k)
    bad = (codes >= 4).to(torch.int32)
    Pbad = torch.cat([torch.zeros_like(bad[..., :1]),
                      torch.cumsum(bad, dim=-1, dtype=torch.int32)], dim=-1)
    return (Pbad[..., k:] - Pbad[..., :W]) == 0


def kmer_hashes_plain(codes: torch.Tensor, k: int):
    """All k-mer window hashes of a batch of reads, in plain tensor ops.

    Args:
      codes: [..., L] integer base codes (0..3; >= 4 marks N/padding).
      k: k-mer length.

    Returns:
      (fwd, rev, canon, valid): each [..., L-k+1]; `valid[..., i]` is
      True iff window [i, i+k) holds only ACGT codes.  Hashes at invalid
      windows follow the same formula with N seeds of 0.
    """
    fwd, rev = _window_hashes(codes, k)
    return fwd, rev, u64.umin(fwd, rev), valid_windows(codes, k)


def kmer_hashes_alt(codes: torch.Tensor, k: int):
    """(fwd2, rev2) of every k-window under the alternate seed table:
    the wide-mode text checksum of dbg/hash_dbg.fill_wide_side (JAX
    ops/nthash.kmer_hashes_alt).  Torch ops on the codes' device; a
    collision of two k-mer texts in both the fingerprint and this
    checksum needs a 128-bit coincidence."""
    return _window_hashes(codes, k, ("af", "ar"))


def _kernel_2d(codes: torch.Tensor, k: int, strands: bool):
    lead = codes.shape[:-1]
    L = codes.shape[-1]
    if L < k:
        raise ValueError(f"read length {L} < k={k}")
    out = kernels.nthash(codes.reshape(-1, L).contiguous(), k, strands)
    W = L - k + 1
    return [None if t is None else t.reshape(*lead, W) for t in out]


def kmer_hashes(codes: torch.Tensor, k: int):
    """(fwd, rev, canon, valid) of every k-window, as kmer_hashes_plain.

    On a CUDA tensor this launches the CUDA kernel (uint8 codes
    required); on a CPU tensor it runs the plain version."""
    if codes.is_cuda:
        canon, valid, fwd, rev = _kernel_2d(codes, k, strands=True)
        return fwd, rev, canon, valid
    return kmer_hashes_plain(codes, k)


def canonical_hashes(codes: torch.Tensor, k: int):
    """(canon, valid) for all k-windows: the counting and classification
    hot path.  On a CUDA tensor this launches the CUDA kernel
    (csrc/nthash.cu, replacing the TPU's kmer_hashes_pallas); on a CPU
    tensor it runs the plain version."""
    if codes.is_cuda:
        canon, valid, _, _ = _kernel_2d(codes, k, strands=False)
        return canon, valid
    _, _, canon, valid = kmer_hashes_plain(codes, k)
    return canon, valid


def nte64(h: torch.Tensor, k: int, i: int) -> torch.Tensor:
    """Extra hash #i from a base hash (NTE64, nthash.hpp:337-343)."""
    mult = u64.s64(i ^ (k * MULTI_SEED))
    t = h * mult
    return t ^ u64.srl(t, MULTI_SHIFT)


def multi_hashes(canon: torch.Tensor, k: int, num_hashes: int):
    """[..., H] Bloom hash values: canonical hash + NTE64-derived extras
    (RollingHash::getHashes)."""
    hs = [canon] + [nte64(canon, k, i) for i in range(1, num_hashes)]
    return torch.stack(hs, dim=-1)


def hash_base(codes_k: torch.Tensor, k: int):
    """(fwd, rev) hash of single k-mers given as [..., k] code arrays."""
    f, r, _, _ = kmer_hashes(codes_k, k)
    return f[..., 0], r[..., 0]


def roll_right(f, r, k: int, c_out, c_in):
    """Roll hash state one base to the right (NTC64 sliding).

    c_out: first base code of the current k-mer; c_in: incoming base
    code.  Returns (f', r')."""
    dev = str(f.device)
    c_out = c_out.clamp(max=4).long()
    c_in = c_in.clamp(max=4).long()
    f2 = srol(f, 1) ^ _table("f", 0, dev)[c_in] ^ _table("f", k, dev)[c_out]
    r2 = sror1(r ^ _table("r", k, dev)[c_in] ^ _table("r", 0, dev)[c_out])
    return f2, r2


def roll_left(f, r, k: int, c_out, c_in):
    """Roll hash state one base to the left (NTC64L).

    c_out: last base code of the current k-mer; c_in: incoming base code
    (new first base).  Returns (f', r')."""
    dev = str(f.device)
    c_out = c_out.clamp(max=4).long()
    c_in = c_in.clamp(max=4).long()
    f2 = sror1(f ^ _table("f", k, dev)[c_in] ^ _table("f", 0, dev)[c_out])
    r2 = srol(r, 1) ^ _table("r", 0, dev)[c_in] ^ _table("r", k, dev)[c_out]
    return f2, r2


def kmer_hashes_padded(codes_1d, k: int, device):
    """Hash ONE variable-length sequence at a power-of-two padded length
    (>= 64); padding code 4 invalidates the padded windows.

    Returns (fwd, rev, canon, valid) tensors on `device` of the PADDED
    window count; callers mask with `valid`, which is False for every
    padded window."""
    codes_1d = np.asarray(codes_1d, np.uint8).reshape(-1)
    n = codes_1d.shape[0]
    P = max(1 << max(n - 1, 1).bit_length(), 64)
    buf = np.full(P, 4, np.uint8)
    buf[:n] = codes_1d
    f, r, canon, valid = kmer_hashes(
        torch.from_numpy(buf[None]).to(device), k)
    return f[0], r[0], canon[0], valid[0]
