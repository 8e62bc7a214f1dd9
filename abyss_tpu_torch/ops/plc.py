"""Probabilistic log counter (PLC): minifloat counting Bloom filter.

Port of abyss_tpu/ops/plc.py (LogKmerCount/plc.h:15-40): counters are
8-bit minifloats (3-bit exponent, 5-bit mantissa) incremented
probabilistically, so that 8 bits count into the millions with bounded
relative error -- the memory-lean counting array of the `logcounter`
tool.

The JAX package draws the increments' random numbers with `jax.random`
(threefry2x32, JAX 0.9.0 with `jax_threefry_partitionable` on).  The
same stream is written here without JAX, so the counters are
bit-identical for the same seed:

  * `threefry2x32`: the Threefry-2x32 block cipher of
    jax/_src/prng.py (`_threefry2x32_lowering`), 20 rounds;
  * `split`: the fold-like split (`_threefry_split_foldlike`): key i of
    n is threefry(key, (0, i));
  * `random_bits`: the partitionable 32-bit bits
    (`_threefry_random_bits_partitionable`): bits1 ^ bits2 of
    threefry(key, (i >> 32, i & 0xffffffff)) for flat index i;
  * `randint`: jax/_src/random.py `_randint`, which splits the key
    into (k1, k2), draws higher bits from k1 and lower bits from k2 and
    folds them as (higher % span * ((2^16 % span)^2 % span) + lower %
    span) % span in uint32 arithmetic.

Keys are host pairs of Python ints; the bits of a batch are computed on
the tensor's device in int64 masked to 32 bits (CUDA torch has no usable
uint32 arithmetic).  The write is the scatter-max of ops/scatter_max,
which on the card launches csrc/scatter_max.cu.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from .scatter_max import scatter_max_u8

MANT_BITS = 5
MANT = 1 << MANT_BITS  # 32

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under `key`: two
    uint32 words each, as Python ints or int64 tensors of values in
    [0, 2^32)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """jax.random.PRNGKey(seed): the seed's high and low 32 bits."""
    return (seed >> 32) & M32, seed & M32


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """jax.random.split(key, num) (fold-like threefry split)."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def random_bits(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """The n partitionable 32-bit random words of jax.random.bits(key,
    (n,), uint32), as int64 [n] on `device`."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, i >> 32, i & M32)
    return b1 ^ b2


def randint(key: tuple[int, int], n: int, minval: int, maxval: int,
            device) -> torch.Tensor:
    """jax.random.randint(key, (n,), minval, maxval, dtype=int32), as
    int64 [n] on `device`; minval < maxval <= 2^31 - 1."""
    span = maxval - minval
    k1, k2 = split(key)
    off = random_bits(k2, n, device) % span
    multiplier = ((2 ** 16 % span) ** 2 & M32) % span
    if multiplier:      # 0 for every power-of-two span >= 2^16
        higher = random_bits(k1, n, device) % span
        off = ((((higher * multiplier) & M32) + off) & M32) % span
    return off + minval


def to_count(minifloat: torch.Tensor) -> torch.Tensor:
    """Decode minifloat codes to approximate counts (plc.h toValue);
    int32."""
    m = minifloat.to(torch.int32)
    exp = m >> MANT_BITS
    mant = m & (MANT - 1)
    return torch.where(exp == 0, mant,
                       (mant + MANT) << (exp - 1).clamp(min=0))


def increment(minifloat: torch.Tensor, rand_u32: torch.Tensor):
    """Probabilistically increment: codes with exponent e advance with
    probability 2^-(e-1) (plc.h increment); uint8."""
    m = minifloat.to(torch.int32)
    exp = m >> MANT_BITS
    # probability denominator 2^(exp-1); always increment when exp <= 1
    shift = (exp - 1).clamp(min=0)
    take = (rand_u32 & ((1 << shift) - 1)) == 0
    nxt = torch.clamp(m + 1, max=255)
    return torch.where(take, nxt, m).to(torch.uint8)


class PLCArray:
    """A counting array of probabilistic log counters on `device`.

    The counters are the first `size` cells of a power-of-two block, so
    the scatter-max (which drops indices at or past the largest power of
    two not above its length) writes every index below `size`."""

    def __init__(self, size: int, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        self.size = size
        self._cells = torch.zeros(1 << max(size - 1, 0).bit_length(),
                                  dtype=torch.uint8, device=dev)
        self.counters = self._cells[:size]
        self.key = prng_key(seed)

    @property
    def device(self) -> torch.device:
        return self._cells.device

    def insert(self, idx) -> None:
        """One probabilistic increment per entry of idx (integers in
        [0, size), any order, repeats allowed: a repeated cell takes the
        largest of its increments, as `.at[idx].max` does)."""
        idx = torch.as_tensor(idx).to(self.device).reshape(-1).long()
        self.key, sub = split(self.key)
        rnd = randint(sub, idx.shape[0], 0, 1 << 30, self.device)
        new = increment(self._cells[idx], rnd)
        scatter_max_u8(self._cells, idx, new)

    def count(self, idx) -> torch.Tensor:
        return to_count(self._cells[torch.as_tensor(idx).to(
            self.device).long()])
