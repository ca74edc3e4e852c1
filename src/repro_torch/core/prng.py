"""Threefry-2x32 counter-based random numbers in integer torch ops: the
PRNG behind the reference's seeded sampling (``jax.random`` 0.9.0 with
its default ``threefry2x32`` implementation and
``jax_threefry_partitionable`` on), written out so that the port draws
the same bits on the CPU and on the card without JAX.

The pieces, each the reference's own:

* ``threefry2x32``: the Threefry-2x32 block function, 20 rounds with a
  key injection after every fourth (``jax/_src/prng.py``
  ``_threefry2x32_lowering``);
* ``threefry_seed``: the key ``PRNGKey(seed)`` makes of an integer seed,
  (seed >> 32, seed & 0xFFFFFFFF) — (0, seed) for a uint32 seed;
* ``fold_in``: ``threefry_2x32(key, threefry_seed(uint32(data)))``, so
  the new key is the hash of the counter pair (0, data);
* ``random_bits``: 32-bit words for a (n,) shape, ``bits1 ^ bits2`` of
  the hash of the counter pairs (0, i), i = 0 .. n − 1
  (``_threefry_random_bits_partitionable``);
* ``uniform``: float32 in [tiny, 1) from those words: the top 23 bits
  as the mantissa of a float in [1, 2), minus 1, scaled and clamped as
  ``jax.random.uniform(minval=tiny, maxval=1)`` does;
* ``gumbel``: ``-log(-log(u))``, the ``"low"`` mode of
  ``jax.random.gumbel``;
* ``PRNGKey``, ``split`` and ``categorical``: the key chain of the
  whole-batch engines (``serve.engine``, ``serve.ensemble_engine``) —
  ``split`` hashes the counter pairs (0, i) under the key
  (``_threefry_split_foldlike``), ``categorical`` takes the argmax of
  the logits plus Gumbel noise drawn over their whole shape.

torch has only partial uint32 arithmetic, and less of it on CUDA, so
every 32-bit word rides in an int64 tensor and is masked back to 32 bits
after each add and shift: the same code runs on both devices and gives
the same bits. Keys are pairs of int64 tensors that broadcast against the
counters, so one call hashes a batch of rows with a key each.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
Key = Tuple[Tensor, Tensor]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(key: Key, x0: Tensor, x1: Tensor) -> Key:
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under ``key``
    (k0, k1); all int64 holding uint32 values, broadcast together.
    Returns the two hashed words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def threefry_seed(seed: Tensor) -> Key:
    """The raw key of ``PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF)
    of an int64 seed tensor (a uint32 seed gives (0, seed))."""
    seed = seed.to(torch.int64)
    return (seed >> 32) & MASK32, seed & MASK32


def fold_in(key: Key, data: Tensor) -> Key:
    """``jax.random.fold_in(key, data)``: data is cast to uint32 (an int32
    count wraps) and hashed as the counter pair (0, data)."""
    data = data.to(torch.int64) & MASK32
    return threefry2x32(key, torch.zeros_like(data), data)


def random_bits(key: Key, n: int) -> Tensor:
    """(..., n) 32-bit words of ``jax.random.bits(key, (n,))`` for keys of
    shape (...,) (as int64)."""
    k0, k1 = (k[..., None] for k in key)
    iota = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32((k0, k1), torch.zeros_like(iota), iota)
    return y0 ^ y1


def uniform(bits: Tensor) -> Tensor:
    """float32 uniforms in [tiny, 1) from 32-bit words, bit for bit as
    ``jax.random.uniform(key, shape, float32, minval=tiny, maxval=1)``."""
    # the reference scales by maxval − minval = 1 − tiny, which is 1 in
    # float32: an exact product, left out. Python-scalar operands: a
    # device tensor built from one would be a host-to-device copy
    tiny = torch.finfo(torch.float32).tiny
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    return (floats + tiny).clamp_min(tiny)


def gumbel(bits: Tensor) -> Tensor:
    """float32 Gumbel noise ``-log(-log(u))`` from 32-bit words (the
    ``"low"`` mode of ``jax.random.gumbel`` at float32)."""
    return -torch.log(-torch.log(uniform(bits)))


def PRNGKey(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for an integer seed, as a pair of int64
    scalars on ``device``."""
    return threefry_seed(torch.tensor(seed, dtype=torch.int64,
                                      device=device))


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)``: key i is the hash of the counter
    pair (0, i) under ``key``. Returns a list of ``num`` keys."""
    iota = torch.arange(num, dtype=torch.int64, device=key[0].device)
    b0, b1 = threefry2x32(key, torch.zeros_like(iota), iota)
    return [(b0[i], b1[i]) for i in range(num)]


def categorical(key: Key, logits: Tensor) -> Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` of float32 logits
    (..., V): the argmax of ``logits`` plus the Gumbel noise of
    ``random_bits`` over the whole shape, flattened row-major (first index
    among ties). Returns the (...) int64 draws."""
    bits = random_bits(key, logits.numel()).reshape(logits.shape)
    return torch.argmax(gumbel(bits) + logits, dim=-1)
