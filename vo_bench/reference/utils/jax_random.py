"""The JAX package's random stream, reproduced bit for bit (``jax.random`` with the
``threefry2x32`` PRNG).

The JAX package draws every RANSAC minimal set from ``jax.random``: a key per run
(``PRNGKey(cfg.seed)``), split once per bootstrap, per frame or per chunk, and
``jax.random.choice`` with the valid points' probabilities. The port keeps its own copy
of those functions, so one seed gives both packages the same draws. What it reproduces
is jax 0.9.0 with ``jax_threefry_partitionable`` True (that version's default) and the
default ``threefry2x32`` implementation:

- ``threefry2x32``: the Threefry-2x32 hash of 20 rounds (``jax._src.prng``).
- ``PRNGKey(seed)``: the key ``(0, seed mod 2**32)`` as two uint32 (with
  ``jax_enable_x64`` off, its default, JAX takes the seed as a 32-bit integer).
- ``split(key, n)``: the hash of the counters ``(0, i)``, ``i < n``, one key each (the
  partitionable, fold-like split).
- ``uniform(key, shape)``: float32 in [0, 1) from ``bits1 ^ bits2`` of the hash of the
  counters ``(0, i)`` over the flat index, its top 23 bits as a mantissa.

The hash works on numpy arrays (the host's key chain) and on torch tensors of int64 on
any device (a batch of keys on the card) with the same code: every value is an unsigned
32-bit number held in int64 and masked after each addition and shift, so neither
library's wrap-around or sign rules matter. A key is ``(2,)`` uint32 on the host, as the
JAX package's checkpoint stores it (``rng_key``), and ``(..., 2)`` int64 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter pairs ``(x1, x2)`` under the key ``(k1, k2)``: int64
    numpy arrays or torch tensors holding values in [0, 2**32), broadcast together.
    Returns the two output words, in the same form."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & _MASK
    x2 = (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax.random's name)
    """``jax.random.PRNGKey(seed)``: (2,) uint32."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def _words(keys):
    """The two key words of ``keys (..., 2)`` as int64, each with a trailing axis of 1."""
    if torch.is_tensor(keys):
        k = keys.to(torch.int64)
    else:
        k = np.asarray(keys).astype(np.int64)
    return k[..., 0:1], k[..., 1:2]


def _counters(keys, n: int):
    """The counters 0..n-1 beside ``keys``: on its device for a tensor, numpy else."""
    if torch.is_tensor(keys):
        return torch.arange(n, dtype=torch.int64, device=keys.device)
    return np.arange(n, dtype=np.int64)


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` for ``key (..., 2)``: ``(..., num, 2)``, uint32 for
    numpy keys (the host's key chain), int64 for tensors (a batch of keys on a device)."""
    k1, k2 = _words(key)
    b1, b2 = threefry2x32(k1, k2, 0, _counters(key, num))
    if torch.is_tensor(key):
        return torch.stack([b1, b2], dim=-1)
    return np.stack([b1, b2], axis=-1).astype(np.uint32)


def _bits(keys, n: int):
    """``random_bits(key, 32, (n,))`` for ``keys (..., 2)``: (..., n) int64."""
    k1, k2 = _words(keys)
    b1, b2 = threefry2x32(k1, k2, 0, _counters(keys, n))
    return b1 ^ b2


def uniform(key, shape: tuple):
    """``jax.random.uniform(key, shape)`` (float32, [0, 1)) for ``key (..., 2)``:
    ``(..., *shape)``, numpy for numpy keys, a tensor on the keys' device for tensors."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    mant = (_bits(key, n) >> 9) | 0x3F800000      # in [2**30, 2**31): fits int32
    if torch.is_tensor(key):
        u = mant.to(torch.int32).view(torch.float32) - 1.0
    else:
        u = mant.astype(np.int32).view(np.float32) - np.float32(1.0)
    return u.reshape(tuple(np.shape(key))[:-1] + shape)

