"""JAX's default random numbers, in numpy.

The transport models' ``random_fourier`` noise embedding fixes its
frequencies as ``jax.random.normal(jax.random.PRNGKey(seed), (half,))``, so
a model trained by the JAX package, and its bundle, depend on those exact
values.  This module recomputes them without JAX: the Threefry-2x32 block
cipher (20 rounds, Salmon et al. 2011), the key of ``PRNGKey(seed)``, the
32-bit draws of the "partitionable" layout (JAX's default since 0.5,
``jax_threefry_partitionable=True``: element ``i`` of the flat output is
the cipher of the counter ``(i >> 32, i & 0xffffffff)``, its two words
XORed), and ``jax.random.normal``'s float32 transform (23 random mantissa
bits -> a uniform in ``(-1, 1)`` -> ``sqrt(2) * erfinv``), with ``erfinv``
XLA's float32 polynomial (Giles 2010): the bits are JAX's exactly, the
normals within a few float32 ulps (the order of XLA's float operations is
its own).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# XLA's ErfInv32 coefficients, for w = -log1p(-x^2) below 5 and above
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                        1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                        2.83297682], np.float32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry_2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter words ``(x0, x1)`` (uint32 arrays) under
    ``key = (k0, k1)``; returns the two output words."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """The key words of ``jax.random.PRNGKey(seed)`` (a 64-bit seed split
    into its high and low words)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & 0xFFFFFFFF


def random_bits(key: Tuple[int, int], shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32) in the partitionable layout."""
    n = int(np.prod(shape, dtype=np.int64))
    counter = np.arange(n, dtype=np.uint64)
    hi = (counter >> np.uint64(32)).astype(np.uint32)
    lo = (counter & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        y0, y1 = threefry_2x32(key, hi, lo)
    return (y0 ^ y1).reshape(tuple(shape))


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` for ``|x| < 1``."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-x * x)).astype(np.float32)
    low = w < np.float32(5)
    w = np.where(low, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float32)
    p = np.where(low, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(low, a, b) + p * w).astype(np.float32)
    return (p * x).astype(np.float32)


def normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` in float32."""
    bits = random_bits(prng_key(seed), shape)
    # the 23 high bits as the mantissa of a float in [1, 2), minus 1: [0, 1)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, floats * (np.float32(1) - lo) + lo)
    return (np.float32(np.sqrt(2)) * erfinv(u)).astype(np.float32)


@lru_cache(maxsize=64)
def cached_normal(seed: int, n: int) -> np.ndarray:
    """:func:`normal` of shape ``(n,)``, computed once per ``(seed, n)``."""
    out = normal(seed, (n,))
    out.setflags(write=False)
    return out
