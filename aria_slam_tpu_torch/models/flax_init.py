"""flax's random initialisation of the detector, in numpy.

The JAX package's random detector is `yolo.init_params(cfg,
jax.random.key(seed))`: flax's `Module.init` draws every convolution
kernel with lecun-normal from a key of its own and sets every other
variable to a constant. This module computes the same draws without JAX,
so the port's random detector (and the start of its training) is the
reference's:

- `jax.random` keys are threefry2x32 pairs of uint32 in the
  "partitionable" layout (`jax_threefry_partitionable`, on by default in
  JAX 0.9): `random_bits(key, shape)` hashes the counters (0, i) of the
  flat index i and xors the two output words; `split` keeps both words
  of counter (0, i) as the i-th key; `fold_in(key, d)` hashes (0, d)
  (jax/_src/prng.py `threefry_2x32`, `_threefry_split_foldlike`,
  `_threefry_random_bits_partitionable`, `_threefry_fold_in`).
- flax gives a variable the key `fold_in(root, h)`, h the first four
  bytes (big-endian) of the SHA-1 of its module path and the per-module
  `make_rng` counter (flax/core/scope.py `_fold_in_static`,
  `Scope.make_rng`): a Conv's kernel is its scope's first draw, counter 1.
- `truncated_normal(key, -2, 2)` maps uniform floats in (erf(-sqrt 2),
  erf(sqrt 2)) through sqrt(2) erfinv (jax/_src/random.py `_uniform`,
  `_truncated_normal`), and lecun-normal scales it by sqrt(1 / fan_in) /
  0.87962566 (jax/_src/nn/initializers.py `variance_scaling`).

Every step is exact integer or float32 arithmetic as XLA compiles it on
the CPU, where it contracts a * b + c into one fused multiply-add (`_fma`),
except for the two special functions: erf at the two bounds is taken in
float64 and rounded, and erfinv is the single-precision polynomial of
Giles ("Approximating the erfinv function", GPU Computing Gems, 2011)
that XLA uses, with numpy's log1p and sqrt. Where numpy's log1p differs
from XLA's by an ulp, a kernel entry moves by about an ulp of itself
(tests/test_torch_train.py states the measured gap).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under key (k0, k1): uint32 arrays of one shape -> two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        a = np.asarray(x0, np.uint32) + ks[0]
        b = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def key(seed: int) -> np.ndarray:
    """jax.random.key(seed) as JAX makes it without 64-bit mode (the JAX
    package's setting): (0, the seed's low 32 bits)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _counters(n: int):
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(k, num: int = 2) -> np.ndarray:
    """jax.random.split(k, num) -> (num, 2) uint32 keys."""
    a, b = threefry2x32(k, *_counters(num))
    return np.stack([a, b], -1)


def fold_in(k, data: int) -> np.ndarray:
    """jax.random.fold_in(k, data)."""
    a, b = threefry2x32(k, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def random_bits(k, shape) -> np.ndarray:
    """32 random bits for every element of `shape`, row-major."""
    a, b = threefry2x32(k, *_counters(math.prod(shape)))
    return (a ^ b).reshape(shape)


def fold_in_path(k, path) -> np.ndarray:
    """flax's `_fold_in_static`: fold the SHA-1 of the path's names
    (utf-8) and counters (big-endian, as few bytes as they need) into k."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8") if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(k, int.from_bytes(m.digest()[:4], "big"))


def _fma(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding: the float64 product of two
    float32 numbers is exact, so only the float64 sum rounds before the
    float32 one."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def uniform(k, shape, minval, maxval) -> np.ndarray:
    """jax.random.uniform in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled into [minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# Giles' single-precision erfinv: w = -log1p(-x^2); a polynomial in w - 2.5
# below 5, in sqrt(w) - 3 above, times x
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(small, np.float32(_ERFINV_SMALL[0]), np.float32(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(small, np.float32(cs), np.float32(cl)))
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x)


def truncated_normal(k, lower: float, upper: float, shape) -> np.ndarray:
    """jax.random.truncated_normal in float32."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lo / sqrt2)))
    b = np.float32(math.erf(float(hi / sqrt2)))
    out = sqrt2 * erfinv(uniform(k, shape, a, b))
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)), np.nextafter(hi, np.float32(-np.inf)))


def lecun_normal(k, shape) -> np.ndarray:
    """flax's default kernel init, variance_scaling(1, "fan_in",
    "truncated_normal") on a (..., in, out) kernel."""
    fan_in = math.prod(shape) / shape[-1]
    std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    return truncated_normal(k, -2.0, 2.0, shape) * std
