"""The JAX package's `jax.random` draws, made by the port itself.

A copy of jax.random's default generator as jax 0.9 runs it: the
threefry2x32 hash in the "partitionable" layout (`jax_threefry_partitionable`
on), computed in numpy uint32 on the host. The JAX package draws only
constants of a configuration (RANSAC offset and index tables, the person
detector's initial weights), so the hash's output is cached per (key,
shape); every function returns a fresh array.

* `PRNGKey(seed)`: the key (0, seed mod 2**32), as jax builds it from a
  Python int with 64-bit types off.
* `split(key, num)`: key i is threefry(key, (0, i)).
* `random_bits(key, shape)`: element n (flat index) is the XOR of the two
  words of threefry(key, (n >> 32, n & 0xffffffff)).
* `uniform`: 23 random mantissa bits under exponent 0 give [1, 2); minus
  1, scaled and shifted in one fused multiply-add, and clamped below by
  `minval`, all in f32.
* `randint` (int32): two bit arrays from `split(key)`, the high one
  weighted by 2**32 mod span, reduced mod span in wrapping uint32.
* `normal`: sqrt(2) * erfinv(u), u uniform in [nextafter(-1, 0), 1), with
  XLA's f32 erfinv (Giles' single-precision polynomial, Horner steps
  fused).

jax's CPU backend (XLA) contracts a * b + c into one fused multiply-add,
so `_fma32` rounds those steps once. The bits, `uniform` and `randint`
equal jax's exactly; `normal` agrees within a few f32 ulp, because XLA's
log1p is its own approximation and numpy's is not it
(tests/test_torch_prng.py states the bound).
"""

from __future__ import annotations

import functools
import math

import numpy as np

_U32 = np.uint32
_MASK32 = (1 << 32) - 1
# threefry2x32's rotations, the two groups alternating over five rounds of 4
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's f32 erfinv: Giles, "Approximating the erfinv function", the
# single-precision polynomials in w - 2.5 (w < 5) and sqrt(w) - 3 (w >= 5),
# w = -log1p(-x * x), highest degree first
_ERFINV_LT5 = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
], np.float32)
_ERFINV_GE5 = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
], np.float32)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << _U32(d)) | (v >> _U32(32 - d))


def _threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under `key`, elementwise in uint32."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(_PARITY))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = x0 ^ _rotl(x1, r)
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _key(key) -> tuple[int, int]:
    k = np.asarray(key)
    if k.shape != (2,):
        raise ValueError(f"a key is two uint32 words; got shape {k.shape}")
    return int(k[0]) & _MASK32, int(k[1]) & _MASK32


def _counts(shape: tuple[int, ...]):
    """The (high, low) words of each element's flat index."""
    n = np.arange(math.prod(shape), dtype=np.uint64)
    return ((n >> np.uint64(32)).astype(np.uint32).reshape(shape),
            (n & np.uint64(_MASK32)).astype(np.uint32).reshape(shape))


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax's name)
    """(2,) uint32 key of an integer seed: (0, seed mod 2**32)."""
    return np.array([0, int(seed) & _MASK32], np.uint32)


@functools.lru_cache(maxsize=None)
def _split(key: tuple[int, int], num: int) -> np.ndarray:
    b0, b1 = _threefry2x32(key, *_counts((num,)))
    return np.stack([b0, b1], axis=-1)


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) uint32: `num` new keys from `key`."""
    return _split(_key(key), int(num)).copy()


@functools.lru_cache(maxsize=None)
def _bits(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    b0, b1 = _threefry2x32(key, *_counts(shape))
    return b0 ^ b1


def random_bits(key, shape) -> np.ndarray:
    """uint32 random bits of `shape`."""
    return _bits(_key(key), tuple(shape)).copy()


def _fma32(a, b, c) -> np.ndarray:
    """f32 a * b + c rounded once, as XLA's CPU backend contracts it: the
    product is exact in f64, TwoSum gives the sum's f64 rounding error,
    which decides the one case where rounding the f64 sum to f32 would
    round twice (the sum landing on an f32 midpoint)."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    t = s - p
    e = (p - (s - t)) + (c - t)          # s + e == p + c exactly
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    n = np.nextafter(r, np.where(s > r64, np.float32(np.inf),
                                 np.float32(-np.inf)).astype(np.float32))
    n64 = n.astype(np.float64)
    tie = (s != r64) & (s == (r64 + n64) / 2) & (e != 0)
    past = tie & (np.sign(e) == np.sign(n64 - r64))
    return np.where(past, n, r).astype(np.float32)


def _uniform_f32(bits: np.ndarray, minval, maxval) -> np.ndarray:
    lo, hi = np.float32(minval), np.float32(maxval)
    one = (bits >> _U32(32 - 23)) | np.float32(1.0).view(np.uint32)
    floats = one.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0
            ) -> np.ndarray:
    """f32 in [minval, maxval)."""
    return _uniform_f32(_bits(_key(key), tuple(shape)), minval, maxval)


def _urem(a: np.ndarray, span: int) -> np.ndarray:
    """a % span in uint32 (XLA's remainder: a % 0 is a)."""
    return a if span == 0 else a % np.uint64(span)


def _offset_from_bits(hi: np.ndarray, lo: np.ndarray, span: int
                      ) -> np.ndarray:
    """jax's offset in [0, span) from two uint32 bit arrays:
    ((hi % span) * (2**32 % span) + lo % span) % span, each product and
    sum wrapping in uint32 (2**32 % span as ((2**16 % span)**2) % span)."""
    mask = np.uint64(_MASK32)
    hi, lo = hi.astype(np.uint64), lo.astype(np.uint64)
    mult = np.uint64(1 << 16)
    mult = _urem(mult, span)
    mult = _urem((mult * mult) & mask, span)
    off = (_urem(hi, span) * mult) & mask
    off = (off + _urem(lo, span)) & mask
    return _urem(off, span).astype(np.uint32)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """int32 in [minval, maxval) (jax's slightly biased two-draw method)."""
    key, shape = _key(key), tuple(shape)
    minval, maxval = int(minval), int(maxval)
    imin, imax = -(1 << 31), (1 << 31) - 1
    lo, hi = min(max(minval, imin), imax), min(max(maxval, imin), imax)
    span = (hi - lo) & _MASK32
    if hi <= lo:
        span = 1
    elif maxval > imax:        # the range reaches past int32: one more
        span = (span + 1) & _MASK32
    k1, k2 = _split(key, 2)
    off = _offset_from_bits(_bits(_key(k1), shape), _bits(_key(k2), shape),
                            span)
    return (np.int64(lo) + off.astype(np.int64)).astype(np.uint32).view(
        np.int32)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 inverse error function, in XLA's order of operations."""
    x = np.asarray(x, np.float32)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        w = -np.log1p(x * -x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0))
        p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
        for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = _fma32(p, w, np.where(lt, c_lt, c_ge))
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0),
                        x * np.float32(np.inf), out).astype(np.float32)


def normal(key, shape) -> np.ndarray:
    """f32 standard normal draws."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _uniform_f32(_bits(_key(key), tuple(shape)), lo, 1.0)
    return np.float32(np.sqrt(2.0)) * _erf_inv(u)
