"""`jax.random.normal(jax.random.PRNGKey(seed), shape)` in numpy, bit for bit.

The port cannot import jax, but SALSA's power iteration starts from
`jax.random.normal(PRNGKey(20211021), (2, 2, C))` (`features/salsa_spatial.py::
start_vectors`). This module computes those draws for any shape, as jax 0.9.0 does
on the CPU in its default mode (`jax_threefry_partitionable` True, implementation
threefry2x32):

- `prng_key(seed)`: the key words (seed >> 32, seed & 0xFFFFFFFF);
- `random_bits(key, n)`: element i's 32 bits are the XOR of the two output words
  of threefry2x32 (20 rounds) on the counter (i >> 32, i & 0xFFFFFFFF), its flat
  index: so a shape's draws are a prefix of a larger shape's in C order;
- `uniform(key, n)`: `(bits >> 9) | 0x3F800000` read as a float in [1, 2),
  minus 1, mapped onto [nextafter(-1, 0), 1);
- `normal(key, shape)`: sqrt(2) * erf_inv(u) in float32.

`erf_inv` follows what XLA compiles for `chlo.erf_inv` on an x86-64 CPU, operation
for operation: Giles' single-precision polynomial on w = -log1p(-u * u), where
log1p is XLA's own (a Cephes rational below |x| = sqrt(2) - 1, else a Cephes logf
of 1 + x) and every multiply-add that LLVM contracts is one rounding (`_fma`).
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# Giles' erfinv polynomial (XLA's ErfInv32), highest degree first
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p below sqrt(2) - 1 (Cephes), highest degree first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Cephes logf
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)`'s two words for threefry2x32."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is outside [0, 2**64)")
    return seed >> 32, seed & 0xFFFFFFFF


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds on the counter words (x0, x1), uint32 arrays."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0] ^ key[1] ^ 0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key: tuple[int, int], n: int) -> np.ndarray:
    """`jax.random.bits(key, (n,), uint32)`: threefry of each flat index."""
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def uniform(key: tuple[int, int], n: int) -> np.ndarray:
    """`jax.random.uniform(key, (n,), float32, nextafter(-1, 0), 1)`."""
    bits = random_bits(key, n)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(F32) - F32(1)
    lo = np.nextafter(F32(-1), F32(0))
    return np.maximum(lo, floats * (F32(1) - lo) + lo)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding (the product is exact in float64; a
    float64 sum that lands on a float32 midpoint is resolved by its TwoSum
    error)."""
    p = np.asarray(a, F32).astype(np.float64) * np.asarray(b, F32).astype(np.float64)
    c = np.asarray(c, F32).astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(F32)
    diff = s - r.astype(np.float64)
    nb = np.nextafter(r, np.where(diff > 0, F32(np.inf), F32(-np.inf)).astype(F32))
    tie = (diff != 0) & (2 * np.abs(diff) == np.abs(nb.astype(np.float64) - r))
    return np.where(tie & (err * diff > 0), nb, r).astype(F32)


def _horner(x: np.ndarray, coeffs, start) -> np.ndarray:
    """XLA's EvaluatePolynomial after contraction: each step fma(p, x, c)."""
    p = start
    for c in coeffs:
        p = _fma(p, x, F32(c))
    return p


def _logf(y: np.ndarray) -> np.ndarray:
    """XLA's CPU log of y > 0 (Cephes logf), as compiled: frexp to m in [0.5, 1),
    m < sqrt(0.5) folded to 2m - 1 with the exponent lowered, a split Horner
    polynomial, and the exponent's two-part ln 2."""
    y = np.maximum(y, F32(np.finfo(F32).tiny))
    bits = y.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(F32) + F32(1)
    m = ((bits & np.uint32(0x7FFFFF)) | np.uint32(0x3F000000)).view(F32)
    small = m < F32(0.707106781186547524)
    x = (m + F32(-1)) + np.where(small, m, F32(0))
    e = e - np.where(small, F32(1), F32(0))
    z = x * x
    x3 = x * z
    c = [F32(v) for v in _LOG_P]
    t1 = _fma(x, c[0], c[1])
    t2 = _fma(x, c[3], c[4])
    t3 = _fma(x, c[6], c[7])
    t4 = _fma(t1, x, c[2])
    t5 = _fma(t2, x, c[5])
    t6 = _fma(t3, x, c[8])
    t8 = _fma(_fma(t4, x3, t5), x3, t6)
    y = _fma(t8, x3, e * F32(-2.12194440e-4))
    head = _fma(F32(-0.5), z, x)
    return _fma(e, F32(0.693359375), head + y)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's log1p for float32 x in (-1, 0] as the CPU backend compiles it."""
    den = _horner(x, _LOG1P_DEN[1:], x * F32(0) + F32(_LOG1P_DEN[0]))
    num = _horner(x, _LOG1P_NUM[1:], x * F32(0) + F32(_LOG1P_NUM[0]))
    x2 = x * x
    small = _fma(F32(-0.5), x2, (x * x2) * (num / den))
    small = x + small
    return np.where(np.abs(x) < F32(0.41421356237309504880), small, _logf(x + F32(1)))


def erf_inv(u: np.ndarray) -> np.ndarray:
    """XLA's float32 ErfInv (Giles), operation for operation, on u in (-1, 1)."""
    u = np.asarray(u, F32)
    l1p = _log1p(u * -u)
    lt = l1p > F32(-5)
    w = np.where(lt, F32(-2.5) - l1p, np.sqrt(-l1p) + F32(-3))
    coeff = [np.where(lt, F32(a), F32(b)) for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coeff[0]
    for c in coeff[1:]:
        p = _fma(w, p, c)
    return u * np.where(np.abs(u) == F32(1), F32(np.inf), p)


def normal(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.normal(jax.random.PRNGKey(seed), shape)`, float32."""
    n = int(np.prod(shape, dtype=np.int64))
    u = uniform(prng_key(seed), n)
    return (F32(np.sqrt(2)) * erf_inv(u)).reshape(shape)
