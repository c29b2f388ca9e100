"""Plaintext golden model: exact Z_t[x]/(x^n+1) arithmetic.

The port's own copy of ``fhetpu/bfv/golden.py`` (tests hold the two
equal); ``chip_smoke.py`` uses it as its oracle on the GPU machine.

This is the framework's correctness oracle (SURVEY.md section 4): every
homomorphic pipeline, run with enough noise budget, must decrypt to exactly
the result of these mod-t polynomial ops applied to the encoded inputs.
The reference's analog is the plaintext AAN DCT (fhe_image.h:399-491) used
for eyeball comparison; we make the oracle exact and assertable.

Coefficients are int64 in [0, t); products fit since n * t^2 < 2^63 for
all supported t (t <= ~2^20 at n <= 32768).
"""

from __future__ import annotations

import numpy as np


def add(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    return (a + b) % t


def sub(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    return (a - b) % t


def neg(a: np.ndarray, t: int) -> np.ndarray:
    return (-a) % t


def mult(a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
    """Negacyclic product over the last axis (exact, vectorized).

    Uses an FFT fast path for n >= 512: coefficients are taken in [0, t), so
    intermediate magnitudes are < n*t^2 (~2^40 for n=4096, t=2^14), leaving
    ~11 bits of float64 headroom over the FFT rounding error; we assert a
    safety margin and round to the nearest integer."""
    n = a.shape[-1]
    if n >= 512 and float(n) * float(t - 1) ** 2 < 2 ** 48:
        bound = float(n) * float(t - 1) ** 2
        m = 2 * n
        fa = np.fft.rfft(a.astype(np.float64), m, axis=-1)
        fb = np.fft.rfft(b.astype(np.float64), m, axis=-1)
        full = np.fft.irfft(fa * fb, m, axis=-1)
        full_i = np.rint(full).astype(np.int64)
        lo = full_i[..., :n]
        hi = full_i[..., n:]  # [n] entries; index 2n-1 is zero padding
        return (lo - hi) % t
    full = _polymul_last(a, b)  # [..., 2n-1]
    lo = full[..., :n]
    hi = np.zeros_like(lo)
    hi[..., : n - 1] = full[..., n:]
    return (lo - hi) % t


def mult_sparse(a: np.ndarray, b_coeffs: np.ndarray, t: int) -> np.ndarray:
    """Negacyclic a*b mod t where b is sparse (e.g. an encoded scalar with
    ~100 nonzero +-1 coefficients): cost n * nnz instead of n^2."""
    n = a.shape[-1]
    (positions,) = np.nonzero(b_coeffs)
    acc = np.zeros(np.broadcast_shapes(a.shape), dtype=np.int64)
    for p in positions:
        v = int(b_coeffs[p])
        if p == 0:
            acc += v * a
        else:
            rolled = np.concatenate([-a[..., n - p :], a[..., : n - p]], axis=-1)
            acc += v * rolled
        acc %= t
    return acc % t


class GoldenEvaluator:
    """Duck-typed stand-in for bfv.evaluator.Evaluator operating on plaintext
    coefficient arrays [..., n] mod t.  The pipeline network functions
    (pipelines.jpeg_encode.rgb_to_ycc / dct8x8) run unchanged against it,
    giving the exact mod-t result the encrypted pipeline must decrypt to
    (the framework's bit-exactness oracle, SURVEY.md section 4)."""

    def __init__(self, encoder):
        self.encoder = encoder
        self.t = encoder.t
        self._cache = {}

    def encode(self, value: float) -> np.ndarray:
        key = float(value)
        if key not in self._cache:
            self._cache[key] = self.encoder.encode(value).coeffs
        return self._cache[key]

    def add(self, a, b):
        return add(a, b, self.t)

    def sub(self, a, b):
        return sub(a, b, self.t)

    def negate(self, a):
        return neg(a, self.t)

    def add_plain(self, a, op):
        return add(a, op, self.t)

    def sub_plain(self, a, op):
        return sub(a, op, self.t)

    def multiply_plain(self, a, op):
        return mult_sparse(a, op, self.t)

    def multiply(self, a, b):
        return mult(a, b, self.t)

    def square(self, a):
        return mult(a, a, self.t)

    def lincomb(self, terms):
        acc = None
        for x, op in terms:
            term = x if op is None else mult_sparse(x, op, self.t)
            acc = term if acc is None else add(acc, term, self.t)
        return acc


def _polymul_last(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = a.shape[-1]
    if a.ndim == 1 and b.ndim == 1:
        return np.convolve(a, b)
    out_shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (2 * n - 1,)
    out = np.zeros(out_shape, dtype=np.int64)
    a_b = np.broadcast_to(a, out_shape[:-1] + (n,))
    b_b = np.broadcast_to(b, out_shape[:-1] + (n,))
    for idx in np.ndindex(out_shape[:-1]):
        out[idx] = np.convolve(a_b[idx], b_b[idx])
    return out
