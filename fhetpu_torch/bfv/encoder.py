"""SEAL-2.3-compatible fractional plaintext encoder (SURVEY.md C2).

The port's own copy of ``fhetpu/bfv/encoder.py`` (tests hold the two
equal), so that fhetpu_torch imports nothing of ``fhetpu``.

Encodes a real number into a plaintext polynomial in Z_t[x]/(x^n+1):
the integer part's base-b digits occupy low-degree coefficients x^0..,
and the fractional part's digits occupy the *top* coefficients with a sign
flip -- b^-i is represented by -x^(n-i), since x^(n-i) * x^i = x^n == -1.

Reference semantics: FractionalEncoder(plain_modulus, poly_modulus,
n_number_coeffs=100, n_fractional_coeffs=100, base=2) constructed at
client_jpeg.cpp:116 with defaults from fhe_image.h:22-24.  For base 2 the
digit expansion is the plain binary expansion of |v|, truncated toward zero
after n_fractional digits; negative inputs negate every coefficient mod t.
Decoding interprets every coefficient as a *balanced* residue (c >= (t+1)/2
means c - t) so values survive homomorphic arithmetic, and returns a double.

The same wrap-at-small-t failure mode as the reference (RMS blowup for
pmod in {11,31,101}, benchmark/results.txt) falls out of the mod-t
arithmetic automatically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class Plaintext:
    """A polynomial in Z_t[x]/(x^n+1); coeffs int64 in [0, t)."""

    coeffs: np.ndarray
    t: int

    @property
    def n(self) -> int:
        return len(self.coeffs)

    def balanced(self) -> np.ndarray:
        """Signed (centered) coefficient view: values in [-(t-1)//2 .. t//2]."""
        thr = (self.t + 1) // 2
        c = self.coeffs.astype(np.int64)
        return np.where(c >= thr, c - self.t, c)

    def __eq__(self, other):
        return (
            isinstance(other, Plaintext)
            and self.t == other.t
            and np.array_equal(self.coeffs, other.coeffs)
        )


class FractionalEncoder:
    def __init__(
        self,
        t: int,
        n: int,
        n_number_coeffs: int = 100,
        n_fractional_coeffs: int = 100,
        base: int = 2,
    ):
        if base < 2:
            raise ValueError("base must be >= 2")
        if n_number_coeffs + n_fractional_coeffs > n:
            raise ValueError("integer+fractional coefficients exceed ring degree")
        self.t = t
        self.n = n
        self.n_int = n_number_coeffs
        self.n_frac = n_fractional_coeffs
        self.base = base

    # -- digit expansion helpers -----------------------------------------

    def _int_digits(self, v: int) -> list:
        """Digits of non-negative integer v; base 2 -> {0,1}; odd base ->
        balanced digits; even base > 2 -> standard digits 0..base-1."""
        b = self.base
        digits = []
        if b == 2 or b % 2 == 0:
            while v:
                digits.append(v % b)
                v //= b
        else:
            half = (b - 1) // 2
            while v:
                d = v % b
                if d > half:
                    d -= b
                digits.append(d)
                v = (v - d) // b
        if len(digits) > self.n_int:
            raise ValueError("integer part does not fit in n_number_coeffs")
        return digits

    def encode(self, value: float) -> Plaintext:
        coeffs = np.zeros(self.n, dtype=np.int64)
        if value == 0.0:
            return Plaintext(coeffs, self.t)
        neg = value < 0
        v = abs(float(value))
        int_part = int(math.floor(v))
        frac = v - int_part
        for k, d in enumerate(self._int_digits(int_part)):
            coeffs[k] = d
        # fractional digits: d_i at exponent n-i, negated
        b = float(self.base)
        for i in range(1, self.n_frac + 1):
            frac *= b
            d = int(math.floor(frac))
            frac -= d
            if d:
                coeffs[self.n - i] = -d
        if neg:
            coeffs = -coeffs
        return Plaintext(np.mod(coeffs, self.t), self.t)

    def decode(self, plain: Plaintext) -> float:
        """Balanced interpretation over the encoder's two ring sections:
        integer part = low n_number_coeffs exponents, fraction = top
        n_fractional_coeffs (negated).  Coefficients BETWEEN the sections are
        ignored -- that is where multiplication truncation-tails land (e.g.
        products of two 100-digit fractions have digits at exponents
        n-101..n-200 worth < base^-100), matching SEAL 2.3's sectioned
        FractionalEncoder semantics."""
        assert plain.t == self.t and plain.n == self.n
        bal = plain.balanced()
        b = float(self.base)
        value = 0.0
        # integer section (descending so magnitudes add stably)
        for k in range(self.n_int - 1, -1, -1):
            if bal[k]:
                value += float(bal[k]) * (b ** k)
        for i in range(1, self.n_frac + 1):
            c = bal[self.n - i]
            if c:
                value -= float(c) * (b ** (-i))
        return value

    # -- batch versions (vectorized over many scalars) -------------------

    def encode_batch(self, values: np.ndarray) -> np.ndarray:
        """Encode a float array [...]-> int64 coeff array [..., n] mod t.

        Vectorized base-2 fast path (the pipelines encode thousands of pixel
        values at once: reference hot loop client_jpeg.cpp:140-165).
        """
        values = np.asarray(values, dtype=np.float64)
        flat = values.reshape(-1)
        out = np.zeros((flat.size, self.n), dtype=np.int64)
        if self.base != 2:
            for i, v in enumerate(flat):
                out[i] = self.encode(float(v)).coeffs
            return out.reshape(values.shape + (self.n,))
        neg = flat < 0
        av = np.abs(flat)
        ip = np.floor(av)
        fr = av - ip
        # integer bits
        ip = ip.astype(np.int64)
        maxbits = int(ip.max()).bit_length() if flat.size else 0
        if maxbits > self.n_int:
            raise ValueError("integer part does not fit in n_number_coeffs")
        for k in range(maxbits):
            out[:, k] = (ip >> k) & 1
        # fractional bits at exponents n-i, negated
        for i in range(1, self.n_frac + 1):
            fr *= 2.0
            d = np.floor(fr)
            fr -= d
            out[:, self.n - i] = -d.astype(np.int64)
        out[neg] = -out[neg]
        return np.mod(out, self.t).reshape(values.shape + (self.n,))

    def decode_batch(self, coeffs: np.ndarray) -> np.ndarray:
        """Decode [..., n] coeff arrays mod t -> float64 [...]. Vectorized.
        Sectioned like ``decode``: low n_int exponents + top n_frac only."""
        thr = (self.t + 1) // 2
        c = coeffs.astype(np.int64)
        bal = np.where(c >= thr, c - self.t, c).astype(np.float64)
        b = float(self.base)
        # saturate powers beyond float64 range (relevant only for huge bases)
        exps = np.minimum(np.arange(self.n_int, dtype=np.float64), 1000.0)
        pow_int = b ** exps
        ints = bal[..., : self.n_int] @ pow_int
        pow_frac = b ** (-np.arange(1, self.n_frac + 1, dtype=np.float64))
        fracs = bal[..., : self.n - self.n_frac - 1 : -1] @ pow_frac
        return ints - fracs
