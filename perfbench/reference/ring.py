"""Plain arithmetic of the ring Z_q[X]/(X^n + 1) in residue form, for the
benchmark's reference.

Everything here is worked out from the primes and the ring degree that a
configuration file states: the roots of unity, a negacyclic number-theoretic
transform, the fractional encoder of SEAL 2.3 and the centred lift of a
plaintext into the ciphertext modulus.  Residues are torch int64 tensors
``[..., L, n]`` on any device; every product of two residues below 2^30 stays
below 2^60, so ``a * b % p`` is exact.

``Ring(..., mul="float64")`` computes every modular product in float64
instead, which rounds products above 2^53: the precision one step below the
configuration's, used only as the correctness control.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _root_2n(p: int, n: int) -> int:
    """A primitive 2n-th root of unity mod p: psi with psi^n = -1."""
    if (p - 1) % (2 * n):
        raise ValueError(f"{p} is not 1 mod 2n = {2 * n}")
    for g in range(2, p):
        psi = pow(g, (p - 1) // (2 * n), p)
        if pow(psi, n, p) == p - 1:
            return psi
    raise ValueError(f"no 2n-th root of unity mod {p}")


class Ring:
    """The residue ring of one prime chain on one device."""

    def __init__(self, primes, n: int, device="cpu", mul: str = "int64"):
        self.primes = tuple(int(p) for p in primes)
        self.n, self.L = n, len(self.primes)
        self.device = torch.device(device)
        if mul not in ("int64", "float64"):
            raise ValueError(f"mul is int64 or float64, not {mul}")
        self.float_mul = mul == "float64"
        self.p = self._up([[p] for p in self.primes])  # [L, 1]
        self.logn = n.bit_length() - 1
        if 1 << self.logn != n:
            raise ValueError(f"n = {n} is not a power of two")
        psi = [_root_2n(p, n) for p in self.primes]
        ipsi = [pow(s, p - 2, p) for s, p in zip(psi, self.primes)]
        self.twist = self._up([self._powers(s, p, n) for s, p in zip(psi, self.primes)])
        n_inv = [pow(n, p - 2, p) for p in self.primes]
        self.untwist = self._up([[x * n_inv[i] % p for x in self._powers(s, p, n)]
                                 for i, (s, p) in enumerate(zip(ipsi, self.primes))])
        # per stage of length m = 2, 4, ..., n: omega_m^j for j < m/2, omega = psi^2
        self.fwd_w, self.inv_w = [], []
        for s in range(1, self.logn + 1):
            m = 1 << s
            w = [pow(x * x % p, n // m, p) for x, p in zip(psi, self.primes)]
            iw = [pow(x * x % p, n // m, p) for x, p in zip(ipsi, self.primes)]
            self.fwd_w.append(self._up([self._powers(v, p, m // 2)
                                        for v, p in zip(w, self.primes)])[:, None, :])
            self.inv_w.append(self._up([self._powers(v, p, m // 2)
                                        for v, p in zip(iw, self.primes)])[:, None, :])
        rev = [int(format(i, f"0{self.logn}b")[::-1], 2) for i in range(n)] if n > 1 else [0]
        self.bitrev = torch.tensor(rev, dtype=torch.int64, device=self.device)

    @staticmethod
    def _powers(x: int, p: int, count: int) -> list:
        out, v = [], 1
        for _ in range(count):
            out.append(v)
            v = v * x % p
        return out

    def _up(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.int64, device=self.device)

    # --- modular arithmetic ------------------------------------------------

    def mul(self, a: torch.Tensor, b: torch.Tensor, p=None) -> torch.Tensor:
        """a * b mod p for residues below p; p defaults to the primes [L, 1]."""
        p = self.p if p is None else p
        if self.float_mul:
            return torch.remainder(a.to(torch.float64) * b.to(torch.float64),
                                   p.to(torch.float64)).to(torch.int64)
        return a * b % p

    def add(self, a, b, p=None):
        return (a + b) % (self.p if p is None else p)

    def sub(self, a, b, p=None):
        return (a - b) % (self.p if p is None else p)

    def reduce(self, a):
        """Any int64 tensor [..., L, n] to residues in [0, p)."""
        return a % self.p

    def lift(self, small: torch.Tensor) -> torch.Tensor:
        """Signed integers [..., n] to residues [..., L, n]."""
        return small[..., None, :] % self.p

    # --- negacyclic NTT ----------------------------------------------------

    def _cyclic(self, a: torch.Tensor, stages) -> torch.Tensor:
        """Radix-2 decimation in time over the last axis, bit-reversed input."""
        shape, p = a.shape, self.p[:, :, None]
        a = a.index_select(-1, self.bitrev)
        for s, w in enumerate(stages, start=1):
            m = 1 << s
            a = a.reshape(shape[:-1] + (self.n // m, 2, m // 2))
            u, v = a[..., 0, :], self.mul(a[..., 1, :], w, p)
            a = torch.stack((self.add(u, v, p), self.sub(u, v, p)), dim=-2)
        return a.reshape(shape)

    def ntt(self, a: torch.Tensor) -> torch.Tensor:
        """Coefficients [..., L, n] to the evaluation domain, where the
        pointwise product is the negacyclic product."""
        return self._cyclic(self.mul(a, self.twist), self.fwd_w)

    def intt(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(self._cyclic(a, self.inv_w), self.untwist)

    def poly_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.intt(self.mul(self.ntt(a), self.ntt(b)))


class Encoder:
    """SEAL 2.3's fractional encoder with base 2 (``BinaryFractionalEncoder``):
    the integer part's binary digits in x^0, x^1, ...; fractional digit i
    (worth 2^-i) as -x^(n-i); a negative value negates every coefficient;
    coefficients are taken mod t."""

    def __init__(self, t: int, n: int, n_int: int, n_frac: int, base: int = 2):
        if base != 2:
            raise ValueError("the reference encodes in base 2 only")
        if n_int + n_frac > n:
            raise ValueError("integer and fractional digits exceed the ring degree")
        self.t, self.n, self.n_int, self.n_frac = t, n, n_int, n_frac

    def encode(self, value: float) -> np.ndarray:
        coeffs = np.zeros(self.n, dtype=np.int64)
        v = abs(float(value))
        whole = int(math.floor(v))
        frac = v - whole
        k = 0
        while whole:
            coeffs[k] = whole & 1
            whole >>= 1
            k += 1
        if k > self.n_int:
            raise ValueError(f"{value} has more than {self.n_int} integer digits")
        for i in range(1, self.n_frac + 1):
            frac *= 2.0
            d = math.floor(frac)
            frac -= d
            if d:
                coeffs[self.n - i] = -1
        if value < 0:
            coeffs = -coeffs
        return np.mod(coeffs, self.t)

    def lifted(self, coeffs: np.ndarray) -> np.ndarray:
        """Plaintext coefficients in [0, t) to the centred integers that a
        ciphertext operand carries: c >= (t + 1) / 2 stands for c - t."""
        c = np.asarray(coeffs, dtype=np.int64)
        return np.where(c >= (self.t + 1) // 2, c - self.t, c)
