"""Plain BFV secret-key encryption and decryption for the benchmark.

The benchmark makes its own key and ciphertexts from the seed, hands them
to the program, and judges the program's outputs by decrypting them here.
A ciphertext of size k is ``[k, L, n]`` residues in coefficient form, and
decrypts as m = round(t/q * (c0 + c1 s + ... + c_{k-1} s^{k-1})) mod t, the
convention of SEAL 2.3 that the program's ct x ct product keeps.
"""

from __future__ import annotations

import numpy as np
import torch

from .ring import Ring

SIGMA = 3.19  # SEAL 2.3's noise standard deviation
ERROR_BOUND = 19  # the gaussian truncated at 6 sigma


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


class SecretKey:
    """A ternary secret and its powers in the evaluation domain."""

    def __init__(self, ring: Ring, t: int, gen: torch.Generator):
        self.ring, self.t = ring, t
        small = torch.randint(-1, 2, (ring.n,), generator=gen, device=ring.device)
        self.small = small
        self.powers = [ring.ntt(ring.lift(small))]  # s^1
        q = _prod(ring.primes)
        self.delta = ring._up([[(q // t) % p] for p in ring.primes])  # [L, 1]
        self.qhat_inv = ring._up([[pow(q // p % p, p - 2, p)] for p in ring.primes])

    def power(self, k: int) -> torch.Tensor:
        while len(self.powers) < k:
            self.powers.append(self.ring.mul(self.powers[-1], self.powers[0]))
        return self.powers[k - 1]

    def encrypt(self, plain: np.ndarray, gen: torch.Generator) -> torch.Tensor:
        """Plaintexts [B, n] (coefficients in [0, t)) -> int64 [B, 2, L, n]:
        c1 = a uniform, c0 = -a s + e + Delta m, m lifted to (-t/2, t/2]."""
        ring = self.ring
        B = plain.shape[0]
        m = torch.from_numpy(np.where(plain >= (self.t + 1) // 2, plain - self.t, plain)
                             .astype(np.int64)).to(ring.device)
        a = torch.randint(0, 1 << 62, (B, ring.L, ring.n), generator=gen,
                          device=ring.device) % ring.p
        e = torch.randn((B, ring.n), generator=gen, device=ring.device, dtype=torch.float64)
        e = (e * SIGMA).round().clamp(-ERROR_BOUND, ERROR_BOUND).to(torch.int64)
        a_s = ring.intt(ring.mul(ring.ntt(a), self.power(1)))
        c0 = ring.sub(ring.add(ring.lift(e), ring.mul(ring.lift(m), self.delta)), a_s)
        return torch.stack((c0, a), dim=1)

    def decrypt(self, cts: torch.Tensor) -> tuple:
        """Ciphertexts [B, k, L, n] -> (plaintexts int64 [B, n] in [0, t),
        the largest distance of t/q * x from its rounding)."""
        ring = self.ring
        cts = ring.reduce(cts.to(torch.int64))
        acc = cts[:, 0]
        if cts.shape[1] > 1:
            ev = ring.mul(ring.ntt(cts[:, 1]), self.power(1))
            for k in range(2, cts.shape[1]):
                ev = ring.add(ev, ring.mul(ring.ntt(cts[:, k]), self.power(k)))
            acc = ring.add(acc, ring.intt(ev))
        # t x / q = sum_i y_i t / p_i - (an integer) t, y_i = x_i (q/p_i)^-1 mod p_i
        y = ring.mul(acc, self.qhat_inv)
        whole = (y * self.t) // ring.p  # [B, L, n], exact: t y < 2^44
        part = ((y * self.t) % ring.p).to(torch.float64) / ring.p.to(torch.float64)
        frac = part.sum(dim=-2)
        near = frac.round()
        dist = float((frac - near).abs().max()) if frac.numel() else 0.0
        m = (whole.sum(dim=-2) + near.to(torch.int64)) % self.t
        return m, dist
