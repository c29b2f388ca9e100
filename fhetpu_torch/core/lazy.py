"""Lazy-reduction modular arithmetic for deep elementwise networks: port of
``fhetpu/core/lazy.py`` on torch int64 tensors.

The canonical ops in ``modops`` reduce to [0, p) after every step.  For a
fixed linear network like the homomorphic DCT, residues may instead ride
in [0, m*p) with the bound multiple m tracked statically: every RNS prime
is below 2^30, so a uint32 lane holds values up to M*p with
M = 2^(32 - bitlen(p)), and a conditional subtraction is emitted only where
a bound would pass M.  The reductions fall exactly where fhetpu's do, so
every intermediate holds the value fhetpu holds in its uint32 lane.

Key facts (p < 2^30, beta = 2^32):

* add: a < m1*p, b < m2*p  ->  a+b < (m1+m2)*p, exact while (m1+m2)*p <= beta;
* sub: a - b  ==  a + (m2*p - b), bound (m1+m2)*p;
* Shoup multiply by a constant w < p with w' = floor(w*beta/p): for any
  x < m*p <= beta, r = x*w - floor(x*w'/beta)*p lies in [0, 2p), so lazy
  inputs need no pre-reduction and the product has bound 2;
* reduction: one conditional subtraction of k*p halves the bound.

The values are int64 tensors holding what fhetpu's uint32 lanes hold.
``LazyOps`` checks that headroom argument as it goes: every value it makes
is folded into a running minimum and maximum on the device (no host
synchronisation per op), and ``verify`` asserts that all of them lay in
[0, 2^32).

All ops are elementwise over ``[..., L, n]`` against ``p`` shaped [L, 1].
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .server_kernel import shoup_lazy


@dataclass
class Lazy:
    """A lazily-reduced residue tensor: ``v < m * p`` elementwise."""

    v: torch.Tensor
    m: int  # static bound multiple


class LazyOps:
    """Bound-tracked ops for a fixed prime set.

    ``p``: int64 [L, 1] (broadcast against [..., L, n] data).
    ``max_prime_bits``: the largest bit length of the primes; the largest
    safe multiple is M = 2^(32 - max_prime_bits).
    """

    def __init__(self, p: torch.Tensor, max_prime_bits: int):
        self.p = p
        assert max_prime_bits <= 30
        self.M = 1 << (32 - max_prime_bits)
        self._lo = self._hi = None  # running extremes of every value made

    def checked(self, v: torch.Tensor) -> torch.Tensor:
        """Fold v into the running extremes that ``verify`` checks."""
        lo, hi = torch.aminmax(v)
        if self._lo is None:
            self._lo, self._hi = lo, hi
        else:
            self._lo, self._hi = torch.minimum(self._lo, lo), torch.maximum(self._hi, hi)
        return v

    def verify(self):
        """Assert that every value made so far lay in [0, 2^32), the range of
        the uint32 lanes the bounds stand for (one host synchronisation)."""
        if self._lo is not None:
            lo, hi = int(self._lo), int(self._hi)
            assert 0 <= lo and hi < 1 << 32, f"lazy intermediate outside [0, 2^32): {lo}, {hi}"

    # -- bound management ---------------------------------------------------

    def _csub(self, v, k: int):
        kp = self.p * k
        return self.checked(torch.where(v >= kp, v - kp, v))

    def reduce_to(self, x: Lazy, target: int) -> Lazy:
        """Emit conditional subtractions until x.m <= target."""
        v, m = x.v, x.m
        while m > target:
            # subtracting ceil(m/2)*p maps [0, m*p) -> [0, ceil(m/2)*p)
            half = (m + 1) // 2
            v = self._csub(v, half)
            m = half
        return Lazy(v, m)

    def canon(self, x: Lazy) -> torch.Tensor:
        return self.reduce_to(x, 1).v

    def _fit(self, a: Lazy, b: Lazy) -> tuple:
        """Pre-reduce operands so a.m + b.m <= M (cheapest first)."""
        M = self.M
        while a.m + b.m > M:
            if a.m >= b.m:
                a = self.reduce_to(a, max(1, a.m // 2))
            else:
                b = self.reduce_to(b, max(1, b.m // 2))
        return a, b

    # -- arithmetic ----------------------------------------------------------

    def add(self, a: Lazy, b: Lazy) -> Lazy:
        a, b = self._fit(a, b)
        return Lazy(self.checked(a.v + b.v), a.m + b.m)

    def sub(self, a: Lazy, b: Lazy) -> Lazy:
        """a - b mod p as a + (b.m*p - b.v)."""
        a, b = self._fit(a, b)
        return Lazy(self.checked(a.v + (self.p * b.m - b.v)), a.m + b.m)

    def mul_shoup(self, x: Lazy, w: torch.Tensor, w_shoup: torch.Tensor) -> Lazy:
        """x * w mod p, w a prepared constant < p; lazy in, bound-2 out."""
        if x.m > self.M:  # cannot happen via add/sub, but be safe
            x = self.reduce_to(x, self.M)
        return Lazy(self.checked(shoup_lazy(x.v, w, w_shoup, self.p)), 2)
