"""NTT-friendly prime generation and default coefficient-modulus tables.

The port's own copy of ``fhetpu/core/primes.py`` (tests hold the two
equal), so that fhetpu_torch imports nothing of ``fhetpu``.

Replacement for the reference's SEAL 2.3 ``coeff_modulus_128(n)``
defaults (used at homo/client_jpeg.cpp:83).  SEAL 2.3 ships
fixed prime lists whose *total* bit counts at 128-bit security are::

    n=1024 -> 27 bits     n=2048 -> 54 bits     n=4096  -> 109 bits
    n=8192 -> 218 bits    n=16384 -> 438 bits   n=32768 -> 881 bits

We regenerate our own RNS prime chains with the same (or one bit lower) total
bit budget -- security is monotone in smaller q -- but constrained for the TPU:

* every prime p satisfies 2^26 < p < 2^30 so that a*b < 2^60 fits the
  32-bit-limb Barrett reduction in :mod:`fhetpu.core.modops`;
* every prime is NTT-friendly for all supported ring degrees:
  p == 1 (mod 2^16), i.e. 2n | p-1 for every n <= 32768.

The generator is deterministic (largest qualifying primes below each bound,
skipping duplicates), so every host in a pod slice derives identical tables.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

# total bits of q at 128-bit security, per ring degree (SEAL 2.3 defaults).
SEAL23_TOTAL_BITS = {
    1024: 27,
    2048: 54,
    4096: 109,
    8192: 218,
    16384: 438,
    32768: 881,
}

# all primes are == 1 mod 2^16 so a single prime pool serves every n <= 32768
NTT_MOD = 1 << 16

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers our < 2^60 needs)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(bits: int, count: int, exclude: Sequence[int] = ()) -> List[int]:
    """Largest ``count`` primes p with bitlen(p)==bits and p == 1 mod 2^16.

    Deterministic descending search from 2^bits.
    """
    if not (17 <= bits <= 30):
        raise ValueError(f"prime bit-size {bits} outside supported range [17,30]")
    out: List[int] = []
    excl = set(exclude)
    # start at the largest value < 2^bits congruent to 1 mod 2^16
    p = ((1 << bits) - 1) // NTT_MOD * NTT_MOD + 1
    if p >= (1 << bits):
        p -= NTT_MOD
    while len(out) < count:
        if p < (1 << (bits - 1)):
            raise RuntimeError(f"exhausted {bits}-bit NTT primes")
        if p not in excl and is_prime(p):
            out.append(p)
        p -= NTT_MOD
    return out


def _split_bits(total: int, lo: int = 27, hi: int = 30) -> List[int]:
    """Split a total bit budget into per-prime bit sizes within [lo, hi].

    Greedy: as few primes as possible at size<=hi, remainder absorbed by
    shrinking individual primes (never below lo).
    """
    count = -(-total // hi)  # ceil
    if count * lo > total:
        raise ValueError(f"cannot split {total} bits into primes of >= {lo} bits")
    sizes = []
    remaining = total
    for i in range(count):
        left = count - i - 1
        take = min(hi, remaining - left * lo)
        sizes.append(take)
        remaining -= take
    assert remaining == 0 and all(lo <= s <= hi for s in sizes)
    return sizes


@functools.lru_cache(maxsize=None)
def default_coeff_modulus_128(n: int) -> tuple:
    """TPU-native analog of SEAL 2.3 ``coeff_modulus_128(n)``.

    Returns a tuple of NTT-friendly primes whose product has at most the
    SEAL 2.3 default total bit count for ring degree ``n`` (same 128-bit
    security level, slightly smaller q).
    """
    if n not in SEAL23_TOTAL_BITS:
        raise ValueError(f"no default coeff modulus for n={n}")
    total = SEAL23_TOTAL_BITS[n]
    if total <= 30:
        # single-prime ring (n=1024); use a 27-bit prime like SEAL's 27 bits
        return tuple(gen_ntt_primes(total, 1))
    sizes = _split_bits(total)
    primes: List[int] = []
    for b in sorted(set(sizes)):
        need = sizes.count(b)
        primes.extend(gen_ntt_primes(b, need, exclude=primes))
    return tuple(sorted(primes, reverse=True))


@functools.lru_cache(maxsize=None)
def native_coeff_modulus_128(n: int) -> tuple:
    """fhetpu-NATIVE parameter chain: the same SEAL 2.3 total modulus bit
    budget for ring degree ``n`` (identical 128-bit security level) split
    into primes of <= 28 bits, so every prime leaves >= 16p of u32 headroom
    and the deferred-reduction (lazy) fused server kernel applies at EVERY
    ring degree -- including n=16384, whose SEAL-default chain (30-bit
    primes) forces the strict kernel (docs/server_roofline.md bound chain).

    NOT SEAL-parity: more, smaller primes (e.g. L=16 instead of 15 at
    n=16384).  Bit-exactness and grid-parity claims against the reference
    always use ``default_coeff_modulus_128``; this chain is an opt-in
    throughput mode (bench.py ``native28`` rows).
    """
    if n not in SEAL23_TOTAL_BITS:
        raise ValueError(f"no native coeff modulus for n={n}")
    total = SEAL23_TOTAL_BITS[n]
    if total <= 30:
        return tuple(gen_ntt_primes(min(total, 28), 1))
    sizes = _split_bits(total, lo=27, hi=28)
    primes: List[int] = []
    for b in sorted(set(sizes)):
        need = sizes.count(b)
        primes.extend(gen_ntt_primes(b, need, exclude=primes))
    return tuple(sorted(primes, reverse=True))


@functools.lru_cache(maxsize=None)
def default_aux_modulus(n: int) -> tuple:
    """Auxiliary RNS base B ∪ {m_sk} for BEHZ ciphertext multiplication.

    len(B) = len(q)+1 primes of 30 bits (so prod(B) > prod(q)·(len(q)+ margins)),
    plus m_sk.  All distinct from the q primes and NTT-friendly.
    """
    q = default_coeff_modulus_128(n)
    count = len(q) + 1
    aux = gen_ntt_primes(30, count + 1, exclude=q)
    b, m_sk = aux[:count], aux[count]
    return tuple(b), m_sk


M_TILDE = 1 << 16  # BEHZ m~ correction modulus (power of two, coprime to all primes)
