"""Modular arithmetic for RNS residues: NumPy host helpers and torch int64 ops.

Host helpers are copied from ``fhetpu/core/modops.py`` (Barrett and Shoup
constants, vectorized NumPy mod-p ops).  The torch ops compute on int64
tensors: every prime is below 2^30, so a product of two residues stays below
2^60 and a Shoup quotient ``x * w_shoup`` below 2^62.  The 16-bit-limb
``mul32``/``mulhi32`` of fhetpu are not carried over: they exist because the
TPU has no 64-bit multiply, and both int64 torch and the CUDA kernels
(``__umulhi``) have one.

Residues cross the stream and kernel boundary as uint32 tensors; PyTorch has
almost no uint32 arithmetic on the CPU, so the torch ops widen to int64
(``to_i64``) and narrow back (``to_u32``).

Conventions: values are canonical in [0, p).  Prime parameter tensors are
shaped to broadcast against data laid out as ``[..., L, n]``: ``p`` is
``[L, 1]``.
"""

from __future__ import annotations

import numpy as np
import torch

_LOW32 = 0xFFFFFFFF


def barrett_params(primes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-prime (p, mu, shift) arrays, shaped [L, 1] for broadcasting."""
    ps = np.asarray(primes, dtype=np.uint64)
    # NB: compute in Python ints -- NEP-50 numpy scalars would wrap the shift
    shifts_i = [int(p).bit_length() - 1 for p in primes]
    shifts = np.array(shifts_i, dtype=np.uint32)
    mus = np.array(
        [(1 << (32 + s)) // int(p) for p, s in zip(primes, shifts_i)], dtype=np.uint32
    )
    if any(int(p) >= (1 << 30) for p in primes):
        raise ValueError("primes must be < 2^30 for 32-bit Barrett reduction")
    return (
        ps.astype(np.uint32).reshape(-1, 1),
        mus.reshape(-1, 1),
        shifts.reshape(-1, 1),
    )


def shoup(w, p):
    """Shoup companion floor(w * 2^32 / p) for constant-operand multiplication."""
    w = np.asarray(w, dtype=np.uint64)
    p = np.asarray(p, dtype=np.uint64)
    return ((w << np.uint64(32)) // p).astype(np.uint32)


# ---------------------------------------------------------------------------
# Host (NumPy): uint64 products fit since p < 2^30.
# ---------------------------------------------------------------------------


def np_barrett_u64(primes):
    """Per-prime (p, mu, shift) as uint64 arrays shaped [L, 1] for
    broadcasting against host [..., L, n] data."""
    p, mu, sh = barrett_params(primes)
    return (p.astype(np.uint64), mu.astype(np.uint64), sh.astype(np.uint64))


def np_mulmod_b(a, b, p64, mu64, sh64):
    """Vectorized host a*b mod p via Barrett -- avoids numpy's scalar u64
    division.  a, b uint64 (or uint32) arrays with values < p < 2^30."""
    x = a.astype(np.uint64) * b.astype(np.uint64)
    q = ((x >> sh64) * mu64) >> np.uint64(32)
    r = x - q * p64
    two_p = p64 << np.uint64(1)
    r = np.where(r >= two_p, r - two_p, r)
    return np.where(r >= p64, r - p64, r)


def np_addmod_b(a, b, p64):
    r = a.astype(np.uint64) + b.astype(np.uint64)
    return np.where(r >= p64, r - p64, r)


def np_mulmod(a, b, p):
    return (a.astype(np.uint64) * b.astype(np.uint64) % np.uint64(p)).astype(np.uint32)


def np_addmod(a, b, p):
    r = a.astype(np.uint64) + b.astype(np.uint64)
    return (r % np.uint64(p)).astype(np.uint32)


def np_submod(a, b, p):
    r = a.astype(np.uint64) + np.uint64(p) - b.astype(np.uint64)
    return (r % np.uint64(p)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Torch: int64 tensors holding canonical residues.
# ---------------------------------------------------------------------------


def to_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 (or int64) residues -> int64; a no-op for int64."""
    return x if x.dtype == torch.int64 else x.to(torch.int64)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 residues in [0, 2^32) -> uint32; a no-op for uint32."""
    return x if x.dtype == torch.uint32 else x.to(torch.uint32)


def addmod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    r = a + b
    return torch.where(r >= p, r - p, r)


def submod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    r = a - b
    return torch.where(r < 0, r + p, r)


def negmod(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, p - a)


def mulmod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """a*b mod p, exact, for int64 a, b in [0, 2^30) and p < 2^30: the
    product stays below 2^60.  fhetpu's Barrett ``mulmod`` returns the same
    value for these operands, canonical or not (the BEHZ steps feed it
    residues of one base reduced by the primes of another)."""
    return a * b % p


def mulmod_shoup(x: torch.Tensor, w: torch.Tensor, w_shoup: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """x*w mod p with w_shoup = floor(w*2^32/p); x, w in [0, p), all int64.

    The same arithmetic as the kernels' 32-bit Shoup product: the quotient
    estimate q = (x*w_shoup) >> 32 leaves x*w - q*p in [0, 2p), taken mod
    2^32, and one conditional subtraction makes it canonical."""
    q = (x * w_shoup) >> 32
    r = (x * w - q * p) & _LOW32
    return torch.where(r >= p, r - p, r)
