"""Negacyclic number-theoretic transform over RNS limbs (host + device).

The host half is ``fhetpu/core/ntt.py`` without JAX: the same twiddle
tables (``NttTables``), the same NumPy transforms and the same native C++
fast path through the package's own copy, ``fhetpu_torch.native``.  The formulation is unchanged:

* forward: Cooley-Tukey butterflies, natural order in -> bit-reversed out;
* inverse: Gentleman-Sande, bit-reversed in -> natural out, with the final
  n^-1 scaling applied as a Shoup constant multiply.

The device half, ``ntt`` and ``intt``, takes torch uint32 tensors
``[..., L, n]``: a CUDA tensor goes to the hand-written kernel
(``core/ntt_kernel.py``, ``csrc/ntt.cu``), a CPU tensor to the kernel's
plain torch version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native
from . import modops, ntt_kernel


def _bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _find_primitive_2n_root(p: int, n: int) -> int:
    """Smallest-order-compliant psi with psi^n == -1 mod p (deterministic)."""
    order = 2 * n
    assert (p - 1) % order == 0
    exp = (p - 1) // order
    g = 2
    while True:
        psi = pow(g, exp, p)
        if pow(psi, n, p) == p - 1:
            return psi
        g += 1


class NttTables:
    """Per-(base, n) twiddle tables, stacked over limbs: arrays [L, n]."""

    def __init__(self, primes, n: int):
        self.primes = tuple(int(p) for p in primes)
        self.n = n
        logn = n.bit_length() - 1
        assert 1 << logn == n
        L = len(self.primes)
        psi_br = np.zeros((L, n), dtype=np.uint32)
        ipsi_br = np.zeros((L, n), dtype=np.uint32)
        n_inv = np.zeros((L, 1), dtype=np.uint32)
        for li, p in enumerate(self.primes):
            psi = _find_primitive_2n_root(p, n)
            ipsi = pow(psi, p - 2, p)
            pw, ipw = 1, 1
            psis = np.zeros(n, dtype=np.uint64)
            ipsis = np.zeros(n, dtype=np.uint64)
            for i in range(n):
                psis[i] = pw
                ipsis[i] = ipw
                pw = pw * psi % p
                ipw = ipw * ipsi % p
            for i in range(n):
                j = _bit_reverse(i, logn)
                psi_br[li, i] = psis[j]
                ipsi_br[li, i] = ipsis[j]
            n_inv[li, 0] = pow(n, p - 2, p)
        p_arr, mu, shift = modops.barrett_params(self.primes)
        self.p = p_arr  # [L,1] uint32
        self.mu = mu
        self.shift = shift
        self.psi_br = psi_br
        self.psi_br_shoup = modops.shoup(psi_br, p_arr.astype(np.uint64))
        self.ipsi_br = ipsi_br
        self.ipsi_br_shoup = modops.shoup(ipsi_br, p_arr.astype(np.uint64))
        self.n_inv = n_inv
        self.n_inv_shoup = modops.shoup(n_inv, p_arr.astype(np.uint64))
        self.logn = logn


@functools.lru_cache(maxsize=None)
def get_tables(primes: tuple, n: int) -> NttTables:
    return NttTables(primes, n)


# ---------------------------------------------------------------------------
# Device: torch uint32 [..., L, n], kernel on CUDA, plain torch on the CPU.
# ---------------------------------------------------------------------------


def ntt(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Forward NTT over the last axis of a uint32 tensor [..., L, n]."""
    return ntt_kernel.ntt_forward(x, ntt_kernel.device_tables(tables, x.device))


def intt(x: torch.Tensor, tables: NttTables) -> torch.Tensor:
    """Inverse NTT over the last axis of a uint32 tensor [..., L, n]."""
    return ntt_kernel.ntt_inverse(x, ntt_kernel.device_tables(tables, x.device))


# ---------------------------------------------------------------------------
# Host (NumPy): staged butterflies, or the native C++ kernels when built.
# ---------------------------------------------------------------------------


def _mulmod_shoup(x, w, ws, p):
    q = (x.astype(np.uint64) * ws.astype(np.uint64)) >> np.uint64(32)
    r = (x.astype(np.uint64) * w.astype(np.uint64) - q * p.astype(np.uint64)) & np.uint64(
        0xFFFFFFFF
    )
    r = np.where(r >= p, r - p, r)
    return r.astype(np.uint32)


def _addmod(a, b, p):
    r = a + b
    return np.where(r >= p, r - p, r)


def _submod(a, b, p):
    r = a + p - b
    return np.where(r >= p, r - p, r)


def _ntt_impl(x: np.ndarray, tables: NttTables) -> np.ndarray:
    """Forward negacyclic NTT over the last axis of x [..., L, n]."""
    n, L = tables.n, len(tables.primes)
    p = tables.p.reshape(L, 1, 1)
    a = x
    m, t = 1, n
    for _ in range(tables.logn):
        t //= 2
        a = a.reshape(a.shape[:-1] + (m, 2, t))
        w = tables.psi_br[:, m : 2 * m].reshape(L, m, 1)
        ws = tables.psi_br_shoup[:, m : 2 * m].reshape(L, m, 1)
        u = a[..., 0, :]
        v = _mulmod_shoup(a[..., 1, :], w, ws, p)
        a = np.stack((_addmod(u, v, p), _submod(u, v, p)), axis=-2)
        a = a.reshape(a.shape[:-3] + (2 * m * t,))
        m *= 2
    return a


def _intt_impl(x: np.ndarray, tables: NttTables) -> np.ndarray:
    """Inverse negacyclic NTT over the last axis of x [..., L, n]."""
    n, L = tables.n, len(tables.primes)
    p = tables.p.reshape(L, 1, 1)
    a = x
    t, m = 1, n
    while m > 1:
        h = m // 2
        a = a.reshape(a.shape[:-1] + (h, 2, t))
        w = tables.ipsi_br[:, h : 2 * h].reshape(L, h, 1)
        ws = tables.ipsi_br_shoup[:, h : 2 * h].reshape(L, h, 1)
        u = a[..., 0, :]
        v = a[..., 1, :]
        lo = _addmod(u, v, p)
        hi = _mulmod_shoup(_submod(u, v, p), w, ws, p)
        a = np.stack((lo, hi), axis=-2)
        a = a.reshape(a.shape[:-3] + (2 * h * t,))
        t *= 2
        m = h
    return _mulmod_shoup(a, tables.n_inv, tables.n_inv_shoup, tables.p)


def np_ntt(x: np.ndarray, tables: NttTables) -> np.ndarray:
    """Host forward NTT; uses the native C++ kernels when available
    (fhetpu_torch/native/fastntt.cpp), falling back to vectorized NumPy."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    out = _native_ntt(x, tables, forward=True)
    if out is not None:
        return out
    return _ntt_impl(x, tables)


def np_intt(x: np.ndarray, tables: NttTables) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.uint32)
    out = _native_ntt(x, tables, forward=False)
    if out is not None:
        return out
    return _intt_impl(x, tables)


def np_intt_scaled(x: np.ndarray, tables: NttTables,
                   scale_u32: np.ndarray) -> np.ndarray:
    """Host inverse NTT with a per-limb scalar folded into the final n^-1
    scaling pass: returns INTT(x) * scale mod p at zero extra passes.
    Used by the decrypt fast path to fold qhat_inv (BFV CRT decode) into
    the transform.  scale_u32: uint32 [L]."""

    x = np.ascontiguousarray(x, dtype=np.uint32)
    L, n = len(tables.primes), tables.n
    scale = np.asarray(scale_u32, dtype=np.uint64).reshape(-1)
    assert scale.shape == (L,)
    nlib = native.lib()
    if nlib is not None and x.shape[-2:] == (L, n):
        import ctypes

        u32p = ctypes.POINTER(ctypes.c_uint32)
        p64 = tables.p.astype(np.uint64).reshape(-1)
        ninv = (tables.n_inv.astype(np.uint64).reshape(-1) * scale) % p64
        ninv_sh = (ninv << np.uint64(32)) // p64
        out = x.copy()
        flat = out.reshape(-1, L, n)
        nlib.fastntt_inverse(
            out.ctypes.data_as(u32p), flat.shape[0], L, n,
            np.ascontiguousarray(tables.ipsi_br).ctypes.data_as(u32p),
            np.ascontiguousarray(tables.ipsi_br_shoup).ctypes.data_as(u32p),
            np.ascontiguousarray(tables.p.reshape(-1)).ctypes.data_as(u32p),
            np.ascontiguousarray(ninv.astype(np.uint32)).ctypes.data_as(u32p),
            np.ascontiguousarray(
                ninv_sh.astype(np.uint32)).ctypes.data_as(u32p),
            native.default_threads(),
        )
        return out
    y = np_intt(x, tables)
    p64 = tables.p.astype(np.uint64).reshape(-1, 1)
    return ((y.astype(np.uint64) * scale.reshape(-1, 1)) % p64).astype(
        np.uint32)


def np_pointwise_mulmod(a: np.ndarray, b: np.ndarray, tables: NttTables) -> np.ndarray:
    """Host pointwise a*b mod p over [..., L, n] with b either [..., L, n]
    (matching) or [L, n] (broadcast); native threaded kernel when available."""

    L, n = len(tables.primes), tables.n
    nlib = native.lib()
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    if nlib is not None and a.shape[-2:] == (L, n) and b.shape in ((L, n), a.shape):
        import ctypes

        u32p = ctypes.POINTER(ctypes.c_uint32)
        out = np.empty_like(a)
        flat = a.reshape(-1, L, n)
        batch = flat.shape[0]
        b_batch = 1 if b.shape == (L, n) else batch
        p_arr = np.ascontiguousarray(tables.p.reshape(-1))
        nlib.fastntt_pointwise_mulmod(
            a.ctypes.data_as(u32p), b.ctypes.data_as(u32p),
            out.ctypes.data_as(u32p), batch, b_batch, L, n,
            p_arr.ctypes.data_as(u32p), native.default_threads(),
        )
        return out
    p64 = tables.p.astype(np.uint64)
    return (a.astype(np.uint64) * b.astype(np.uint64) % p64).astype(np.uint32)


def _native_ntt(x: np.ndarray, tables: NttTables, forward: bool):

    L = len(tables.primes)
    if x.shape[-2] != L or x.shape[-1] != tables.n:
        return None
    nlib = native.lib()
    if nlib is None:
        return None
    import ctypes

    u32p = ctypes.POINTER(ctypes.c_uint32)

    def ptr(a):
        return a.ctypes.data_as(u32p)

    out = x.copy()
    flat = out.reshape(-1, L, tables.n)
    batch = flat.shape[0]
    threads = native.default_threads()
    p_arr = np.ascontiguousarray(tables.p.reshape(-1))
    if forward:
        nlib.fastntt_forward(
            ptr(flat), batch, L, tables.n,
            ptr(tables.psi_br), ptr(tables.psi_br_shoup), ptr(p_arr), threads,
        )
    else:
        nlib.fastntt_inverse(
            ptr(flat), batch, L, tables.n,
            ptr(tables.ipsi_br), ptr(tables.ipsi_br_shoup), ptr(p_arr),
            ptr(np.ascontiguousarray(tables.n_inv.reshape(-1))),
            ptr(np.ascontiguousarray(tables.n_inv_shoup.reshape(-1))),
            threads,
        )
    return out
