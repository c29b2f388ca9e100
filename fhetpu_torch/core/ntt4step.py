"""Four-step negacyclic NTT as int8 digit-plane matrix products: port of
``fhetpu/core/ntt4step.py``.

The length-n transform factors over n = A*B (the polynomial viewed as
X[i1, i0], i = A*i1 + i0) into

  forward:  OUT = (M1 @ X  *  T) @ M2^T
  inverse:  OUT = M1i @ ((D @ M2i^T) * Ti)

with per-prime constant matrices M1 [B, B], M2 [A, A] and an elementwise
twiddle T [B, A], all mod p, with the bit-reversed input/output conventions
of ``core/ntt.py`` folded into the constants, so ``ntt4`` gives the NTT
kernels' bits.  ``FourStepTables`` holds fhetpu's constants, value for value.

Each operand is split into NDIG = 4 signed radix-256 digit planes (int8);
each digit class P_s = sum_{j+k=s} M_j @ X_k is made of int8 x int8 -> int32
products through ``torch._int_mm``, which reaches the card's int8 tensor
cores (and runs on the CPU).  One product per limb and step covers all 16
digit pairs: the 4 planes of the constant are stacked along its free axis
and the 4 planes of the data along theirs, which also meets ``_int_mm``'s
shape rules (more than 16 rows, depth and width multiples of 8) at every
supported n.  |P_s| <= 4 * 128 * 128^2 = 2^23, exact in int32.

Recombination ports the math, not fhetpu's 96-bit emulation (which exists
because the TPU has no 64-bit integers): in int64 each class partial is
reduced mod p and weighted by 2^(8s) mod p, which gives the residue of
sum_s P_s 2^(8s), the value fhetpu's ``_combine`` reduces.  Like fhetpu's,
the module is measured evidence (``bench/core.py``'s ``ntt_sweep``) and is
not wired into the evaluator.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modops
from .ntt import NttTables, _bit_reverse, _find_primitive_2n_root

NDIG = 4  # signed radix-256 digit planes for 30-bit values
N_CLASSES = 2 * NDIG - 1


def _factor(n: int) -> tuple[int, int]:
    """n = A*B with B the contraction size of stage 1 (64 or 128)."""
    logn = n.bit_length() - 1
    logb = min(7, logn - (logn // 2))  # e.g. 4096 -> B=64, A=64
    if logn - logb > 7:
        logb = logn - 7
    return 1 << (logn - logb), 1 << logb  # (A, B)


def _digits_balanced_np(x: np.ndarray) -> np.ndarray:
    """uint32 -> int8 planes [NDIG, ...]: x = sum_j d_j 256^j, d in [-128,127]."""
    v = x.astype(np.int64)
    planes = []
    for _ in range(NDIG):
        u = v & 255
        c = u >= 128
        planes.append((u - 256 * c).astype(np.int8))
        v = (v >> 8) + c
    assert np.all(v == 0), "value exceeded NDIG signed radix-256 digits"
    return np.stack(planes)


def digits_balanced(x: torch.Tensor) -> torch.Tensor:
    """Device digit split (fhetpu's ``_digits_balanced_jnp``): residues
    [...] (uint32 or int64, below 2^31) -> int8 [NDIG, ...]."""
    v = modops.to_i64(x)
    planes = []
    for _ in range(NDIG):
        u = v & 255
        c = (u >= 128).to(torch.int64)
        planes.append((u - 256 * c).to(torch.int8))
        v = (v >> 8) + c
    return torch.stack(planes)


def _pow_table(g: int, p: int, count: int) -> np.ndarray:
    """[g^0, g^1, ..., g^(count-1)] mod p as uint64."""
    out = np.empty(count, dtype=np.uint64)
    acc = 1
    for e in range(count):
        out[e] = acc
        acc = acc * g % p
    return out


class FourStepTables:
    """Per-(primes, n) constants: digit planes of M1/M2 (and inverses),
    twiddles with Shoup companions, and the weights 2^(8s) mod p of the
    digit classes.  The matrices and twiddles are fhetpu's, computed from
    power tables instead of one ``pow`` per entry."""

    def __init__(self, tables: NttTables):
        n = tables.n
        A, B = _factor(n)
        self.n, self.A, self.B = n, A, B
        logb = B.bit_length() - 1
        loga = A.bit_length() - 1
        primes = tables.primes
        L = len(primes)

        revb = np.array([_bit_reverse(i, logb) for i in range(B)], dtype=np.int64)
        reva = np.array([_bit_reverse(i, loga) for i in range(A)], dtype=np.int64)
        ib, ia = np.arange(B, dtype=np.int64), np.arange(A, dtype=np.int64)

        m1 = np.zeros((L, B, B), dtype=np.uint32)
        m2 = np.zeros((L, A, A), dtype=np.uint32)
        tw = np.zeros((L, B, A), dtype=np.uint32)
        m1i = np.zeros((L, B, B), dtype=np.uint32)
        m2i = np.zeros((L, A, A), dtype=np.uint32)
        twi = np.zeros((L, B, A), dtype=np.uint32)
        for li, p in enumerate(primes):
            psi = _find_primitive_2n_root(p, n)
            ipsi = pow(psi, p - 2, p)
            ninv = pow(n, p - 2, p)
            # psi and psi^-1 have order 2n; w = psi^2 and w^-1 order n
            pp, ipp = _pow_table(psi, p, 2 * n), _pow_table(ipsi, p, 2 * n)
            P = np.uint64(p)

            def w(e):  # w^e = psi^(2e)
                return pp[(2 * e) % (2 * n)]

            def iw(e):
                return ipp[(2 * e) % (2 * n)]

            # forward: M1'[k1, i1] = psi^(A i1) * wA^(i1 * revb[k1])
            m1[li] = w(A * np.outer(revb, ib)) * pp[A * ib][None, :] % P
            # T[k1, i0] = w^(i0 * revb[k1]) * psi^i0
            tw[li] = w(np.outer(revb, ia)) * pp[ia][None, :] % P
            # M2[k0, i0] = wB^(i0 * reva[k0])
            m2[li] = w(B * np.outer(reva, ia))
            # inverse: M2i[i0, v] = iwB^(i0 * reva[v])
            m2i[li] = iw(B * np.outer(ia, reva))
            # Ti[a, i0] = iw^(i0 * revb[a]) * ipsi^i0 * n^-1
            twi[li] = iw(np.outer(revb, ia)) * ipp[ia][None, :] % P * np.uint64(ninv) % P
            # M1i[i1, a] = ipsi^(A i1) * iwA^(i1 * revb[a])
            m1i[li] = iw(A * np.outer(ib, revb)) * ipp[A * ib][:, None] % P

        p64 = tables.p.astype(np.uint64)  # [L, 1]
        self.primes = primes
        self.p = tables.p
        self.m1_dig = _digits_balanced_np(m1)  # [NDIG, L, B, B] int8
        self.m2_dig = _digits_balanced_np(m2)
        self.m1i_dig = _digits_balanced_np(m1i)
        self.m2i_dig = _digits_balanced_np(m2i)
        self.tw = tw
        self.tw_shoup = modops.shoup(tw, p64.reshape(L, 1, 1))
        self.twi = twi
        self.twi_shoup = modops.shoup(twi, p64.reshape(L, 1, 1))
        # 2^(8s) mod p for each digit class s: [N_CLASSES, L]
        self.class_weights = np.array(
            [[(1 << (8 * s)) % int(q) for q in primes] for s in range(N_CLASSES)],
            dtype=np.int64)
        self._on: dict = {}

    def on(self, device) -> dict:
        """The constants as tensors on ``device``, uploaded once: the digit
        planes stacked for ``_int_mm`` (constants on the left as [NDIG*R, C]
        per limb, on the right as [C, NDIG*R] per limb), the twiddles as
        int64 [L, B, A], the moduli [L, 1, 1] and the class weights
        [N_CLASSES, 1, L, 1, 1]."""
        device = torch.device(device)
        if device not in self._on:
            def t(a, dtype=None):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

            def left(d):  # [NDIG, L, R, C] -> [L, NDIG*R, C]
                ndig, L, R, C = d.shape
                return t(d.transpose(1, 0, 2, 3).reshape(L, ndig * R, C))

            def right(d):  # [NDIG, L, R, C] -> [L, C, NDIG*R]: M^T's planes side by side
                ndig, L, R, C = d.shape
                return t(d.transpose(1, 3, 0, 2).reshape(L, C, ndig * R))

            L = len(self.primes)
            self._on[device] = {
                "m1": left(self.m1_dig), "m1i": left(self.m1i_dig),
                "m2": right(self.m2_dig), "m2i": right(self.m2i_dig),
                "tw": t(self.tw, torch.int64), "tw_shoup": t(self.tw_shoup, torch.int64),
                "twi": t(self.twi, torch.int64), "twi_shoup": t(self.twi_shoup, torch.int64),
                "p": t(self.p.reshape(L, 1, 1), torch.int64),
                "w": t(self.class_weights.reshape(N_CLASSES, 1, L, 1, 1)),
            }
        return self._on[device]


@functools.lru_cache(maxsize=None)
def get_fourstep(primes: tuple, n: int) -> FourStepTables:
    return FourStepTables(NttTables(primes, n))


def _contract_left(mst: torch.Tensor, xd: torch.Tensor) -> torch.Tensor:
    """Digit classes of out[z, l, a, c] = sum_r M[l, a, r] X[z, l, r, c].

    mst [L, NDIG*R, Rin] int8 (constant planes stacked along a);
    xd [NDIG, z, L, Rin, C] int8.  Returns int32 [N_CLASSES, z, L, R, C]."""
    ndig, z, L, Rin, C = xd.shape
    R = mst.shape[1] // ndig
    out = torch.zeros((N_CLASSES, z, L, R, C), dtype=torch.int32, device=xd.device)
    for li in range(L):
        rhs = xd[:, :, li].permute(2, 0, 1, 3).reshape(Rin, ndig * z * C)
        prod = torch._int_mm(mst[li], rhs).view(ndig, R, ndig, z, C)  # [j, a, k, z, c]
        for j in range(ndig):
            for k in range(ndig):
                out[j + k, :, li] += prod[j, :, k].permute(1, 0, 2)
    return out


def _contract_right(xd: torch.Tensor, mst: torch.Tensor) -> torch.Tensor:
    """Digit classes of out[z, l, r, a] = sum_c X[z, l, r, c] M[l, a, c].

    xd [NDIG, z, L, R, Cin] int8; mst [L, Cin, NDIG*A] int8 (the planes of
    M^T side by side).  Returns int32 [N_CLASSES, z, L, R, A]."""
    ndig, z, L, R, Cin = xd.shape
    A = mst.shape[2] // ndig
    out = torch.zeros((N_CLASSES, z, L, R, A), dtype=torch.int32, device=xd.device)
    for li in range(L):
        lhs = xd[:, :, li].reshape(ndig * z * R, Cin)
        prod = torch._int_mm(lhs, mst[li]).view(ndig, z, R, ndig, A)  # [k, z, r, j, a]
        for k in range(ndig):
            for j in range(ndig):
                out[j + k, :, li] += prod[k, :, :, j]
    return out


def _combine(parts: torch.Tensor, c: dict) -> torch.Tensor:
    """sum_s P_s 2^(8s) mod p for parts int32 [N_CLASSES, z, L, R, C]:
    each class reduced mod p (canonical, < 2^30) and weighted by 2^(8s) mod
    p (< 2^30), seven products below 2^60 summed in int64.  Returns int64
    residues [z, L, R, C]."""
    p = c["p"]
    acc = (parts.to(torch.int64) % p * c["w"]).sum(dim=0)
    return acc % p


def ntt4(x: torch.Tensor, tables: NttTables, forward: bool = True) -> torch.Tensor:
    """Four-step transform of residues x [..., L, n] (uint32 or int64) on
    x's device; bit-compatible with ``ntt.ntt`` / ``ntt.intt`` (same
    bit-reversed conventions).  Returns uint32 [..., L, n]."""
    ft = get_fourstep(tables.primes, tables.n)
    A, B, L = ft.A, ft.B, len(tables.primes)
    lead = x.shape[:-2]
    X = x.reshape(-1, L, B, A)
    c = ft.on(x.device)
    if forward:
        y = _combine(_contract_left(c["m1"], digits_balanced(X)), c)  # [z, L, B, A]
        y = modops.mulmod_shoup(y, c["tw"], c["tw_shoup"], c["p"])
        out = _combine(_contract_right(digits_balanced(y), c["m2"]), c)
    else:
        w = _combine(_contract_right(digits_balanced(X), c["m2i"]), c)
        w = modops.mulmod_shoup(w, c["twi"], c["twi_shoup"], c["p"])
        out = _combine(_contract_left(c["m1i"], digits_balanced(w)), c)
    return modops.to_u32(out).reshape(lead + (L, tables.n))
