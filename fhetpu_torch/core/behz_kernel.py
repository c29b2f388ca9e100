"""BEHZ's scale-and-floor and Shenoy-Kumaresan steps in one CUDA kernel
(``csrc/behz_floor_convert.cu``): its host table and wrapper.

``behz_floor_convert(prod_q, prod_b, table)`` takes the inverse NTTs' uint32
outputs of a BEHZ tensor product, ``[..., L, n]`` on q and ``[..., K, n]``
on Bsk, and returns int64 ``[..., L, n]``: the residues that
``RnsTool.convert_bsk_to_q(RnsTool.scale_floor_to_bsk(t x_q, t x_bsk))``
returns (``bfv/rns.py``), which stay the CPU path and the kernel's oracle.
It runs only on CUDA tensors and counts its launches (``launches``) and the
(component, coefficient) positions they covered (``positions``).

The kernel multiplies only by table constants, each with its Shoup
companion.  ``table_parts`` derives them from ``BehzConsts``, with t, q^-1,
Bhat_j^-1 and B^-1 folded into the constants that meet them, in the order
``csrc/behz_floor_convert.cu:Layout`` reads them; ``pack_table`` lays them
out as the kernel's words.  ``DeviceBehzTable.build`` checks a base against
the kernel's limits and sizes its persistent grid once per device; the
wrapper checks only dtype, shape, alignment and device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import build
from .modops import shoup

KERNEL_L = (2, 4, 8, 15, 16)  # the chooser's chains at n = 2048..16384, SEAL and native
PRIME_LIMIT = 1 << 30  # lazy sums reach 4p < 2^32


def _ints(a) -> list:
    return [int(x) for x in np.asarray(a).reshape(-1)]


def table_parts(bc) -> list:
    """The kernel's constants as ``(name, w, p)``, in its order: ``w`` an
    int64 array of constants, ``p`` the prime of each (same shape)."""
    qp, bp = _ints(bc.qp), _ints(bc.bskp)
    L, K = len(qp), len(bp)
    nb, msk = K - 1, bp[-1]
    q_inv, b_inv = _ints(bc.q_inv_mod_bsk), int(bc.b_inv_mod_msk)
    # c_k: what multiplies (t x_k - f_k) mod b_k: q^-1 Bhat_j^-1, and q^-1 B^-1 at m_sk
    c = [q_inv[j] * h % bp[j] for j, h in enumerate(_ints(bc.bhat_inv_mod_b))]
    c.append(q_inv[nb] * b_inv % msk)
    q_over = np.asarray(bc.q_over_pi_mod_bsk, dtype=np.int64).reshape(L, K)
    t_q, qhat_inv, t_b = _ints(bc.t_mod_q), _ints(bc.qhat_inv_mod_q), _ints(bc.t_mod_bsk)
    b_q = _ints(bc.b_mod_q)
    parts = [
        ("t_qhat_inv", [[t_q[i] * qhat_inv[i] % qp[i] for i in range(L)]], [qp]),
        ("t_c", [[t_b[k] * c[k] % bp[k] for k in range(K)]], [bp]),
        ("q_over_qi_c", [[int(q_over[i, k]) * c[k] % bp[k] for k in range(K)]
                         for i in range(L)], [bp] * L),
        ("b_over_bj_b_inv", [[x * b_inv % msk for x in _ints(bc.b_over_bj_mod_msk)]],
         [[msk] * nb]),
        ("b_over_bj_mod_q", np.asarray(bc.b_over_bj_mod_q).reshape(nb, L), [qp] * nb),
        ("b_mod_q", [b_q], [qp]),
        ("neg_b_mod_q", [[(p - b) % p for b, p in zip(b_q, qp)]], [qp]),
    ]
    return [(name, np.array(w, dtype=np.int64), np.array(p, dtype=np.int64))
            for name, w, p in parts]


def pack_table(bc) -> np.ndarray:
    """uint32 words: the q primes, the Bsk primes, then each constant of
    ``table_parts`` beside its Shoup companion."""
    parts = table_parts(bc)
    w = np.concatenate([w.reshape(-1) for _, w, _ in parts])
    p = np.concatenate([p.reshape(-1) for _, _, p in parts])
    pairs = np.stack([w, shoup(w, p).astype(np.int64)], axis=1).reshape(-1)
    return np.array(_ints(bc.qp) + _ints(bc.bskp) + pairs.tolist(), dtype=np.uint32)


def check_limits(L: int, K: int, primes):
    """Raise ValueError where the kernel cannot take this base: an L it is
    not built for, K other than L + 2, or a prime of 2^30 or more."""
    if L not in KERNEL_L or K != L + 2:
        raise ValueError(f"BEHZ floor-convert kernel takes L in {KERNEL_L} q primes and "
                         f"K = L + 2 Bsk primes, not L = {L}, K = {K}")
    if max(primes) >= PRIME_LIMIT:
        raise ValueError(f"BEHZ floor-convert kernel needs every prime < 2^30 (lazy sums "
                         f"reach 4p < 2^32); got {max(primes)}")


@dataclass(frozen=True)
class DeviceBehzTable:
    """The kernel's table on one CUDA device, and its persistent grid there."""

    L: int
    K: int
    words: torch.Tensor  # uint32, pack_table's words
    blocks: int  # the kernel's blocks resident on the device at once

    @staticmethod
    def build(bc, device) -> "DeviceBehzTable":
        """Check the base against the kernel's limits (``check_limits``) and
        upload its table; raises where the kernel cannot take the base."""
        check_limits(bc.L, bc.K, _ints(bc.qp) + _ints(bc.bskp))
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"BEHZ floor-convert kernel runs on CUDA devices, not {device}")
        fn = build.lib().fhetpu_behz_floor_convert_blocks
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        blocks = ctypes.c_int()
        with torch.cuda.device(device):
            build.check(fn(bc.L, ctypes.byref(blocks)), "fhetpu_behz_floor_convert_blocks")
        return DeviceBehzTable(L=bc.L, K=bc.K, words=torch.from_numpy(pack_table(bc)).to(device),
                               blocks=blocks.value)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def behz_floor_convert(prod_q: torch.Tensor, prod_b: torch.Tensor,
                       table: DeviceBehzTable) -> torch.Tensor:
    """Steps 3 and 4 of BEHZ on CUDA: canonical uint32 ``prod_q [..., L, n]``
    and ``prod_b [..., K, n]`` (the tensor product before its scaling by t)
    -> int64 ``[..., L, n]`` in base q."""
    L, K = table.L, table.K
    for name, x in (("prod_q", prod_q), ("prod_b", prod_b)):
        if x.dtype != torch.uint32:
            raise TypeError(f"BEHZ floor-convert kernel takes uint32 residues, got {name} "
                            f"{x.dtype}")
        if x.device.type != "cuda":
            raise ValueError(f"BEHZ floor-convert kernel runs on CUDA tensors, got {name} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"BEHZ floor-convert kernel expects contiguous tensors ({name})")
        if x.data_ptr() % 16:
            raise ValueError("BEHZ floor-convert kernel loads 16-byte vectors: data must be "
                             "16-byte aligned")
    n = prod_q.shape[-1]
    if (prod_q.dim() < 2 or prod_q.shape[-2] != L or prod_b.shape[:-2] != prod_q.shape[:-2]
            or tuple(prod_b.shape[-2:]) != (K, n)):
        raise ValueError(f"BEHZ floor-convert kernel expects [..., {L}, n] and [..., {K}, n], "
                         f"got {tuple(prod_q.shape)} and {tuple(prod_b.shape)}")
    if n < 4 or n & (n - 1):
        raise ValueError(f"BEHZ floor-convert kernel takes a power-of-two n >= 4, not {n}")
    if prod_b.device != prod_q.device or table.words.device != prod_q.device:
        raise ValueError(f"table on {table.words.device}, data on {prod_q.device} and "
                         f"{prod_b.device}")
    out = torch.empty(prod_q.shape, dtype=torch.int64, device=prod_q.device)
    m = prod_q.numel() // (L * n)
    if m == 0:
        return out
    fn = build.lib().fhetpu_behz_floor_convert
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(prod_q.device):
        err = fn(prod_q.data_ptr(), prod_b.data_ptr(), out.data_ptr(), m, L, K, n,
                 table.words.data_ptr(), table.words.numel(), table.blocks,
                 torch.cuda.current_stream(prod_q.device).cuda_stream)
    build.check(err, "fhetpu_behz_floor_convert")
    behz_floor_convert.launches += 1
    behz_floor_convert.positions += m * n
    return out


behz_floor_convert.launches = 0  # kernel launches
behz_floor_convert.positions = 0  # (component, coefficient) pairs, M * n a launch
