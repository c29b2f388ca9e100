"""BEHZ's two CUDA kernels, their host tables and wrappers.

``behz_extend(x, table)`` (``csrc/behz_extend.cu``) takes a ciphertext's
uint32 residues ``[..., L, n]`` on q and returns uint32 ``[..., K, n]`` on
Bsk: the residues that ``RnsTool.extend_q_to_bsk`` returns (step 1 of the
multiply).  ``behz_floor_convert(prod_q, prod_b, table)``
(``csrc/behz_floor_convert.cu``) takes the inverse NTTs' uint32 outputs of
a BEHZ tensor product, ``[..., L, n]`` on q and ``[..., K, n]`` on Bsk, and
returns int64 ``[..., L, n]``: the residues that
``RnsTool.convert_bsk_to_q(RnsTool.scale_floor_to_bsk(t x_q, t x_bsk))``
returns (steps 3 and 4).  The torch steps (``bfv/rns.py``) stay the CPU path
and the kernels' oracle.  Both run only on CUDA tensors and count their
launches (``launches``) and the (component, coefficient) positions they
covered (``positions``).

The kernels multiply only by table constants, each with its Shoup
companion.  ``extend_parts`` and ``table_parts`` derive them from
``BehzConsts``, with the constants that meet folded together, in the order
``ExtendLayout`` and ``Layout`` in the sources read them; ``pack_table``
lays them out as a kernel's words.  ``DeviceBehzTable.build`` checks a base
against the kernels' limits and sizes a kernel's persistent grid once per
device; the wrappers check only dtype, shape, alignment and device.
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


def _parts(parts) -> list:
    return [(name, np.array(w, dtype=np.int64), np.array(p, dtype=np.int64))
            for name, w, p in parts]


def extend_parts(bc) -> list:
    """The extension kernel's constants as ``(name, w, p)``, in its order:
    ``w`` an int64 array of constants, ``p`` the modulus of each (same
    shape), m~ = 2^16 for the last."""
    qp, bp = _ints(bc.qp), _ints(bc.bskp)
    L, K, mt = len(qp), len(bp), bc.m_tilde
    mt_q, qhat_inv = _ints(bc.m_tilde_mod_q), _ints(bc.qhat_inv_mod_q)
    mt_inv, q_b = _ints(bc.m_tilde_inv_mod_bsk), _ints(bc.q_mod_bsk)
    q_over = np.asarray(bc.q_over_pi_mod_bsk, dtype=np.int64).reshape(L, K)
    qm = [q_b[k] * mt_inv[k] % bp[k] for k in range(K)]
    return _parts([
        ("mt_qhat_inv", [[mt_q[i] * qhat_inv[i] % qp[i] for i in range(L)]], [qp]),
        ("q_over_qi_mt_inv", [[int(q_over[i, k]) * mt_inv[k] % bp[k] for k in range(K)]
                              for i in range(L)], [bp] * L),
        ("q_mt_inv", [qm], [bp]),
        ("neg_q_mt_inv", [[(b - x) % b for x, b in zip(qm, bp)]], [bp]),
        ("neg_q_over_qi_q_inv", [[x * bc.neg_q_inv_mod_mtilde % mt
                                  for x in _ints(bc.q_over_pi_mod_mtilde)]], [[mt] * L]),
    ])


def table_parts(bc) -> list:
    """The floor-convert kernel's constants as ``(name, w, p)``, in its
    order: ``w`` an int64 array of constants, ``p`` the prime of each (same
    shape)."""
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
    return _parts(parts)


def pack_table(bc, parts) -> np.ndarray:
    """uint32 words: the q primes, the Bsk primes, then each constant of
    ``parts`` (``extend_parts(bc)`` or ``table_parts(bc)``) beside its Shoup
    companion."""
    w = np.concatenate([w.reshape(-1) for _, w, _ in parts])
    p = np.concatenate([p.reshape(-1) for _, _, p in parts])
    pairs = np.stack([w, shoup(w, p).astype(np.int64)], axis=1).reshape(-1)
    return np.array(_ints(bc.qp) + _ints(bc.bskp) + pairs.tolist(), dtype=np.uint32)


def check_limits(L: int, K: int, primes):
    """Raise ValueError where the kernels cannot take this base: an L they
    are not built for, K other than L + 2, or a prime of 2^30 or more."""
    if L not in KERNEL_L or K != L + 2:
        raise ValueError(f"BEHZ kernels take L in {KERNEL_L} q primes and K = L + 2 Bsk "
                         f"primes, not L = {L}, K = {K}")
    if max(primes) >= PRIME_LIMIT:
        raise ValueError(f"BEHZ kernels need every prime < 2^30 (lazy sums reach 4p < 2^32); "
                         f"got {max(primes)}")


# kernel -> (its constants, the entry point that sizes its persistent grid)
_TABLES = {"floor_convert": (table_parts, "fhetpu_behz_floor_convert_blocks"),
           "extend": (extend_parts, "fhetpu_behz_extend_blocks")}


@dataclass(frozen=True)
class DeviceBehzTable:
    """One BEHZ kernel's table on one CUDA device, and its persistent grid
    there."""

    L: int
    K: int
    words: torch.Tensor  # uint32, pack_table's words
    blocks: int  # the kernel's blocks resident on the device at once

    @staticmethod
    def build(bc, device, kernel: str) -> "DeviceBehzTable":
        """Check the base against the kernels' limits (``check_limits``) and
        upload ``kernel``'s table ("floor_convert" or "extend"); raises
        where the kernel cannot take the base."""
        parts, blocks_entry = _TABLES[kernel]
        check_limits(bc.L, bc.K, _ints(bc.qp) + _ints(bc.bskp))
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"BEHZ kernels run on CUDA devices, not {device}")
        fn = getattr(build.lib(), blocks_entry)
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        blocks = ctypes.c_int()
        with torch.cuda.device(device):
            build.check(fn(bc.L, ctypes.byref(blocks)), blocks_entry)
        return DeviceBehzTable(L=bc.L, K=bc.K, words=torch.from_numpy(
            pack_table(bc, parts(bc))).to(device), blocks=blocks.value)


def _check_input(kernel: str, name: str, x: torch.Tensor):
    if x.dtype != torch.uint32:
        raise TypeError(f"BEHZ {kernel} kernel takes uint32 residues, got {name} {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"BEHZ {kernel} kernel runs on CUDA tensors, got {name} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"BEHZ {kernel} kernel expects contiguous tensors ({name})")
    if x.data_ptr() % 16:
        raise ValueError(f"BEHZ {kernel} kernel loads 16-byte vectors: data must be 16-byte "
                         f"aligned")
    n = x.shape[-1] if x.dim() else 0
    if n < 4 or n & (n - 1):
        raise ValueError(f"BEHZ {kernel} kernel takes a power-of-two n >= 4, not {n}")


def _launch(entry: str, argtypes: list, device, *args):
    fn = getattr(build.lib(), entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    build.check(err, entry)


_EXTEND_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]


def behz_extend(x: torch.Tensor, table: DeviceBehzTable) -> torch.Tensor:
    """Step 1 of BEHZ on CUDA: uint32 ``x [..., L, n]`` in base q -> uint32
    ``[..., K, n]`` in Bsk, exactly ``RnsTool.extend_q_to_bsk(x)``; ``table``
    is ``DeviceBehzTable.build(bc, device, "extend")``."""
    L, K = table.L, table.K
    _check_input("extension", "x", x)
    if x.dim() < 2 or x.shape[-2] != L:
        raise ValueError(f"BEHZ extension kernel expects [..., {L}, n], got {tuple(x.shape)}")
    if table.words.device != x.device:
        raise ValueError(f"table on {table.words.device}, data on {x.device}")
    n = x.shape[-1]
    out = torch.empty(x.shape[:-2] + (K, n), dtype=torch.uint32, device=x.device)
    m = x.numel() // (L * n)
    if m == 0:
        return out
    _launch("fhetpu_behz_extend", _EXTEND_ARGTYPES, x.device, x.data_ptr(), out.data_ptr(), m,
            L, K, n, table.words.data_ptr(), table.words.numel(), table.blocks)
    behz_extend.launches += 1
    behz_extend.positions += m * n
    return out


behz_extend.launches = 0  # kernel launches
behz_extend.positions = 0  # (component, coefficient) pairs, M * n a launch


_FLOOR_CONVERT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def behz_floor_convert(prod_q: torch.Tensor, prod_b: torch.Tensor,
                       table: DeviceBehzTable) -> torch.Tensor:
    """Steps 3 and 4 of BEHZ on CUDA: canonical uint32 ``prod_q [..., L, n]``
    and ``prod_b [..., K, n]`` (the tensor product before its scaling by t)
    -> int64 ``[..., L, n]`` in base q."""
    L, K = table.L, table.K
    for name, x in (("prod_q", prod_q), ("prod_b", prod_b)):
        _check_input("floor-convert", name, x)
    n = prod_q.shape[-1]
    if (prod_q.dim() < 2 or prod_q.shape[-2] != L or prod_b.shape[:-2] != prod_q.shape[:-2]
            or tuple(prod_b.shape[-2:]) != (K, n)):
        raise ValueError(f"BEHZ floor-convert kernel expects [..., {L}, n] and [..., {K}, n], "
                         f"got {tuple(prod_q.shape)} and {tuple(prod_b.shape)}")
    if prod_b.device != prod_q.device or table.words.device != prod_q.device:
        raise ValueError(f"table on {table.words.device}, data on {prod_q.device} and "
                         f"{prod_b.device}")
    out = torch.empty(prod_q.shape, dtype=torch.int64, device=prod_q.device)
    m = prod_q.numel() // (L * n)
    if m == 0:
        return out
    _launch("fhetpu_behz_floor_convert", _FLOOR_CONVERT_ARGTYPES, prod_q.device,
            prod_q.data_ptr(), prod_b.data_ptr(), out.data_ptr(), m, L, K, n,
            table.words.data_ptr(), table.words.numel(), table.blocks)
    behz_floor_convert.launches += 1
    behz_floor_convert.positions += m * n
    return out


behz_floor_convert.launches = 0  # kernel launches
behz_floor_convert.positions = 0  # (component, coefficient) pairs, M * n a launch
