"""BEHZ's three CUDA kernels, their host tables and wrappers.

``behz_extend(x, table)`` (``csrc/behz_extend.cu``) takes a ciphertext's
uint32 residues ``[..., L, n]`` on q and returns uint32 ``[..., K, n]`` on
Bsk: the residues that ``RnsTool.extend_q_to_bsk`` returns (step 1 of the
multiply).  ``behz_tensor(a_q, a_b, b_q, b_b, table)``
(``csrc/behz_tensor.cu``) takes two operands' forward NTTs, uint32
``[..., k, L, n]`` on q and ``[..., k, K, n]`` on Bsk, batch axes
broadcasting, and returns their NTT-domain tensor product on each base,
uint32 ``[..., k1 + k2 - 1, L, n]`` and ``[..., k1 + k2 - 1, K, n]``: what
``rns.tensor_product`` returns (step 2).
``behz_floor_convert(prod_q, prod_b, table)`` (``csrc/behz_floor_convert.cu``)
takes the inverse NTTs' uint32 outputs of a BEHZ tensor product,
``[..., L, n]`` on q and ``[..., K, n]`` on Bsk, and returns int64
``[..., L, n]``: the residues that
``RnsTool.convert_bsk_to_q(RnsTool.scale_floor_to_bsk(t x_q, t x_bsk))``
returns (steps 3 and 4).  The torch steps (``bfv/rns.py``) stay the CPU path
and the kernels' oracle.  All three run only on CUDA tensors and count their
launches (``launches``) and the (component, coefficient) positions they
wrote (``positions``).

The extension and floor-convert kernels multiply only by table constants,
each with its Shoup companion.  ``extend_parts`` and ``table_parts`` derive
them from ``BehzConsts``, with the constants that meet folded together, in
the order ``ExtendLayout`` and ``Layout`` in the sources read them;
``pack_table`` lays them out as a kernel's words.  The tensor kernel's
table, ``tensor_words``, holds the primes and their Barrett constants.
``DeviceBehzTable.build`` checks a base against the kernels' limits and
sizes a kernel's persistent grid once per device; the wrappers check dtype,
shape, alignment and device, and the tensor kernel's its sums' bound.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import build
from .modops import shoup

KERNEL_L = (2, 4, 8, 15, 16)  # the chooser's chains at n = 2048..16384, SEAL and native
PRIME_LIMIT = 1 << 30  # lazy sums reach 4p < 2^32
TENSOR_MAX_DIMS = 6  # csrc/behz_tensor.cu:kMaxDims, broadcast batch axes after merging


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


def tensor_words(bc) -> np.ndarray:
    """The tensor kernel's uint32 words: the q primes, the Bsk primes, then
    each prime's Barrett constant floor(2^64 / p) as two words, low first."""
    primes = _ints(bc.qp) + _ints(bc.bskp)
    mus = [(1 << 64) // p for p in primes]
    return np.array(primes + [w for m in mus for w in (m & 0xFFFFFFFF, m >> 32)],
                    dtype=np.uint32)


def check_limits(L: int, K: int, primes, terms: int = 0):
    """Raise ValueError where the kernels cannot take this base: an L they
    are not built for, K other than L + 2, or a prime of 2^30 or more; and
    where the tensor kernel's sums of ``terms`` exact products, each at most
    (p - 1)^2, could reach 2^64 (at p < 2^30, more than 16 terms)."""
    if L not in KERNEL_L or K != L + 2:
        raise ValueError(f"BEHZ kernels take L in {KERNEL_L} q primes and K = L + 2 Bsk "
                         f"primes, not L = {L}, K = {K}")
    if max(primes) >= PRIME_LIMIT:
        raise ValueError(f"BEHZ kernels need every prime < 2^30 (lazy sums reach 4p < 2^32); "
                         f"got {max(primes)}")
    if terms * (max(primes) - 1) ** 2 >= 1 << 64:
        raise ValueError(f"BEHZ tensor kernel sums {terms} products of residues below "
                         f"{max(primes)} in 64 bits: they could overflow")


def _packed(parts):
    return lambda bc: pack_table(bc, parts(bc))


# kernel -> (its table's words, the entry point that sizes its persistent grid)
_TABLES = {"floor_convert": (_packed(table_parts), "fhetpu_behz_floor_convert_blocks"),
           "extend": (_packed(extend_parts), "fhetpu_behz_extend_blocks"),
           "tensor": (tensor_words, "fhetpu_behz_tensor_blocks")}


@dataclass(frozen=True)
class DeviceBehzTable:
    """One BEHZ kernel's table on one CUDA device, and its persistent grid
    there."""

    L: int
    K: int
    words: torch.Tensor  # uint32, the kernel's table
    blocks: int  # the kernel's blocks resident on the device at once
    primes: tuple  # the q primes, then the Bsk primes

    @staticmethod
    def build(bc, device, kernel: str) -> "DeviceBehzTable":
        """Check the base against the kernels' limits (``check_limits``) and
        upload ``kernel``'s table ("floor_convert", "extend" or "tensor");
        raises where the kernel cannot take the base."""
        words, blocks_entry = _TABLES[kernel]
        primes = tuple(_ints(bc.qp) + _ints(bc.bskp))
        check_limits(bc.L, bc.K, primes)
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"BEHZ kernels run on CUDA devices, not {device}")
        fn = getattr(build.lib(), blocks_entry)
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        blocks = ctypes.c_int()
        with torch.cuda.device(device):
            build.check(fn(bc.L, ctypes.byref(blocks)), blocks_entry)
        return DeviceBehzTable(L=bc.L, K=bc.K, words=torch.from_numpy(words(bc)).to(device),
                               blocks=blocks.value, primes=primes)


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


def tensor_plan(a_batch, b_batch) -> tuple:
    """The tensor kernel's view of two operands' batch shapes:
    ``(bshape, sizes, a_strides, b_strides)``.  ``bshape`` is the broadcast
    batch shape; ``sizes`` its axes innermost first, with axes of size 1
    left out and each axis merged into the one inside it where both
    operands step through the pair as through one axis; the strides count
    each operand's own batch entries (contiguous), 0 along an axis it is
    broadcast over."""
    bshape = tuple(torch.broadcast_shapes(tuple(a_batch), tuple(b_batch)))

    def strides(shape):
        shape = (1,) * (len(bshape) - len(shape)) + tuple(shape)
        out, step = [], 1
        for size in reversed(shape):
            out.append(step if size > 1 else 0)
            step *= size
        return out[::-1]

    full_a, full_b = strides(a_batch), strides(b_batch)
    sizes, sa, sb = [], [], []
    for d in reversed(range(len(bshape))):
        if bshape[d] == 1:
            continue
        if sizes and sa[-1] * sizes[-1] == full_a[d] and sb[-1] * sizes[-1] == full_b[d]:
            sizes[-1] *= bshape[d]
        else:
            sizes.append(bshape[d])
            sa.append(full_a[d])
            sb.append(full_b[d])
    return bshape, sizes, sa, sb


_TENSOR_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                    + [ctypes.POINTER(ctypes.c_int)] + [ctypes.POINTER(ctypes.c_longlong)] * 2
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p])


def behz_tensor(a_q: torch.Tensor, a_b: torch.Tensor, b_q: torch.Tensor, b_b: torch.Tensor,
                table: DeviceBehzTable) -> tuple:
    """Step 2 of BEHZ on CUDA: the NTT-domain tensor product of canonical
    uint32 operands ``a [..., k1, L, n]`` (``a_q``) and ``[..., k1, K, n]``
    (``a_b``) and ``b`` likewise with k2 components, batch axes
    broadcasting -> uint32 ``[*bshape, k1 + k2 - 1, L, n]`` and
    ``[*bshape, k1 + k2 - 1, K, n]``, exactly ``rns.tensor_product``'s
    residues; ``table`` is ``DeviceBehzTable.build(bc, device, "tensor")``.
    Passing b as a (the same tensors) reads it once."""
    L, K = table.L, table.K
    for name, x in (("a_q", a_q), ("a_b", a_b), ("b_q", b_q), ("b_b", b_b)):
        _check_input("tensor", name, x)
    n = a_q.shape[-1]
    for xq, xb in ((a_q, a_b), (b_q, b_b)):
        if (xq.dim() < 3 or tuple(xq.shape[-2:]) != (L, n)
                or tuple(xb.shape) != tuple(xq.shape[:-2]) + (K, n)):
            raise ValueError(f"BEHZ tensor kernel expects [..., k, {L}, {n}] and "
                             f"[..., k, {K}, {n}], got {tuple(xq.shape)} and {tuple(xb.shape)}")
    if any(x.device != a_q.device for x in (a_b, b_q, b_b, table.words)):
        raise ValueError(f"table on {table.words.device}, data on "
                         f"{[str(x.device) for x in (a_q, a_b, b_q, b_b)]}")
    k1, k2 = a_q.shape[-3], b_q.shape[-3]
    check_limits(L, K, table.primes, min(k1, k2))
    bshape, sizes, sa, sb = tensor_plan(a_q.shape[:-3], b_q.shape[:-3])
    if len(sizes) > TENSOR_MAX_DIMS:
        raise ValueError(f"BEHZ tensor kernel takes at most {TENSOR_MAX_DIMS} broadcast batch "
                         f"axes once merged, got {len(sizes)}")
    kout = k1 + k2 - 1
    out_q = torch.empty(bshape + (kout, L, n), dtype=torch.uint32, device=a_q.device)
    out_b = torch.empty(bshape + (kout, K, n), dtype=torch.uint32, device=a_q.device)
    batch = math.prod(bshape)
    if batch == 0:
        return out_q, out_b
    if batch * (L + K) >= 1 << 31:
        raise ValueError(f"BEHZ tensor kernel takes fewer than 2^31 (batch, prime) rows, "
                         f"got {batch} x {L + K}")
    square = a_q is b_q and a_b is b_b
    dims = len(sizes)
    _launch("fhetpu_behz_tensor", _TENSOR_ARGTYPES, a_q.device, a_q.data_ptr(), a_b.data_ptr(),
            b_q.data_ptr(), b_b.data_ptr(), out_q.data_ptr(), out_b.data_ptr(), k1, k2,
            int(square), dims, (ctypes.c_int * dims)(*sizes), (ctypes.c_longlong * dims)(*sa),
            (ctypes.c_longlong * dims)(*sb), L, K, n, table.words.data_ptr(),
            table.words.numel(), table.blocks)
    behz_tensor.launches += 1
    behz_tensor.positions += batch * kout * n
    return out_q, out_b


behz_tensor.launches = 0  # kernel launches
behz_tensor.positions = 0  # the broadcast batch x (k1 + k2 - 1) x n a launch


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
