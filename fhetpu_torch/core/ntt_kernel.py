"""The negacyclic NTT kernels (``csrc/ntt.cu``): wrappers, plain versions and
per-device twiddle tables.

Counterpart of ``fhetpu/core/pallas_ntt.py``.  ``ntt_forward`` and
``ntt_inverse`` take uint32 tensors ``[..., L, n]``: on a CUDA tensor they
launch the kernel and count the launch (``launches``) and the polynomials
it transformed, batch times L (``polys``); on a CPU tensor they run
``ntt_plain`` / ``intt_plain``, torch int64 mirrors of
``fhetpu/core/ntt.py:_ntt_impl`` and ``_intt_impl``.  There is no fallback
from a CUDA tensor to the plain version.

The kernel runs the log2(n) stages in register rounds (``kernel_rounds``):
each thread holds 16 coefficients and runs up to four stages on them before
an exchange through shared memory.  ``kernel_twiddles`` lays out each
round's twiddles so that a thread reads them as one record of 16 twiddles
and 16 Shoup companions.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import build
from .modops import addmod, mulmod_shoup, shoup, submod, to_i64, to_u32

KERNEL_LOGN = (11, 12, 13, 14)  # the ring degrees csrc/ntt.cu instantiates
LAZY_PRIME_LIMIT = 1 << 30  # lazy butterflies keep values < 4p < 2^32


def kernel_rounds(logn: int) -> tuple:
    """The kernel's register rounds in the forward transform's order (the
    inverse runs them backwards), as ``(lo, alo, ahi)``: in a round a thread
    holds the 16 coefficients whose index bits lo..lo+3 vary and runs the
    stages on bits alo..ahi.  The first round takes four bits and the others
    share the rest as evenly as they can.  Mirrored by ``csrc/ntt.cu``'s
    ``own_lo``/``act_lo``/``act_hi``."""
    nr = -(-logn // 4)
    rounds, hi = [], logn - 1
    for r in range(nr):
        alo = hi - (logn // nr + (r < logn % nr)) + 1
        rounds.append((max(hi - 3, 0), alo, hi))
        hi = alo - 1
    return tuple(rounds)


def twiddle_slot(sb: int, q: int) -> int:
    """Record slot of the q-th twiddle of the stage on window bit sb: bits 3
    and 2 share the first 16-byte vector (slots 0 and 1..2, slot 3 spare),
    bit 1 fills the second (4..7), bit 0 the last two (8..15), so a stage
    loads only the vectors it uses.  Mirrored by ``csrc/ntt.cu``."""
    return (1 << (3 - sb)) - (sb >= 2) + q


def kernel_twiddles(w, w_shoup, logn: int, fold=None) -> np.ndarray:
    """Twiddles in the kernel's order, uint32 ``[L, words]``.

    For each round of ``kernel_rounds``, one 32-word record per value of the
    thread's index bits above the round's window (``kh``): 16 twiddles, then
    their 16 Shoup companions, as eight 16-byte vectors.  A round stores
    vector c of every record together (``[8, K, 4]`` words for K records),
    so the threads of a warp, which hold consecutive ``kh`` in a round at
    bit 0, read consecutive vectors.  The stage on the window's bit ``sb`` reads
    slots ``twiddle_slot(sb, q)`` for ``q < 2^(3-sb)``, holding
    ``w[2^k + (kh << (3-sb)) + q]`` with ``k = logn - 1 - (lo + sb)``: the
    ``psi_br[m + i]`` (or ``ipsi_br[h + i]``) of the pairs the thread holds.
    Unused slots are 0.  ``fold = (n_inv, n_inv_shoup, p)`` (the inverse)
    puts ``w[1] * n^-1`` in slot 0 of the first round, the last stage the
    inverse runs, and ``n^-1`` in its spare slot 3."""
    w, w_shoup = np.asarray(w, dtype=np.uint32), np.asarray(w_shoup, dtype=np.uint32)
    L = w.shape[0]
    parts = []
    for lo, alo, ahi in kernel_rounds(logn):
        kh = np.arange(1 << (logn - lo - 4))
        rec = np.zeros((L, kh.size, 2, 16), dtype=np.uint32)
        for b in range(alo, ahi + 1):
            sb, k = b - lo, logn - 1 - b
            span = 1 << (3 - sb)
            for q in range(span):
                idx = (1 << k) + (kh << (3 - sb)) + q
                rec[:, :, 0, twiddle_slot(sb, q)] = w[:, idx]
                rec[:, :, 1, twiddle_slot(sb, q)] = w_shoup[:, idx]
        parts.append(rec)
    if fold is not None:
        n_inv, n_inv_shoup, p = (np.asarray(a, dtype=np.uint64).reshape(L) for a in fold)
        last = (w[:, 1].astype(np.uint64) * n_inv) % p
        parts[0][:, 0, 0, 0], parts[0][:, 0, 1, 0] = last, shoup(last, p)
        parts[0][:, 0, 0, 3], parts[0][:, 0, 1, 3] = n_inv, n_inv_shoup
    return np.concatenate([r.reshape(L, -1, 8, 4).transpose(0, 2, 1, 3).reshape(L, -1)
                           for r in parts], axis=1)


@dataclass(frozen=True)
class DeviceNttTables:
    """One base's twiddle tables on one device, as uint32 tensors.

    psi*/ipsi*: [L, n] bit-reversed powers of psi / psi^-1 with Shoup
    companions (the plain versions' tables); p, n_inv, n_inv_shoup: [L];
    fwd_tw/inv_tw: [L, words], the kernels' tables (``kernel_twiddles``,
    the inverse's with n^-1 folded in), None where no kernel takes n."""

    n: int
    primes: tuple
    p: torch.Tensor
    psi: torch.Tensor
    psi_shoup: torch.Tensor
    ipsi: torch.Tensor
    ipsi_shoup: torch.Tensor
    n_inv: torch.Tensor
    n_inv_shoup: torch.Tensor
    fwd_tw: Optional[torch.Tensor]
    inv_tw: Optional[torch.Tensor]

    @property
    def L(self) -> int:
        return self.p.shape[0]

    @property
    def logn(self) -> int:
        return self.n.bit_length() - 1

    @staticmethod
    def from_numpy(primes, psi_br, psi_br_shoup, ipsi_br, ipsi_br_shoup,
                   n_inv, n_inv_shoup, device) -> "DeviceNttTables":
        def up(a):
            a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
            return torch.from_numpy(a).to(device)

        psi_br = np.asarray(psi_br)
        n = psi_br.shape[-1]
        logn = n.bit_length() - 1
        p = np.asarray(primes, dtype=np.uint64).reshape(-1)
        n_inv = np.asarray(n_inv).reshape(-1)
        n_inv_shoup = np.asarray(n_inv_shoup).reshape(-1)
        kernel = logn in KERNEL_LOGN
        return DeviceNttTables(
            n=n, primes=tuple(int(q) for q in p), p=up(p),
            psi=up(psi_br), psi_shoup=up(psi_br_shoup),
            ipsi=up(ipsi_br), ipsi_shoup=up(ipsi_br_shoup),
            n_inv=up(n_inv), n_inv_shoup=up(n_inv_shoup),
            fwd_tw=up(kernel_twiddles(psi_br, psi_br_shoup, logn)) if kernel else None,
            inv_tw=up(kernel_twiddles(ipsi_br, ipsi_br_shoup, logn,
                                      fold=(n_inv, n_inv_shoup, p))) if kernel else None,
        )


_TABLE_CACHE: dict = {}


def device_tables(tables, device) -> DeviceNttTables:
    """Upload an ``NttTables`` to ``device`` once; cached per (primes, n,
    device)."""
    device = torch.device(device)
    key = (tuple(tables.primes), tables.n, device)
    dt = _TABLE_CACHE.get(key)
    if dt is None:
        dt = _TABLE_CACHE[key] = DeviceNttTables.from_numpy(
            tables.primes, tables.psi_br, tables.psi_br_shoup,
            tables.ipsi_br, tables.ipsi_br_shoup,
            tables.n_inv, tables.n_inv_shoup, device)
    return dt


# ---------------------------------------------------------------------------
# Plain versions: torch int64, stage by stage, as core/ntt.py's _ntt_impl.
# ---------------------------------------------------------------------------


def ntt_plain(x: torch.Tensor, dt: DeviceNttTables) -> torch.Tensor:
    """Forward negacyclic NTT of uint32 [..., L, n] -> uint32, natural order
    in, bit-reversed out."""
    L, n = dt.L, dt.n
    a = to_i64(x).reshape(-1, L, n)
    B = a.shape[0]
    psi, psi_s = to_i64(dt.psi), to_i64(dt.psi_shoup)
    p = to_i64(dt.p).reshape(L, 1, 1)
    m, t = 1, n
    for _ in range(dt.logn):
        t //= 2
        a = a.reshape(B, L, m, 2, t)
        w = psi[:, m:2 * m].reshape(L, m, 1)
        ws = psi_s[:, m:2 * m].reshape(L, m, 1)
        u = a[..., 0, :]
        v = mulmod_shoup(a[..., 1, :], w, ws, p)
        a = torch.stack((addmod(u, v, p), submod(u, v, p)), dim=-2).reshape(B, L, n)
        m *= 2
    return to_u32(a).reshape(x.shape)


def intt_plain(x: torch.Tensor, dt: DeviceNttTables) -> torch.Tensor:
    """Inverse negacyclic NTT of uint32 [..., L, n] -> uint32, bit-reversed
    in, natural order out, scaled by n^-1."""
    L, n = dt.L, dt.n
    a = to_i64(x).reshape(-1, L, n)
    B = a.shape[0]
    ipsi, ipsi_s = to_i64(dt.ipsi), to_i64(dt.ipsi_shoup)
    p = to_i64(dt.p).reshape(L, 1, 1)
    t, m = 1, n
    while m > 1:
        h = m // 2
        a = a.reshape(B, L, h, 2, t)
        w = ipsi[:, h:2 * h].reshape(L, h, 1)
        ws = ipsi_s[:, h:2 * h].reshape(L, h, 1)
        u = a[..., 0, :]
        v = a[..., 1, :]
        hi = mulmod_shoup(submod(u, v, p), w, ws, p)
        a = torch.stack((addmod(u, v, p), hi), dim=-2).reshape(B, L, n)
        t *= 2
        m = h
    a = mulmod_shoup(a, to_i64(dt.n_inv).reshape(L, 1),
                     to_i64(dt.n_inv_shoup).reshape(L, 1), p.reshape(L, 1))
    return to_u32(a).reshape(x.shape)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on CUDA tensors, the plain version on CPU tensors.
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p]


def check_kernel_tables(dt: DeviceNttTables):
    """Raise ValueError where the kernels cannot take these tables: a ring
    degree they are not built for, or a prime of 2^30 or more, for which
    their lazy butterflies (values up to 4p) would overflow 32 bits.  The
    plain versions take both."""
    if dt.fwd_tw is None:
        raise ValueError(f"NTT kernel takes n = {[1 << k for k in KERNEL_LOGN]}, not {dt.n}")
    if max(dt.primes) >= LAZY_PRIME_LIMIT:
        raise ValueError(f"NTT kernel needs every prime < 2^30 (lazy butterflies reach 4p "
                         f"< 2^32); got {max(dt.primes)}")


def _launch(x: torch.Tensor, dt: DeviceNttTables, forward: bool) -> torch.Tensor:
    L, n = dt.L, dt.n
    if x.dtype != torch.uint32:
        raise TypeError(f"NTT kernel takes uint32 residues, got {x.dtype}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"NTT kernel expects [..., {L}, {n}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("NTT kernel expects a contiguous tensor")
    if x.data_ptr() % 16:
        raise ValueError("NTT kernel copies 16-byte chunks: data must be 16-byte aligned")
    if dt.p.device != x.device:
        raise ValueError(f"tables on {dt.p.device}, data on {x.device}")
    check_kernel_tables(dt)
    out = torch.empty_like(x)
    batch = x.numel() // (L * n)
    if batch == 0:
        return out
    lib = build.lib()
    fn = lib.fhetpu_ntt
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    tw = dt.fwd_tw if forward else dt.inv_tw
    with torch.cuda.device(x.device):  # a launch into another device's stream fails
        err = fn(x.data_ptr(), out.data_ptr(), batch, L, n, tw.data_ptr(), tw.shape[1],
                 dt.p.data_ptr(), int(forward), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fhetpu_ntt")
    counted = ntt_forward if forward else ntt_inverse
    counted.launches += 1
    counted.polys += batch * L
    return out


def ntt_forward(x: torch.Tensor, dt: DeviceNttTables) -> torch.Tensor:
    """Forward NTT of uint32 [..., L, n]; kernel on CUDA, plain on the CPU."""
    if x.device.type == "cuda":
        return _launch(x, dt, forward=True)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    return ntt_plain(x, dt)


def ntt_inverse(x: torch.Tensor, dt: DeviceNttTables) -> torch.Tensor:
    """Inverse NTT of uint32 [..., L, n]; kernel on CUDA, plain on the CPU."""
    if x.device.type == "cuda":
        return _launch(x, dt, forward=False)
    if x.device.type != "cpu":
        raise ValueError(f"no NTT for device {x.device}")
    return intt_plain(x, dt)


ntt_forward.launches = ntt_forward.polys = 0  # kernel launches, (polynomial, limb) pairs
ntt_inverse.launches = ntt_inverse.polys = 0
