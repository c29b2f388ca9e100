"""The harmonic decode server's expansion in one CUDA kernel
(``csrc/harmonic_expand.cu``): its wrapper.

``harmonic_expand(tabs, harm, primes)`` takes the weight tables, uint32
``[H, P, L, n]`` (``pipelines.rle_decode.harmonic_weight_tables``), and the
harmonics' NTTs, uint32 ``[H, S, L, n]``, and returns uint32
``[P, S, L, n]`` in NTT form: sum_k tabs[k, p] * harm[k, s] mod q_l,
canonical.  These are the residues of
``pipelines.rle_decode.expand_harmonics_plain``, which stays the CPU path
and the kernel's oracle.  It runs only on CUDA tensors and counts its
launches (``launches``) and the table words they read (``words``).

The kernel sums exact 64-bit products and folds the sum by Barrett into
[0, 2q) after every ``CHUNK`` of them; ``PRIME_LIMIT`` keeps that sum below
2^64 at any H (the proof is in the source's note).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

CHUNK = 16  # products summed between two folds (csrc/harmonic_expand.cu:kChunk)
PRIME_LIMIT = 1 << 30  # CHUNK products below 2^60 and a fold below 2^31 stay below 2^64
MAX_L = 16  # the chooser's longest chain, n = 16384 native
SIZES = (2, 3)  # ciphertext components, one kernel instance each
MAX_ROWS = 454  # H * S rows of a block's harmonics in shared memory: 454 * 512 B <= 227 KB

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
             ctypes.c_void_p]


@functools.cache
def _entry():
    fn = build.lib().fhetpu_harmonic_expand
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def harmonic_expand(tabs: torch.Tensor, harm: torch.Tensor, primes) -> torch.Tensor:
    """The expansion on CUDA: uint32 ``tabs [H, P, L, n]`` and ``harm
    [H, S, L, n]``, both contiguous and 16-byte aligned on one card, and
    the L primes ->
    canonical uint32 ``[P, S, L, n]``.  Raises where the kernel cannot take
    its input."""
    for name, x in (("tables", tabs), ("harmonics", harm)):
        if x.dtype != torch.uint32:
            raise TypeError(f"expansion kernel takes uint32 residues, got {name} {x.dtype}")
        if x.device.type != "cuda":
            raise ValueError(f"expansion kernel runs on CUDA tensors, got {name} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"expansion kernel expects contiguous tensors ({name})")
        if x.data_ptr() % 16:
            raise ValueError(f"expansion kernel loads 16-byte vectors: {name} must be 16-byte "
                             f"aligned")
        if x.dim() != 4:
            raise ValueError(f"expansion kernel expects 4-d {name}, got {tuple(x.shape)}")
    H, P, L, n = tabs.shape
    S = harm.shape[1]
    if harm.shape[0] != H or tuple(harm.shape[2:]) != (L, n):
        raise ValueError(f"expansion kernel expects [H, P, L, n] tables and [H, S, L, n] "
                         f"harmonics, got {tuple(tabs.shape)} and {tuple(harm.shape)}")
    if harm.device != tabs.device:
        raise ValueError(f"tables on {tabs.device}, harmonics on {harm.device}")
    if H < 1 or n < 4 or n & (n - 1):
        raise ValueError(f"expansion kernel takes H >= 1 and a power-of-two n >= 4, not "
                         f"H = {H}, n = {n}")
    if S not in SIZES or H * S > MAX_ROWS:
        raise ValueError(f"expansion kernel takes size in {SIZES} and H * size <= {MAX_ROWS}, "
                         f"not H = {H}, size = {S}")
    qs = [int(q) for q in primes]
    if len(qs) != L or L > MAX_L:
        raise ValueError(f"expansion kernel takes L <= {MAX_L} primes matching the data, got "
                         f"{len(qs)} for L = {L}")
    bad = [q for q in qs if q >= PRIME_LIMIT or q < 3 or q % 2 == 0]
    if bad:
        raise ValueError(f"expansion kernel needs odd primes below 2^30 (its 64-bit sums), got "
                         f"{bad}")
    out = torch.empty((P, S, L, n), dtype=torch.uint32, device=tabs.device)
    if P == 0:
        return out
    with torch.cuda.device(tabs.device):
        err = _entry()(tabs.data_ptr(), harm.data_ptr(), out.data_ptr(), H, P, S, L, n,
                       (ctypes.c_uint32 * L)(*qs),
                       torch.cuda.current_stream(tabs.device).cuda_stream)
    build.check(err, "fhetpu_harmonic_expand")
    harmonic_expand.launches += 1
    harmonic_expand.words += tabs.numel()
    return out


harmonic_expand.launches = 0  # kernel launches
harmonic_expand.words = 0  # table words read, H * P * L * n a launch
