"""The DCT-only kernel (``csrc/dct.cu``): plain version and wrapper.

Counterpart of ``fhetpu/core/pallas_dct.py``: the two-pass 8x8 AAN DCT
with the x encode(0.125) column scaling over NTT-domain ciphertexts
``uint32[nb, ch, 64, 2, L, n]``, every residue canonical in [0, p).  It is
the DCT of the ``--quantize`` server path, where the per-slot quantize
multiplies follow it.  The kernel runs on the native layout (no transposes)
and reads rows 0..12 and 22 of the evaluator's ``pack_server_constants``
tables (``Evaluator.server_state``), which hold the residues of fhetpu's
``pack_dct_constants``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .modops import mulmod_shoup, to_i64
from .server_kernel import _P_ROW, _aan_pass, check_kernel_args, dct2d_plain

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def dct8x8_plain(x: torch.Tensor, state) -> torch.Tensor:
    """uint32 [nb, ch, 64, 2, L, n] NTT domain -> same shape and layout, in
    int64 torch with the fused kernel's strict AAN pass.

    state: anything with the ``consts`` and ``consts_shoup`` tables of
    ``pack_server_constants`` on x's device (a ``convert.ServerState``)."""
    nb, ch, ns, comps, L, n = x.shape
    assert (ns, comps) == (64, 2), x.shape
    C = to_i64(state.consts)
    Csh = to_i64(state.consts_shoup)
    p = C[_P_ROW]

    def mul(v, row):
        return mulmod_shoup(v, C[row], Csh[row], p)

    chan = to_i64(x).reshape(nb * ch, 64, 2, L * n)
    out = dct2d_plain(chan, lambda a, column: _aan_pass(a, mul, p, column))
    return out.reshape(x.shape)


def _launch(x: torch.Tensor, state) -> torch.Tensor:
    check_kernel_args(x, state, "DCT kernel", channels=range(1, 65536))
    out = torch.empty_like(x)
    nb, ch, lanes = x.shape[0], x.shape[1], x.shape[4] * x.shape[5]
    if nb == 0:
        return out
    fn = build.lib().fhetpu_dct8x8
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), state.consts.data_ptr(),
             state.consts_shoup.data_ptr(), nb, ch, lanes,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fhetpu_dct8x8")
    return out


def dct8x8_kernel(ev, x: torch.Tensor) -> torch.Tensor:
    """x: uint32 [nb, ch, 64, 2, L, n] NTT-domain ciphertext slots -> same
    shape.  Launches the DCT kernel for a CUDA tensor and runs
    ``dct8x8_plain`` for a CPU tensor; the constants are the evaluator's
    server tables on x's device."""
    state = ev.server_state(x.device)
    if x.device.type == "cuda":
        out = _launch(x, state)
        dct8x8_kernel.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no DCT kernel for device {x.device}")
    return dct8x8_plain(x, state)


dct8x8_kernel.launches = 0
