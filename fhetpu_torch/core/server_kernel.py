"""The fused JPEG server kernels (``csrc/server_ycc_dct.cu``): constants,
plain versions and wrappers.

Counterpart of ``fhetpu/core/pallas_server.py``, strict and lazy.  One pass
over NTT-domain ciphertexts ``uint32[nb, 3, 64, 2, L, n]`` computes RGB ->
YCbCr, subtracts NTT(Delta * encode(128)) from component 0 of Y, and runs
the two-pass AAN DCT with the x encode(0.125) column scaling.  The strict
kernel keeps every residue canonical in [0, p); the lazy kernel lets
intermediates grow to a multiple of p and reduces them only at the points
where fhetpu's lazy kernel does, for the same output bits.  The (L, n) axes
are one lane axis of length L*n, each lane with its own modulus, so every
constant is a per-lane row of a ``[24, L*n]`` table.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .modops import addmod, mulmod_shoup, submod, to_i64, to_u32

# multiply constants, in the row order of fhetpu/core/pallas_dct.py:CONST_ORDER
# and fhetpu/core/pallas_server.py:YCC_MULS
CONST_ORDER = (
    0.541196100, 0.765366865, -1.847759065, 1.175875602, 0.298631336,
    2.053119869, 3.072711026, 1.501321110, -0.899976223, -2.562915447,
    -1.961570560, -0.390180644, 0.125,
)
YCC_MULS = (0.299, 0.587, 0.114, -0.168736, 0.331264, 0.5, 0.418688, 0.081312)
N_DCT = len(CONST_ORDER)  # 13
N_YCC = len(YCC_MULS)  # 8
_ROWS = 24  # 13 DCT + 8 YCC muls + 1 sub_plain(128) + 1 p row, padded to 24
_SUB_ROW = N_DCT + N_YCC  # 21
_P_ROW = N_DCT + N_YCC + 1  # 22


def pack_server_constants(ev):
    """[24, L*n] lane-flattened mul-NTT table + Shoup companions (numpy).

    Rows 0..12: DCT constants (CONST_ORDER); rows 13..20: YCC multiply
    constants; row 21: NTT(Delta*128) for the sub_plain (Shoup row zero);
    row 22: the per-lane modulus p; row 23: zero padding."""
    muls, shs = [], []
    for c in CONST_ORDER + YCC_MULS:
        op = ev.encode(float(c))
        muls.append(op.mul_ntt.reshape(-1))  # [L*n]
        shs.append(op.mul_ntt_shoup.reshape(-1))
    sub_op = ev.encode(128.0)
    muls.append(sub_op.add_ntt.reshape(-1))  # delta-scaled, for sub_plain on c0
    shs.append(np.zeros_like(muls[-1]))
    L = ev.params.L
    n = ev.params.n
    p_lane = np.broadcast_to(
        ev.params.consts.qp.reshape(L, 1), (L, n)
    ).reshape(-1).astype(np.uint32)
    muls.append(p_lane)
    shs.append(np.zeros_like(p_lane))
    mul = np.stack(muls, axis=0)  # [23, L*n]
    sh = np.stack(shs, axis=0)
    pad = ((0, _ROWS - mul.shape[0]), (0, 0))
    return np.pad(mul, pad), np.pad(sh, pad)


# ---------------------------------------------------------------------------
# Plain version: torch int64, the op graph of _server_kernel.
# ---------------------------------------------------------------------------


def _aan_pass(a, mul, p, scale_eighth: bool):
    """One 8-point AAN pass over a list of 8 tensors; returns 8."""
    tmp0 = addmod(a[0], a[7], p)
    tmp7 = submod(a[0], a[7], p)
    tmp1 = addmod(a[1], a[6], p)
    tmp6 = submod(a[1], a[6], p)
    tmp2 = addmod(a[2], a[5], p)
    tmp5 = submod(a[2], a[5], p)
    tmp3 = addmod(a[3], a[4], p)
    tmp4 = submod(a[3], a[4], p)
    tmp10 = addmod(tmp0, tmp3, p)
    tmp13 = submod(tmp0, tmp3, p)
    tmp11 = addmod(tmp1, tmp2, p)
    tmp12 = submod(tmp1, tmp2, p)
    out0 = addmod(tmp10, tmp11, p)
    out4 = submod(tmp10, tmp11, p)
    z1 = mul(addmod(tmp12, tmp13, p), 0)
    out2 = addmod(z1, mul(tmp13, 1), p)
    out6 = addmod(z1, mul(tmp12, 2), p)
    z1 = addmod(tmp4, tmp7, p)
    z2 = addmod(tmp5, tmp6, p)
    z3 = addmod(tmp4, tmp6, p)
    z4 = addmod(tmp5, tmp7, p)
    z5 = mul(addmod(z3, z4, p), 3)
    tmp4 = mul(tmp4, 4)
    tmp5 = mul(tmp5, 5)
    tmp6 = mul(tmp6, 6)
    tmp7 = mul(tmp7, 7)
    z1 = mul(z1, 8)
    z2 = mul(z2, 9)
    z3 = mul(z3, 10)
    z4 = mul(z4, 11)
    z3 = addmod(z3, z5, p)
    z4 = addmod(z4, z5, p)
    out7 = addmod(addmod(tmp4, z1, p), z3, p)
    out5 = addmod(addmod(tmp5, z2, p), z4, p)
    out3 = addmod(addmod(tmp6, z2, p), z3, p)
    out1 = addmod(addmod(tmp7, z1, p), z4, p)
    outs = [out0, out1, out2, out3, out4, out5, out6, out7]
    if scale_eighth:
        outs = [mul(o, 12) for o in outs]
    return outs


def dct2d_plain(chan: torch.Tensor, aan_pass) -> torch.Tensor:
    """int64 [nb, 64, 2, lanes] -> uint32: ``aan_pass(slots, column)`` over
    the 8 slots s of every group g (row pass), then over the 8 groups g of
    every slot s (column pass, which applies the x0.125 scaling)."""
    nb, lanes = chan.shape[0], chan.shape[-1]
    v = chan.reshape(nb, 8, 8, 2, lanes)  # [nb, g, s, 2, lanes]
    rows = aan_pass([v[:, :, s] for s in range(8)], False)
    w = torch.stack(rows, dim=2)  # [nb, g, s, 2, lanes]
    cols = aan_pass([w[:, g] for g in range(8)], True)
    return to_u32(torch.stack(cols, dim=1)).reshape(nb, 64, 2, lanes)


def server_ycc_dct_plain(x: torch.Tensor, state) -> torch.Tensor:
    """uint32 [nb, 3, 64, 2, L, n] NTT domain -> same shape and layout.

    state: anything with ``consts`` and ``consts_shoup``, the two
    ``[24, L*n]`` uint32 tables of ``pack_server_constants`` on x's device
    (a ``convert.ServerState``)."""
    nb, ch, ns, comps, L, n = x.shape
    assert (ch, ns, comps) == (3, 64, 2), x.shape
    lanes = L * n
    C = to_i64(state.consts)
    Csh = to_i64(state.consts_shoup)
    p = C[_P_ROW]

    def mul(v, row):
        return mulmod_shoup(v, C[row], Csh[row], p)

    def ycc_mul(v, i):
        return mul(v, N_DCT + i)

    xf = to_i64(x).reshape(nb, 3, 64, 2, lanes)
    r, g, b = xf[:, 0], xf[:, 1], xf[:, 2]  # [nb, 64, 2, lanes]
    y = addmod(addmod(ycc_mul(r, 0), ycc_mul(g, 1), p), ycc_mul(b, 2), p)
    cb = addmod(submod(ycc_mul(r, 3), ycc_mul(g, 4), p), ycc_mul(b, 5), p)
    cr = submod(submod(ycc_mul(r, 5), ycc_mul(g, 6), p), ycc_mul(b, 7), p)
    del xf, r, g, b
    # sub_plain(128) on ciphertext component 0 of Y only
    y[:, :, 0] = submod(y[:, :, 0], C[_SUB_ROW], p)
    outs = [dct2d_plain(chan, lambda a, column: _aan_pass(a, mul, p, column))
            for chan in (y, cb, cr)]
    return torch.stack(outs, dim=1).reshape(x.shape)


# ---------------------------------------------------------------------------
# Lazy plain version: the op graph of _make_lazy_kernel(m), step for step.
# ---------------------------------------------------------------------------


def lazy_bound_multiple(ev) -> int:
    """Row-pass input bound multiple m for the lazy kernel, or 0 when the
    primes leave under 8p of u32 headroom (use the strict kernel then);
    fhetpu/core/pallas_server.py:lazy_bound_multiple."""
    max_p = max(int(p) for p in ev.params.q_primes)
    hr = (1 << 32) // max_p
    if hr >= 16:
        return 2
    if hr >= 8:
        return 1
    return 0


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The headroom argument, checked: every value the lazy kernel holds in
    a uint32 register is in [0, 2^32), so int64 computes the same bits."""
    assert not torch.any(x >> 32), "lazy intermediate outside [0, 2^32)"
    return x


def _lazy_mul(x, w, ws, p):
    """x*w - floor(x*ws/2^32)*p in [0, 2p) for any x < 2^32 (the kernels'
    mulmod_shoup_lazy).  x*ws reaches 2^64, so the quotient is taken over
    x's 16-bit halves: floor((x_hi*ws + floor(x_lo*ws / 2^16)) / 2^16)."""
    x = _u32(x)
    q = ((x >> 16) * ws + (((x & 0xFFFF) * ws) >> 16)) >> 16
    return x * w - q * p


def _red_to(x, p, from_m: int, to_m: int):
    """Reduce x < from_m*p to [0, to_m*p) by conditional subtractions of
    power-of-two multiples of p (pallas_server.py:_red_to)."""
    x = _u32(x)
    t = 1
    while t * 2 < from_m:
        t *= 2
    while t >= to_m:
        x = torch.where(x >= t * p, x - t * p, x)
        t //= 2
    return x


def _aan_pass_lazy(a, mul, p, m: int, column: bool):
    """pallas_server.py:_aan_pass_lazy over inputs < m*p, then the kernel's
    reduction: to [0, m*p) after a row pass, canonical after the x0.125
    column scaling."""
    mp, mp2, mp4 = m * p, 2 * m * p, 4 * m * p
    tmp0 = a[0] + a[7]
    tmp7 = a[0] + mp - a[7]
    tmp1 = a[1] + a[6]
    tmp6 = a[1] + mp - a[6]
    tmp2 = a[2] + a[5]
    tmp5 = a[2] + mp - a[5]
    tmp3 = a[3] + a[4]
    tmp4 = a[3] + mp - a[4]
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 + mp2 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 + mp2 - tmp2
    out0 = tmp10 + tmp11
    out4 = tmp10 + mp4 - tmp11
    z1 = mul(tmp12 + tmp13, 0)
    out2 = z1 + mul(tmp13, 1)
    out6 = z1 + mul(tmp12, 2)
    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = mul(z3 + z4, 3)
    tmp4 = mul(tmp4, 4)
    tmp5 = mul(tmp5, 5)
    tmp6 = mul(tmp6, 6)
    tmp7 = mul(tmp7, 7)
    z1 = mul(z1, 8)
    z2 = mul(z2, 9)
    z3 = mul(z3, 10)
    z4 = mul(z4, 11)
    z3 = z3 + z5
    z4 = z4 + z5
    out7 = tmp4 + z1 + z3
    out5 = tmp5 + z2 + z4
    out3 = tmp6 + z2 + z3
    out1 = tmp7 + z1 + z4
    outs = [out0, out1, out2, out3, out4, out5, out6, out7]
    if column:
        return [_red_to(mul(o, 12), p, 2, 1) for o in outs]
    return [_red_to(o, p, 8 * m, m) for o in outs]


def server_ycc_dct_lazy_plain(x: torch.Tensor, state, m: int) -> torch.Tensor:
    """The lazy kernel's op graph in int64 torch: uint32 [nb, 3, 64, 2, L, n]
    NTT domain -> same shape, bit-identical to ``server_ycc_dct_plain``.
    m = ``lazy_bound_multiple``; the bound is checked at every reduction and
    product (``_u32``)."""
    nb, ch, ns, comps, L, n = x.shape
    assert (ch, ns, comps) == (3, 64, 2), x.shape
    assert m in (1, 2), m
    lanes = L * n
    C = to_i64(state.consts)
    Csh = to_i64(state.consts_shoup)
    p = C[_P_ROW]

    def mul(v, row):
        return _lazy_mul(v, C[row], Csh[row], p)

    def ycc_mul(v, i):
        return mul(v, N_DCT + i)

    xf = to_i64(x).reshape(nb, 3, 64, 2, lanes)
    r, g, b = xf[:, 0], xf[:, 1], xf[:, 2]  # [nb, 64, 2, lanes]
    y = ycc_mul(r, 0) + ycc_mul(g, 1) + ycc_mul(b, 2)  # < 6p
    cb = ycc_mul(r, 3) + 2 * p - ycc_mul(g, 4) + ycc_mul(b, 5)
    cr = ycc_mul(r, 5) + 4 * p - ycc_mul(g, 6) - ycc_mul(b, 7)
    del xf, r, g, b
    # sub_plain(128) on ciphertext component 0 of Y; both components get +p
    sub_c0 = torch.stack([C[_SUB_ROW], torch.zeros_like(p)])  # [2, lanes]
    y = y + p - sub_c0
    y, cb, cr = (_red_to(c, p, 8, m) for c in (y, cb, cr))
    outs = [dct2d_plain(chan, lambda a, column: _aan_pass_lazy(a, mul, p, m, column))
            for chan in (y, cb, cr)]
    return torch.stack(outs, dim=1).reshape(x.shape)


# ---------------------------------------------------------------------------
# Wrapper: the kernel on CUDA tensors, the plain version on CPU tensors.
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
_LAZY_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]


def check_kernel_args(x: torch.Tensor, state, what: str, channels=(3,)):
    """Raise unless x is a contiguous uint32 [nb, ch, 64, 2, L, n] with ch in
    ``channels`` and the state's two [24, L*n] uint32 tables lie on x's
    device."""
    if x.dtype != torch.uint32:
        raise TypeError(f"{what} takes uint32 residues, got {x.dtype}")
    if x.dim() != 6 or x.shape[1] not in channels or tuple(x.shape[2:4]) != (64, 2):
        raise ValueError(f"{what} expects [nb, ch, 64, 2, L, n] with ch in {channels}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} expects a contiguous tensor")
    lanes = x.shape[4] * x.shape[5]
    for t in (state.consts, state.consts_shoup):
        if t.device != x.device or t.dtype != torch.uint32 or tuple(t.shape) != (_ROWS, lanes):
            raise ValueError(f"constant table {t.dtype} {tuple(t.shape)} on {t.device} does "
                             f"not fit uint32 [{_ROWS}, {lanes}] on {x.device}")


def _launch(x: torch.Tensor, state, m: int) -> torch.Tensor:
    """m = 0: the strict kernel; m = 1 or 2: the lazy kernel."""
    check_kernel_args(x, state, "server kernel")
    out = torch.empty_like(x)
    nb, lanes = x.shape[0], x.shape[4] * x.shape[5]
    if nb == 0:
        return out
    args = [x.data_ptr(), out.data_ptr(), state.consts.data_ptr(),
            state.consts_shoup.data_ptr(), nb, lanes]
    if m == 0:
        name, argtypes = "fhetpu_server_ycc_dct", _ARGTYPES
    else:
        name, argtypes = "fhetpu_server_ycc_dct_lazy", _LAZY_ARGTYPES
        args.append(m)
    fn = getattr(build.lib(), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    build.check(fn(*args, torch.cuda.current_stream(x.device).cuda_stream), name)
    return out


def server_ycc_dct_fused(ev, x: torch.Tensor, lazy: bool = False) -> torch.Tensor:
    """x: uint32 [nb, 3, 64, 2, L, n] NTT-domain ciphertexts -> same shape.

    Launches the strict fused kernel for a CUDA tensor and runs
    ``server_ycc_dct_plain`` for a CPU tensor; the constants are the
    evaluator's, uploaded once per device (``Evaluator.server_state``).

    lazy=True takes the lazy-reduction kernel (``server_ycc_dct_lazy_plain``
    on a CPU tensor), with the same output bits, and counts its launches in
    ``lazy_launches``.  It raises ValueError where the primes leave under 8p
    of u32 headroom (``lazy_bound_multiple`` is 0: n=16384's 30-bit chain),
    as fhetpu does; the strict kernel serves there."""
    m = lazy_bound_multiple(ev) if lazy else 0
    if lazy and not m:
        raise ValueError(
            "lazy kernel needs >= 8p of u32 headroom (primes < 2^29); "
            "use the strict kernel at this ring degree")
    state = ev.server_state(x.device)
    if x.device.type == "cuda":
        out = _launch(x, state, m)
        if lazy:
            server_ycc_dct_fused.lazy_launches += 1
        else:
            server_ycc_dct_fused.launches += 1
        return out
    if x.device.type != "cpu":
        raise ValueError(f"no server kernel for device {x.device}")
    return server_ycc_dct_lazy_plain(x, state, m) if lazy else server_ycc_dct_plain(x, state)


server_ycc_dct_fused.launches = 0
server_ycc_dct_fused.lazy_launches = 0
