"""Encrypted image resize: bilinear / bicubic.

Port of ``fhetpu/pipelines/resize.py`` (the reference's sampling and
interpolation, fhe_resize.h:143-392):

* coordinate mapping u = x/(W'-1)*W - 0.5, xint = trunc(u),
  xfract = u - floor(u) (float32 math like the C++);
* edge-clamped stencils;
* Linear: (1-t)*A + t*B with two ct*ct multiplies, output size 4;
* Cubic: Catmull-Rom with t^2 = square(t), t^3 = t^2*t and unrelinearized
  ct*ct products: horizontal results are size 5 and the vertical pass
  gives size 8;
* fractional offsets encrypted on the server under the client's public key
  like the reference; with plain fracts they are multiplied in as plaintext
  operands instead, which decrypts to the same polynomials.

A whole output tile is one batched computation: stencils are gathered with
``index_select``, fract operands are stacked along the output axes, and
every interpolation op runs over [rows', cols', channels] by broadcasting
(fract ciphertexts broadcast against pixel ciphertexts).  fhetpu's jit,
pytree registration and cache of compiled closures have no counterpart:
torch runs the ops as they come.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..bfv import golden as g
from ..bfv.evaluator import Ct, DeviceOperand, PlainOperand
from ..trace import span

BILINEAR = 0
BICUBIC = 1


# ---------------------------------------------------------------------------
# static sampling plan
# ---------------------------------------------------------------------------


@dataclass
class AxisPlan:
    idx: np.ndarray  # [out, taps] clamped source indices
    fract: np.ndarray  # [out] fractional offsets in [0,1)


def axis_plan(src: int, dst: int, mode: int) -> AxisPlan:
    taps = 2 if mode == BILINEAR else 4
    lo = 0 if mode == BILINEAR else -1
    idx = np.zeros((dst, taps), dtype=np.int64)
    fract = np.zeros(dst, dtype=np.float64)
    for x in range(dst):
        # float32 coordinate math like the reference (fhe_resize.h:351,382)
        u = float(np.float32(x) / np.float32(dst - 1) * np.float32(src) - np.float32(0.5))
        xi = int(u)  # C truncation toward zero
        fract[x] = u - math.floor(u)
        for k in range(taps):
            idx[x, k] = min(max(xi + lo + k, 0), src - 1)
    return AxisPlan(idx=idx, fract=fract)


# ---------------------------------------------------------------------------
# fract operands: stacked plaintext tables or encrypted ciphertext powers
# ---------------------------------------------------------------------------


class StackedPlain:
    """Duck-typed PlainOperand whose tables are stacked along output axes
    and reshaped to broadcast against tile data [R', C', ch, size, L, n];
    ``on(device)`` uploads them once per device."""

    def __init__(self, mul_ntt, mul_ntt_shoup):
        self.mul_ntt = mul_ntt
        self.mul_ntt_shoup = mul_ntt_shoup
        self._on: dict = {}

    def on(self, device) -> DeviceOperand:
        device = torch.device(device)
        if device not in self._on:
            def up(a):
                return torch.from_numpy(a.astype(np.int64)).to(device)

            self._on[device] = DeviceOperand(up(self.mul_ntt), up(self.mul_ntt_shoup),
                                             None, None)
        return self._on[device]


def stack_plain_operands_coeffs(ev, coeff_list, bshape):
    """plaintext coeff arrays [k][n] -> StackedPlain with tables
    [*bshape, 1, L, n]; bshape is the broadcast layout with
    prod(bshape) == k (e.g. (1, k, 1) for columns, (k, 1, 1) for rows).
    The extra 1 spans the ciphertext size axis."""
    ops = [PlainOperand(ev.params, c) for c in coeff_list]
    mul = np.stack([o.mul_ntt for o in ops])  # [k, L, n]
    sh = np.stack([o.mul_ntt_shoup for o in ops])
    newshape = tuple(bshape) + (1,) + mul.shape[1:]
    return StackedPlain(mul.reshape(newshape), sh.reshape(newshape))


def fract_polys(encoder, fracs, mode):
    """Plaintext polynomials for t, 1-t (and t^2, t^3) computed the way the
    homomorphic pipeline computes them: POLYNOMIAL arithmetic on the
    encoding of f, not encodings of the composed values (encode(1) -
    encode(f) != encode(1-f) as polynomials even though the values agree;
    bit-exact parity with the reference requires the former)."""
    t_mod = encoder.t
    one = encoder.encode(1.0).coeffs
    ts, omts, t2s, t3s = [], [], [], []
    for f in fracs:
        tc = encoder.encode(float(f)).coeffs
        ts.append(tc)
        omts.append(g.add(one, g.neg(tc, t_mod), t_mod))
        if mode == BICUBIC:
            t2c = g.mult(tc, tc, t_mod)
            t3s_c = g.mult(t2c, tc, t_mod)
            t2s.append(t2c)
            t3s.append(t3s_c)
    return ts, omts, t2s, t3s


class EncryptedFracts:
    """t, 1-t (bilinear) or t, t^2, t^3 (bicubic) ciphertexts shaped to
    broadcast along an axis, on the evaluator's device.  The offsets are
    encrypted on the host with NumPy.  With relin keys, every ct*ct
    product is keyswitched back to size 2."""

    def __init__(self, ev, encryptor, fracs, bshape, mode, relin=None):
        coeffs = ev.encoder.encode_batch(np.asarray(fracs, dtype=np.float64))
        cts = encryptor.encrypt_batch(coeffs)  # [k, 2, L, n]
        newshape = tuple(bshape) + cts.shape[-3:]
        self.t = Ct(torch.from_numpy(cts.reshape(newshape)).to(ev.device), False)
        if mode == BICUBIC:
            self.t2 = _maybe_relin(ev, ev.square(self.t), relin)  # size 3 (fhe_resize.h:174)
            self.t3 = _maybe_relin(ev, ev.multiply(self.t2, self.t), relin)  # size 4 (:175)
        else:
            self.one_minus_t = ev.add_plain(ev.negate(self.t), ev.encode(1.0))


def _maybe_relin(ev, ct, relin):
    return ev.relinearize(ct, relin) if relin is not None and ct.size > 2 else ct


# ---------------------------------------------------------------------------
# interpolation networks (duck-typed over Evaluator / GoldenEvaluator)
# ---------------------------------------------------------------------------


def linear_interp(ev, A, B, fr, plain: bool, relin=None):
    if plain:
        return ev.add(
            ev.multiply_plain(A, fr.one_minus_t), ev.multiply_plain(B, fr.t)
        )
    return ev.add(
        _maybe_relin(ev, ev.multiply(fr.one_minus_t, A), relin),
        _maybe_relin(ev, ev.multiply(B, fr.t), relin),
    )


def cubic_interp(ev, A, B, C, D, fr, plain: bool, relin=None):
    with span("pipelines.resize.cubic_interp"):
        three = ev.encode(3.0)
        a = ev.sub(ev.multiply_plain(B, three), A)
        a = ev.sub(a, ev.multiply_plain(C, three))
        a = ev.add(a, D)
        b = ev.sub(
            ev.multiply_plain(A, ev.encode(2.0)), ev.multiply_plain(B, ev.encode(5.0))
        )
        b = ev.add(b, ev.multiply_plain(C, ev.encode(4.0)))
        b = ev.sub(b, D)
        c = ev.sub(C, A)
        d = B
        if plain:
            at3 = ev.multiply_plain(a, fr.t3)
            bt2 = ev.multiply_plain(b, fr.t2)
            ct1 = ev.multiply_plain(c, fr.t)
        else:
            at3 = _maybe_relin(ev, ev.multiply(a, fr.t3), relin)
            bt2 = _maybe_relin(ev, ev.multiply(b, fr.t2), relin)
            ct1 = _maybe_relin(ev, ev.multiply(c, fr.t), relin)
        s = ev.add(ev.add(at3, bt2), ct1)
        s = ev.multiply_plain(s, ev.encode(0.5))
        return ev.add(s, d)


# ---------------------------------------------------------------------------
# batched tile computation (device)
# ---------------------------------------------------------------------------


class PlainFracts:
    """Per-axis plaintext fract operand bundle for the plain-fract path.
    Operand polynomials mirror the homomorphic computation exactly
    (fract_polys), so its decrypted output equals the encrypted-fract
    path's."""

    def __init__(self, ev, fracs, bshape, mode):
        ts, omts, t2s, t3s = fract_polys(ev.encoder, fracs, mode)
        self.t = stack_plain_operands_coeffs(ev, ts, bshape)
        self.one_minus_t = stack_plain_operands_coeffs(ev, omts, bshape)
        if mode == BICUBIC:
            self.t2 = stack_plain_operands_coeffs(ev, t2s, bshape)
            self.t3 = stack_plain_operands_coeffs(ev, t3s, bshape)


def make_fract_bundles(ev, row_plan, col_plan, mode, encryptor=None,
                       relin=None):
    """Build (yops, xops) for a full output grid [R', C'].

    encryptor=None -> plain-fract path.  Broadcast shapes: x along axis 1
    of (rows, cols, channels), y along axis 0.
    """
    R, C = len(row_plan.fract), len(col_plan.fract)
    if encryptor is None:
        yops = PlainFracts(ev, row_plan.fract, (R, 1, 1), mode)
        xops = PlainFracts(ev, col_plan.fract, (1, C, 1), mode)
    else:
        yops = EncryptedFracts(ev, encryptor, row_plan.fract, (R, 1, 1), mode,
                               relin)
        xops = EncryptedFracts(ev, encryptor, col_plan.fract, (1, C, 1), mode,
                               relin)
    return yops, xops


def resize_tile(ev, src, row_plan: AxisPlan, col_plan: AxisPlan, yops, xops,
                mode: int, plain: bool, relin=None) -> torch.Tensor:
    """src: [H, W, 3, 2, L, n] coefficient-domain ciphertext grid on the
    evaluator's device.  Returns uint32 [R', C', 3, size, L, n]
    (coefficient domain)."""
    with span("pipelines.resize.resize_tile"):
        taps = 2 if mode == BILINEAR else 4
        R, C = row_plan.idx.shape[0], col_plan.idx.shape[0]

        def index(plan):
            return torch.from_numpy(np.ascontiguousarray(plan.idx.T).reshape(-1)).to(src.device)

        # gather [taps_y, taps_x, R', C', 3, 2, L, n]
        with span("pipelines.resize.gather"):
            rows = src.index_select(0, index(row_plan)).reshape((taps, R) + src.shape[1:])
            grid = rows.index_select(2, index(col_plan))
            grid = grid.reshape((taps, R, taps, C) + src.shape[2:])
            grid = grid.permute(0, 2, 1, 3, 4, 5, 6, 7).contiguous()

        if plain:
            grid = ev.transform_to_ntt(Ct(grid, False)).data

        def cell(r, c):
            return Ct(grid[r, c], plain)

        interp_cols = []
        for r in range(taps):
            if mode == BILINEAR:
                interp_cols.append(
                    linear_interp(ev, cell(r, 0), cell(r, 1), xops, plain, relin)
                )
            else:
                interp_cols.append(
                    cubic_interp(ev, cell(r, 0), cell(r, 1), cell(r, 2), cell(r, 3),
                                 xops, plain, relin)
                )
        if mode == BILINEAR:
            out = linear_interp(ev, interp_cols[0], interp_cols[1], yops, plain,
                                relin)
        else:
            out = cubic_interp(ev, interp_cols[0], interp_cols[1], interp_cols[2],
                               interp_cols[3], yops, plain, relin)
        if plain:
            out = ev.transform_from_ntt(out)
        return out.data.to(torch.uint32)


# ---------------------------------------------------------------------------
# float reference implementations (oracles)
# ---------------------------------------------------------------------------


def resize_float(img: np.ndarray, dst_h: int, dst_w: int, mode: int) -> np.ndarray:
    """Plain-arithmetic version of the same sampler (double precision), the
    value oracle for the encrypted pipeline."""
    rp = axis_plan(img.shape[0], dst_h, mode)
    cp = axis_plan(img.shape[1], dst_w, mode)
    x = img.astype(np.float64)
    gr = x[rp.idx.T][:, :, cp.idx.T, ...]  # [ty, R', tx, C', ch]
    gr = np.moveaxis(gr, 2, 1)  # [ty, tx, R', C', ch]
    fy = rp.fract[:, None, None]
    fx = cp.fract[None, :, None]

    def lin(a, b, t):
        return (1.0 - t) * a + t * b

    def cub(A, B, C, D, t):
        a = -A + 3 * B - 3 * C + D
        b = 2 * A - 5 * B + 4 * C - D
        c = C - A
        d = B
        return 0.5 * (a * t ** 3 + b * t ** 2 + c * t) + d

    if mode == BILINEAR:
        c0 = lin(gr[0, 0], gr[0, 1], fx)
        c1 = lin(gr[1, 0], gr[1, 1], fx)
        return lin(c0, c1, fy)
    cols = [cub(gr[r, 0], gr[r, 1], gr[r, 2], gr[r, 3], fx) for r in range(4)]
    return cub(cols[0], cols[1], cols[2], cols[3], fy)


def clamp_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)
