"""Plain reference of the encrypted bicubic resize: the plaintext that each
output ciphertext has to decrypt to.

The reference's sampler (``fhe_resize.h:351,382``): u = x / (W' - 1) * W
- 0.5 in float32, the taps trunc(u) - 1 .. trunc(u) + 2 clamped to the
image, the offset t = u - floor(u).  Its Catmull-Rom step (``Cubic``,
``fhe_resize.h:143-189``): a = -A + 3B - 3C + D, b = 2A - 5B + 4C - D,
c = C - A, d = B, out = 0.5 (a t^3 + b t^2 + c t) + d; ``SampleBicubic``
(``:254-305``) runs it along each of the stencil's 4 rows, then once down
their results.  Everything is a polynomial mod t in Z_t[X]/(X^n + 1): the
pixels encoded as integers, t^2 = t t and t^3 = t^2 t as polynomials, and
each constant 3, 2, 5, 4 and 0.5 the encoder's polynomial for it, since the
server multiplies by encoded plaintexts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ring import Encoder

TAPS = (-1, 0, 1, 2)


def axis_plan(src: int, dst: int) -> tuple:
    """(taps [dst, 4], offsets [dst]) of one axis."""
    taps = np.zeros((dst, len(TAPS)), dtype=np.int64)
    offs = np.zeros(dst, dtype=np.float64)
    for x in range(dst):
        u = float(np.float32(x) / np.float32(dst - 1) * np.float32(src) - np.float32(0.5))
        lo = int(u)  # truncation toward zero, as in C
        offs[x] = u - math.floor(u)
        taps[x] = [min(max(lo + k, 0), src - 1) for k in TAPS]
    return taps, offs


def _negashift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * X^k in Z[X]/(X^n + 1) over the last axis, 0 <= k < n."""
    if k == 0:
        return a
    return torch.cat((-a[..., -k:], a[..., :-k]), dim=-1)


def _support(a: torch.Tensor) -> list:
    """The positions at which some polynomial of ``a`` is non-zero."""
    return torch.nonzero(a.reshape(-1, a.shape[-1]).any(dim=0)).reshape(-1).tolist()


def poly_mul(a: torch.Tensor, b: torch.Tensor, t: int) -> torch.Tensor:
    """a * b mod t in Z_t[X]/(X^n + 1), polynomials [..., n] in [0, t) that
    broadcast; sums one shifted copy of the denser operand for each
    position of the sparser one."""
    sa, sb = _support(a), _support(b)
    if len(sa) < len(sb):
        a, b, sb = b, a, sa
    out = torch.zeros(torch.broadcast_shapes(a.shape, b.shape), dtype=torch.int64,
                      device=a.device)
    for k in sb:
        out += b[..., k:k + 1] * _negashift(a, k)
    return out % t


class CubicResizeReference:
    def __init__(self, encoder: Encoder, src_hw: tuple, dst_hw: tuple, device):
        self.enc, self.device = encoder, torch.device(device)
        self.rows = axis_plan(src_hw[0], dst_hw[0])
        self.cols = axis_plan(src_hw[1], dst_hw[1])
        self.three, self.two, self.five, self.four, self.half = (
            self._poly(v) for v in (3.0, 2.0, 5.0, 4.0, 0.5))

    def _poly(self, value: float) -> torch.Tensor:
        return torch.from_numpy(self.enc.encode(value)).to(self.device)

    def _fracts(self, offs) -> tuple:
        """(t, t^2, t^3) polynomials [k, n]."""
        t1 = torch.stack([self._poly(f) for f in offs])
        t2 = poly_mul(t1, t1, self.enc.t)
        return t1, t2, poly_mul(t2, t1, self.enc.t)

    def cubic(self, A, B, C, D, fr) -> torch.Tensor:
        """One Catmull-Rom step over polynomials [..., n] with the fract
        polynomials ``fr`` = (t, t^2, t^3), broadcast against them."""
        t = self.enc.t

        def mul(x, y):
            return poly_mul(x, y, t)

        a = (mul(B, self.three) - A - mul(C, self.three) + D) % t
        b = (mul(A, self.two) - mul(B, self.five) + mul(C, self.four) - D) % t
        s = (mul(a, fr[2]) + mul(b, fr[1]) + mul((C - A) % t, fr[0])) % t
        return (mul(s, self.half) + B) % t

    def plain(self, pixels: np.ndarray) -> torch.Tensor:
        """Pixels uint8 [H, W, C] -> the expected plaintexts int64
        [H', W', C, n] in [0, t)."""
        n = self.enc.n
        (ry, ty), (cx, tx) = self.rows, self.cols
        fy = [f[:, None, None] for f in self._fracts(ty)]  # [H', 1, 1, n]
        fx = [f[None, :, None] for f in self._fracts(tx)]  # [1, W', 1, n]
        px = torch.from_numpy(pixels.astype(np.int64)).to(self.device)
        enc = torch.zeros(px.shape + (n,), dtype=torch.int64, device=self.device)
        enc[..., :8] = torch.stack([(px >> k) & 1 for k in range(8)], dim=-1)  # integers

        def row(r):  # the step along the stencil's row r: [H', W', C, n]
            taps = enc[ry[:, r]]
            return self.cubic(*(taps[:, cx[:, c]] for c in range(len(TAPS))), fx)

        return self.cubic(*(row(r) for r in range(len(TAPS))), fy)
