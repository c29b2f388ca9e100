"""Plain reference of the encrypted bilinear resize: the plaintext that each
output ciphertext has to decrypt to.

The reference's sampler (``fhe_resize.h:143-392``): u = x / (W' - 1) * W
- 0.5 in float32, the taps trunc(u) and trunc(u) + 1 clamped to the image,
the offset t = u - floor(u).  Each output is
(1 - ty) ((1 - tx) A + tx B) + ty ((1 - tx) C + tx D)
as polynomials mod t in Z_t[X]/(X^n + 1), where the pixels are encoded as
integers and 1 - t is encode(1) - encode(t), the polynomial the server
computes from an encrypted t.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ring import Encoder


def axis_plan(src: int, dst: int) -> tuple:
    """(taps [dst, 2], offsets [dst]) of one axis."""
    taps = np.zeros((dst, 2), dtype=np.int64)
    offs = np.zeros(dst, dtype=np.float64)
    for x in range(dst):
        u = float(np.float32(x) / np.float32(dst - 1) * np.float32(src) - np.float32(0.5))
        lo = int(u)  # truncation toward zero, as in C
        offs[x] = u - math.floor(u)
        taps[x] = [min(max(lo + k, 0), src - 1) for k in (0, 1)]
    return taps, offs


def _negashift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * X^k in Z[X]/(X^n + 1) over the last axis, 0 <= k < n."""
    if k == 0:
        return a
    return torch.cat((-a[..., -k:], a[..., :-k]), dim=-1)


def _sparse_mul(dense: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
    """dense [..., n] times the polynomials sparse [..., n] (broadcast),
    summed over the non-zero positions of sparse."""
    out = torch.zeros(torch.broadcast_shapes(dense.shape, sparse.shape),
                      dtype=torch.int64, device=dense.device)
    for k in torch.nonzero(sparse.reshape(-1, sparse.shape[-1]).any(dim=0)).reshape(-1).tolist():
        out += sparse[..., k:k + 1] * _negashift(dense, k)
    return out


class ResizeReference:
    def __init__(self, encoder: Encoder, src_hw: tuple, dst_hw: tuple, device):
        self.enc, self.device = encoder, torch.device(device)
        self.rows = axis_plan(src_hw[0], dst_hw[0])
        self.cols = axis_plan(src_hw[1], dst_hw[1])

    def _fracts(self, offs) -> tuple:
        """(t, 1 - t) polynomials [k, n]."""
        one = self.enc.encode(1.0)
        ts = np.stack([self.enc.encode(f) for f in offs])
        return (torch.from_numpy(ts).to(self.device),
                torch.from_numpy(np.mod(one - ts, self.enc.t)).to(self.device))

    def plain(self, pixels: np.ndarray) -> torch.Tensor:
        """Pixels uint8 [H, W, 3] -> the expected plaintexts int64
        [H', W', 3, n] in [0, t)."""
        t, n = self.enc.t, self.enc.n
        (ry, ty), (cx, tx) = self.rows, self.cols
        fy, omfy = self._fracts(ty)  # [H', n]
        fx, omfx = self._fracts(tx)  # [W', n]
        px = torch.from_numpy(pixels.astype(np.int64)).to(self.device)
        bits = torch.stack([(px >> k) & 1 for k in range(8)], dim=-1)  # [H, W, 3, 8]
        enc = torch.zeros(bits.shape[:-1] + (n,), dtype=torch.int64, device=self.device)
        enc[..., :8] = bits  # integer pixels: binary digits in x^0 .. x^7

        def horizontal(r):  # (1 - tx) A + tx B over the row taps r [H']
            a = enc[r][:, cx[:, 0]]  # [H', W', 3, n]
            b = enc[r][:, cx[:, 1]]
            return (_sparse_mul(omfx[None, :, None], a) + _sparse_mul(fx[None, :, None], b)) % t

        top, bottom = horizontal(ry[:, 0]), horizontal(ry[:, 1])
        out = _sparse_mul(top, omfy[:, None, None]) + _sparse_mul(bottom, fy[:, None, None])
        return out % t
