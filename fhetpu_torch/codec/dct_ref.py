"""Plaintext reference DCT (SURVEY.md C8): the double-precision AAN network
(fhe_image.h:399-491, duplicated in tests/dct.cpp) as a public library
function -- the golden model the encrypted DCT is validated against.
The port's own copy of ``fhetpu/codec/dct_ref.py``."""

from __future__ import annotations

import numpy as np


def _pass1d(v: np.ndarray) -> np.ndarray:
    tmp0, tmp7 = v[0] + v[7], v[0] - v[7]
    tmp1, tmp6 = v[1] + v[6], v[1] - v[6]
    tmp2, tmp5 = v[2] + v[5], v[2] - v[5]
    tmp3, tmp4 = v[3] + v[4], v[3] - v[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o = np.empty(8, dtype=np.float64)
    o[0], o[4] = tmp10 + tmp11, tmp10 - tmp11
    z1 = (tmp12 + tmp13) * 0.541196100
    o[2] = z1 + tmp13 * 0.765366865
    o[6] = z1 + tmp12 * -1.847759065
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 1.175875602
    tmp4 *= 0.298631336
    tmp5 *= 2.053119869
    tmp6 *= 3.072711026
    tmp7 *= 1.501321110
    z1 *= -0.899976223
    z2 *= -2.562915447
    z3 = z3 * -1.961570560 + z5
    z4 = z4 * -0.390180644 + z5
    o[7] = tmp4 + z1 + z3
    o[5] = tmp5 + z2 + z4
    o[3] = tmp6 + z2 + z3
    o[1] = tmp7 + z1 + z4
    return o


def dct(block: np.ndarray) -> np.ndarray:
    """Forward 2-D AAN DCT of one 8x8 block (row pass, then column pass
    with /8 scaling) -- identical math to the encrypted network."""
    d = block.astype(np.float64).reshape(8, 8).copy()
    for r in range(8):
        d[r] = _pass1d(d[r])
    for c in range(8):
        d[:, c] = _pass1d(d[:, c]) / 8.0
    return d.reshape(block.shape)


def dct_blocks(blocks: np.ndarray) -> np.ndarray:
    """[nb, 64] or [nb, 8, 8] -> same shape, per-block DCT."""
    out = np.empty_like(blocks, dtype=np.float64)
    for i in range(blocks.shape[0]):
        out[i] = dct(blocks[i])
    return out
