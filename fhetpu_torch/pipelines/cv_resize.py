"""The port's own copy of ``fhetpu/pipelines/cv_resize.py`` (tests hold the
two equal), the resize client's RMS ground truth.

Float reimplementation of OpenCV's resize (INTER_LINEAR / INTER_CUBIC)
used as the reference's RMS ground truth (compare_resize_opencv,
fhe_resize.h:35-68).  OpenCV maps destination pixel x to source coordinate
(x + 0.5) * scale - 0.5 (unlike the FHE sampler's x/(dst-1)*src - 0.5 --
that mismatch is why the reference reports RMS ~18 even on success), uses
a = -0.75 for the cubic kernel, and border-replicates.  ``cv_ground_truth``
runs cv2 where OpenCV is importable and otherwise the bit-exact model of
its fixed-point path.
"""

from __future__ import annotations

import numpy as np


def _cubic_weights(f: float, a: float = -0.75):
    # OpenCV interpolateCubic
    w = np.zeros(4)
    w[0] = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    w[1] = ((a + 2) * f - (a + 3)) * f * f + 1
    w[2] = ((a + 2) * (1 - f) - (a + 3)) * (1 - f) * (1 - f) + 1
    w[3] = 1.0 - w[0] - w[1] - w[2]
    return w


INTER_RESIZE_COEF_BITS = 11
INTER_RESIZE_COEF_SCALE = 1 << INTER_RESIZE_COEF_BITS


def _fixpt_maps(src: int, dst: int, ksize: int):
    """OpenCV resize.cpp coefficient tables for the 8-bit fixed-point path:
    per output index, the clamped base source index and ksize short
    coefficients (saturate_cast<short>(w * 2048), round-half-even), with the
    exact border clamping (sx<0 -> f=0,sx=0; sx>=src-1 -> f=0,sx=src-1)."""
    ksize2 = ksize // 2
    scale = src / dst
    ofs = np.zeros(dst, dtype=np.int64)
    coef = np.zeros((dst, ksize), dtype=np.int64)
    for d in range(dst):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = int(np.floor(f))
        f = np.float32(f - s)
        if s < ksize2 - 1 and s < 0:
            f, s = np.float32(0.0), 0
        if s + ksize2 >= src and s >= src - 1:
            f, s = np.float32(0.0), src - 1
        if ksize == 2:
            cbuf = np.array([np.float32(1.0) - f, f], dtype=np.float32)
        else:
            cbuf = _cubic_weights_f32(f)
        ofs[d] = s
        # saturate_cast<short>(cbuf[k] * 2048.f): float32 product, cvRound
        coef[d] = np.rint(
            (cbuf * np.float32(INTER_RESIZE_COEF_SCALE)).astype(np.float64)
        ).astype(np.int64)
    return ofs, coef


def _cubic_weights_f32(f):
    """OpenCV interpolateCubic in float32 arithmetic."""
    a = np.float32(-0.75)
    f = np.float32(f)
    one = np.float32(1.0)
    w = np.zeros(4, dtype=np.float32)
    w[0] = ((a * (f + one) - np.float32(5) * a) * (f + one)
            + np.float32(8) * a) * (f + one) - np.float32(4) * a
    w[1] = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    w[2] = ((a + np.float32(2)) * (one - f) - (a + np.float32(3))) * (
        one - f) * (one - f) + one
    w[3] = one - w[0] - w[1] - w[2]
    return w


def cv_resize_fixedpoint(img: np.ndarray, dst_w: int, dst_h: int,
                         bicubic: bool) -> np.ndarray:
    """Bit-exact model of OpenCV's uint8 resize (the fixed-point path the
    reference's compare_resize_opencv ground truth actually runs,
    fhe_resize.h:52-56): short coefficients at 2^11 scale, int32 horizontal
    pass, vertical pass rounded with (+2^21) >> 22, border-replicate."""
    assert img.dtype == np.uint8
    src_h, src_w = img.shape[:2]
    ksize = 4 if bicubic else 2
    ksize2 = ksize // 2
    xofs, ialpha = _fixpt_maps(src_w, dst_w, ksize)
    yofs, ibeta = _fixpt_maps(src_h, dst_h, ksize)
    s64 = img.astype(np.int64)  # [H, W, C]
    # horizontal pass for every source row: [H, dst_w, C]
    hrows = np.zeros((src_h, dst_w) + img.shape[2:], dtype=np.int64)
    for j in range(ksize):
        xs = np.clip(xofs - (ksize2 - 1) + j, 0, src_w - 1)
        hrows += s64[:, xs] * ialpha[:, j].reshape(1, -1, *([1] * (img.ndim - 2)))
    # vertical pass
    out = np.zeros((dst_h, dst_w) + img.shape[2:], dtype=np.int64)
    for j in range(ksize):
        ys = np.clip(yofs - (ksize2 - 1) + j, 0, src_h - 1)
        out += hrows[ys] * ibeta[:, j].reshape(-1, 1, *([1] * (img.ndim - 2)))
    out = (out + (1 << (2 * INTER_RESIZE_COEF_BITS - 1))) >> (
        2 * INTER_RESIZE_COEF_BITS
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def cv_ground_truth(img: np.ndarray, dst_w: int, dst_h: int,
                    bicubic: bool) -> np.ndarray:
    """The RMS ground truth: real cv2.resize when OpenCV is importable
    (exactly the reference's compare_resize_opencv), else the bit-exact
    fixed-point model above (differs by at most +-1 on a few pixels)."""
    try:
        import cv2

        flag = cv2.INTER_CUBIC if bicubic else cv2.INTER_LINEAR
        return cv2.resize(np.ascontiguousarray(img), (dst_w, dst_h),
                          interpolation=flag)
    except ImportError:
        return cv_resize_fixedpoint(img, dst_w, dst_h, bicubic)


def cv_resize(img: np.ndarray, dst_w: int, dst_h: int, bicubic: bool) -> np.ndarray:
    src_h, src_w = img.shape[:2]
    sx = src_w / dst_w
    sy = src_h / dst_h
    out = np.zeros((dst_h, dst_w) + img.shape[2:], dtype=np.float64)
    imgf = img.astype(np.float64)
    for y in range(dst_h):
        fy = (y + 0.5) * sy - 0.5
        iy = int(np.floor(fy))
        ry = fy - iy
        for x in range(dst_w):
            fx = (x + 0.5) * sx - 0.5
            ix = int(np.floor(fx))
            rx = fx - ix
            if bicubic:
                wy = _cubic_weights(ry)
                wx = _cubic_weights(rx)
                acc = 0.0
                for j in range(4):
                    yy = min(max(iy - 1 + j, 0), src_h - 1)
                    row = 0.0
                    for i in range(4):
                        xx = min(max(ix - 1 + i, 0), src_w - 1)
                        row += wx[i] * imgf[yy, xx]
                    acc += wy[j] * row
                out[y, x] = acc
            else:
                y0 = min(max(iy, 0), src_h - 1)
                y1 = min(max(iy + 1, 0), src_h - 1)
                x0 = min(max(ix, 0), src_w - 1)
                x1 = min(max(ix + 1, 0), src_w - 1)
                ry_c = min(max(ry, 0.0), 1.0)
                rx_c = min(max(rx, 0.0), 1.0)
                top = (1 - rx_c) * imgf[y0, x0] + rx_c * imgf[y0, x1]
                bot = (1 - rx_c) * imgf[y1, x0] + rx_c * imgf[y1, x1]
                out[y, x] = (1 - ry_c) * top + ry_c * bot
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
