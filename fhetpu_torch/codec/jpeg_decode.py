"""Baseline JPEG decoder with libjpeg-turbo's integer arithmetic, so that
the JPEG client's RMS is computed on a host without PIL.

The JPEG client (``cli/client_jpeg.run_recieve``) prints the RMS between two
JFIF files that it decodes with this module: its own output and the jo_jpeg
baseline.  fhetpu's client decodes the same files with PIL.  Both are
baseline, 8-bit, three components at 1x1 sampling, with the standard
Huffman tables (``codec/jpeg.py``).  This module decodes exactly that kind of file the way PIL's libjpeg-turbo does
by default: Huffman decoding, dequantization, the accurate integer inverse
DCT (``jidctint.c``, ``JDCT_ISLOW``) and the fixed-point YCbCr->RGB
conversion (``jdcolor.c``).  The IDCT follows libjpeg-turbo's SIMD code,
which PIL runs on x86-64: a 16-bit workspace, saturating packs and a few
sums formed in 16-bit words.  The C code's range-limit table gives the same
pixels wherever the IDCT stays in range, which a working pipeline's
coefficients do; they differ on garbage coefficients (a plain modulus too
small for the image).  The tests hold the decoder equal to PIL, the reference
decoder, on both files and on garbage blocks up to the largest codes the
Huffman tables take.
"""

from __future__ import annotations

import numpy as np

from .jpeg import ZIGZAG

_CONST_BITS, _PASS1_BITS = 13, 2
_F0_298, _F0_390, _F0_541, _F0_765 = 2446, 3196, 4433, 6270
_F0_899, _F1_175, _F1_501, _F1_847 = 7373, 9633, 12299, 15137
_F1_961, _F2_053, _F2_562, _F3_072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _wrap16(x):
    """x as the 16-bit word a SIMD add leaves (two's complement wrap)."""
    return (x + 32768) % 65536 - 32768


def _idct_1d(s, shift):
    """One islow pass over axis 0 of s (8 x ...), int64, descaled by shift.
    The sums that libjpeg-turbo's SIMD code forms in 16-bit words (s0 +- s4
    and the odd part's z3, z4) wrap as they do there; every product and the
    rest of the arithmetic are 32-bit and exact, as in jidctint.c."""
    tmp2 = s[2] * _F0_541 + s[6] * (_F0_541 - _F1_847)
    tmp3 = s[2] * (_F0_541 + _F0_765) + s[6] * _F0_541
    tmp0 = _wrap16(s[0] + s[4]) << _CONST_BITS
    tmp1 = _wrap16(s[0] - s[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = s[7], s[5], s[3], s[1]
    z1, z2 = o0 + o3, o1 + o2
    z3, z4 = _wrap16(o0 + o2), _wrap16(o1 + o3)
    z5 = (z3 + z4) * _F1_175
    o0, o1, o2, o3 = o0 * _F0_298, o1 * _F2_053, o2 * _F3_072, o3 * _F1_501
    z1, z2 = z1 * -_F0_899, z2 * -_F2_562
    z3, z4 = z3 * -_F1_961 + z5, z4 * -_F0_390 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return np.stack([_descale(v, shift) for v in (
        tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
        tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3)])


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized natural-order blocks int [..., 8, 8] -> samples [..., 8, 8]
    in [0, 255], as libjpeg-turbo's SIMD jpeg_idct_islow: the workspace
    between the passes saturates to 16 bits, the output to [-128, 127]."""
    c = np.moveaxis(_wrap16(coef.astype(np.int64)), (-2, -1), (0, 1))  # [row u, col v, ...]
    ws = np.clip(_idct_1d(c, _CONST_BITS - _PASS1_BITS), -32768, 32767)  # columns
    out = _idct_1d(np.swapaxes(ws, 0, 1), _CONST_BITS + _PASS1_BITS + 3)  # rows
    return np.moveaxis(np.clip(np.swapaxes(out, 0, 1), -128, 127) + 128, (0, 1), (-2, -1))


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, SCALEBITS 16)."""
    def fix(x):
        return int(x * 65536 + 0.5)

    cb, cr = cb.astype(np.int64) - 128, cr.astype(np.int64) - 128
    y = y.astype(np.int64)
    r = y + ((fix(1.40200) * cr + (1 << 15)) >> 16)
    g = y + ((-fix(0.34414) * cb + (1 << 15) - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + (1 << 15)) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class _Bits:
    """MSB-first reader of entropy-coded bytes, 0xFF00 stuffing removed."""

    def __init__(self, data: bytes, pos: int):
        out = bytearray()
        while pos < len(data):
            b = data[pos]
            if b == 0xFF:
                if pos + 1 < len(data) and data[pos + 1] == 0:
                    out.append(0xFF)
                    pos += 2
                    continue
                break  # a marker ends the scan
            out.append(b)
            pos += 1
        self.bits = "".join(f"{b:08b}" for b in out)
        self.pos = 0

    def receive(self, s: int) -> int:
        if not s:
            return 0
        v = int(self.bits[self.pos:self.pos + s], 2)
        self.pos += s
        return v

    def huffman(self, table: dict) -> int:
        code = ""
        while len(code) < 16:
            code += self.bits[self.pos]
            self.pos += 1
            if code in table:
                return table[code]
        raise ValueError("bad Huffman code")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _huffman_table(counts, values) -> dict:
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[format(code, f"0{length}b")] = values[k]
            code += 1
            k += 1
        code <<= 1
    return table


def decode_baseline(data: bytes) -> np.ndarray:
    """RGB uint8 [H, W, 3] of a baseline JFIF with three components at 1x1
    sampling and dimensions that are multiples of 8."""
    quant, dc_tabs, ac_tabs, comps = {}, {}, {}, []
    pos = 2
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream")
    while True:
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:
            for i in range(0, len(seg), 65):
                quant[seg[i] & 15] = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
        elif marker == 0xC0:
            h, w, nc = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big"), seg[5]
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c], seg[8 + 3 * c]) for c in range(nc)]
            if seg[0] != 8 or nc != 3 or any(s != 0x11 for _, s, _ in comps) or h % 8 or w % 8:
                raise ValueError("only 8-bit 3-component 1x1 baseline images of "
                                 "8-divisible size are supported")
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                counts = list(seg[i + 1:i + 17])
                vals = list(seg[i + 17:i + 17 + sum(counts)])
                (dc_tabs if seg[i] >> 4 == 0 else ac_tabs)[seg[i] & 15] = \
                    _huffman_table(counts, vals)
                i += 17 + sum(counts)
        elif marker == 0xDA:
            sel = {seg[1 + 2 * c]: seg[2 + 2 * c] for c in range(seg[0])}
            break
        elif marker in (0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
                        0xCE, 0xCF):
            raise ValueError("only baseline JPEG is supported")
    bits = _Bits(data, pos)
    nb = (h // 8) * (w // 8)
    blocks = np.zeros((3, nb, 64), dtype=np.int64)  # zigzag order
    pred = [0, 0, 0]
    for b in range(nb):
        for c, (cid, _, _) in enumerate(comps):
            dc, ac = dc_tabs[sel[cid] >> 4], ac_tabs[sel[cid] & 15]
            s = bits.huffman(dc)
            pred[c] += _extend(bits.receive(s), s)
            blocks[c, b, 0] = pred[c]
            k = 1
            while k < 64:
                rs = bits.huffman(ac)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blocks[c, b, k] = _extend(bits.receive(s), s)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
    planes = []
    for c, (_, _, tq) in enumerate(comps):
        natural = (blocks[c] * quant[tq])[:, ZIGZAG].reshape(h // 8, w // 8, 8, 8)
        planes.append(idct_islow(natural).transpose(0, 2, 1, 3).reshape(h, w))
    return ycc_to_rgb(*planes)
