"""Host-side baseline JPEG codec: tables, Huffman entropy coder, JFIF writer,
and a jo_jpeg-equivalent plaintext encoder used as the RMS oracle.

The port's own copy of the part of ``fhetpu/codec/jpeg.py`` that the JPEG
client and server use (``ZIGZAG``, ``build_quant_tables``,
``encode_coeff_blocks``, ``jo_jpeg_encode`` and what they call); tests
hold the bytes it writes equal to the original's.  The jpge-equivalent
configurable encoder is not carried over: nothing in the port calls it.

TPU-native counterpart of SURVEY.md C6 (fhe_image.h:331-397 entropy coding +
constant tables) and C21 (vendored jo_jpeg, the reference's RMS ground truth
at fhe_image.h:508-521).  Semantics faithfully mirrored:

* Huffman code tables are *derived* from the JPEG Annex-K standard
  nrcodes/values lists (identical results to the reference's pre-expanded
  YDC_HT/UVDC_HT/YAC_HT/UVAC_HT literals).
* quality semantics: the pipeline's quant tables use the reference client's
  mapping ``(QT*quality+50)/100`` clamped to [1,255] -- QUALITY=0 therefore
  yields ALL-ONES tables (client_jpeg.cpp:221-227), i.e. the encrypted
  pipeline emits effectively-unquantized coefficients.
* the RMS baseline encoder mirrors jo_write_jpg, where quality=0 promotes
  to 90 and <50 maps to 5000/q (include/jo_jpeg.h:251-253) -- so the
  reference's RMSError 1.71767 is "all-ones-quant FHE JPEG vs quality-90
  jo JPEG", which this module reproduces.
"""

from __future__ import annotations

import io
import struct

import numpy as np

# zigzag scan order (JPEG standard, reference fhe_image.h:34)
ZIGZAG = np.array(
    [0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
     3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
     10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
     21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63],
    dtype=np.int32,
)

# JPEG Annex K.3 standard Huffman specifications (nrcodes[1..16], values)
STD_DC_LUM_NRCODES = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
STD_DC_LUM_VALUES = list(range(12))
STD_AC_LUM_NRCODES = [0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
STD_AC_LUM_VALUES = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
STD_DC_CHR_NRCODES = [0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
STD_DC_CHR_VALUES = list(range(12))
STD_AC_CHR_NRCODES = [0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
STD_AC_CHR_VALUES = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]

# base quantization matrices (JPEG Annex K.1, reference fhe_image.h:99-100)
YQT = np.array(
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    dtype=np.int32,
)
UVQT = np.array(
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    dtype=np.int32,
)
# AAN scale factors x 2*sqrt(2) (reference fhe_image.h:101)
AASF = np.array(
    [1.0, 1.387039845, 1.306562965, 1.175875602,
     1.0, 0.785694958, 0.541196100, 0.275899379],
    dtype=np.float32,
) * np.float32(2.828427125)


def derive_huffman_table(nrcodes, values):
    """Canonical JPEG Huffman code assignment: dict symbol -> (code, length)."""
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(nrcodes[length]):
            table[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


YDC_HT = derive_huffman_table(STD_DC_LUM_NRCODES, STD_DC_LUM_VALUES)
YAC_HT = derive_huffman_table(STD_AC_LUM_NRCODES, STD_AC_LUM_VALUES)
UVDC_HT = derive_huffman_table(STD_DC_CHR_NRCODES, STD_DC_CHR_VALUES)
UVAC_HT = derive_huffman_table(STD_AC_CHR_NRCODES, STD_AC_CHR_VALUES)


def build_quant_tables(quality: int):
    """Client-side quant tables, reference mapping client_jpeg.cpp:221-227
    (NOT jo's: quality is used raw, so 0 -> all ones)."""
    yt = np.clip((YQT * quality + 50) // 100, 1, 255).astype(np.uint8)
    uvt = np.clip((UVQT * quality + 50) // 100, 1, 255).astype(np.uint8)
    # stored in zigzag positions
    ytab = np.zeros(64, dtype=np.uint8)
    uvtab = np.zeros(64, dtype=np.uint8)
    ytab[ZIGZAG] = yt
    uvtab[ZIGZAG] = uvt
    return ytab, uvtab


class BitWriter:
    """JPEG bitstream writer with 0xFF byte stuffing (fhe_image.h:331-343)."""

    def __init__(self, fp):
        self.fp = fp
        self.buf = 0
        self.cnt = 0

    def write(self, code: int, length: int):
        self.cnt += length
        self.buf |= code << (24 - self.cnt)
        while self.cnt >= 8:
            c = (self.buf >> 16) & 255
            self.fp.write(bytes([c]))
            if c == 255:
                self.fp.write(b"\x00")
            self.buf = (self.buf << 8) & 0xFFFFFFFF
            self.cnt -= 8


def calc_bits(val: int):
    """JPEG magnitude coding: (code, length) for a nonzero value."""
    tmp = -val if val < 0 else val
    v = val - 1 if val < 0 else val
    length = 1
    while tmp >> 1:
        tmp >>= 1
        length += 1
    return v & ((1 << length) - 1), length


def process_block(bw: BitWriter, du, dc_prev: int, htdc, htac) -> int:
    """Entropy-encode one zigzagged 64-coefficient block (fhe_image.h:355-397).
    Returns the new DC predictor."""
    eob = htac[0x00]
    m16 = htac[0xF0]
    diff = int(du[0]) - dc_prev
    if diff == 0:
        bw.write(*htdc[0])
    else:
        code, length = calc_bits(diff)
        bw.write(*htdc[length])
        bw.write(code, length)
    end0 = 63
    while end0 > 0 and du[end0] == 0:
        end0 -= 1
    if end0 == 0:
        bw.write(*eob)
        return int(du[0])
    i = 1
    while i <= end0:
        start = i
        while i <= end0 and du[i] == 0:
            i += 1
        nz = i - start
        if nz >= 16:
            for _ in range(nz >> 4):
                bw.write(*m16)
            nz &= 15
        code, length = calc_bits(int(du[i]))
        bw.write(*htac[(nz << 4) + length])
        bw.write(code, length)
        i += 1
    if end0 != 63:
        bw.write(*eob)
    return int(du[0])


def write_headers(fp, width: int, height: int, ytab, uvtab):
    """JFIF/DQT/SOF0/DHT/SOS headers, byte-for-byte the reference layout
    (client_jpeg.cpp:239-258): no chroma subsampling (1x1)."""
    head0 = bytes(
        [0xFF, 0xD8, 0xFF, 0xE0, 0, 0x10, ord("J"), ord("F"), ord("I"),
         ord("F"), 0, 1, 1, 0, 0, 1, 0, 1, 0, 0, 0xFF, 0xDB, 0, 0x84, 0]
    )
    fp.write(head0)
    fp.write(bytes(ytab.tolist()))
    fp.write(bytes([1]))
    fp.write(bytes(uvtab.tolist()))
    head1 = bytes(
        [0xFF, 0xC0, 0, 0x11, 8, (height >> 8) & 0xFF, height & 0xFF,
         (width >> 8) & 0xFF, width & 0xFF, 3, 1, 0x11, 0, 2, 0x11, 1,
         3, 0x11, 1, 0xFF, 0xC4, 0x01, 0xA2, 0]
    )
    fp.write(head1)
    fp.write(bytes(STD_DC_LUM_NRCODES[1:]))
    fp.write(bytes(STD_DC_LUM_VALUES))
    fp.write(bytes([0x10]))
    fp.write(bytes(STD_AC_LUM_NRCODES[1:]))
    fp.write(bytes(STD_AC_LUM_VALUES))
    fp.write(bytes([1]))
    fp.write(bytes(STD_DC_CHR_NRCODES[1:]))
    fp.write(bytes(STD_DC_CHR_VALUES))
    fp.write(bytes([0x11]))
    fp.write(bytes(STD_AC_CHR_NRCODES[1:]))
    fp.write(bytes(STD_AC_CHR_VALUES))
    head2 = bytes([0xFF, 0xDA, 0, 0xC, 3, 1, 0, 2, 0x11, 3, 0x11, 0, 0x3F, 0])
    fp.write(head2)


def write_trailer(bw: BitWriter):
    bw.write(0x7F, 7)  # fill bits
    bw.fp.write(bytes([0xFF, 0xD9]))


def encode_coeff_blocks(
    fp, blocks_ycc: np.ndarray, width: int, height: int, quality: int = 0
):
    """Serialize rounded DCT coefficient blocks [nblocks, 3, 64] (natural
    row-major order, like the decrypted server output) to a JFIF stream.
    Coefficients are inverse-zigzag'd here (client_jpeg.cpp:266-283)."""
    ytab, uvtab = build_quant_tables(quality)
    write_headers(fp, width, height, ytab, uvtab)
    bw = BitWriter(fp)
    dcy = dcu = dcv = 0
    nblocks = blocks_ycc.shape[0]
    zz = np.zeros(64, dtype=np.int64)
    for b in range(nblocks):
        for k, (htdc, htac) in enumerate(
            ((YDC_HT, YAC_HT), (UVDC_HT, UVAC_HT), (UVDC_HT, UVAC_HT))
        ):
            zz[ZIGZAG] = blocks_ycc[b, k]
            if k == 0:
                dcy = process_block(bw, zz, dcy, htdc, htac)
            elif k == 1:
                dcu = process_block(bw, zz, dcu, htdc, htac)
            else:
                dcv = process_block(bw, zz, dcv, htdc, htac)
    write_trailer(bw)


# ---------------------------------------------------------------------------
# jo_jpeg-equivalent plaintext encoder: the RMS oracle (float32 math to
# match the C++ baseline bit-for-bit).
# ---------------------------------------------------------------------------


def _jo_dct8(d: np.ndarray) -> np.ndarray:
    """jo_DCT on one length-8 float32 vector (include/jo_jpeg.h AAN net)."""
    f = np.float32
    d0, d1, d2, d3, d4, d5, d6, d7 = (f(x) for x in d)
    tmp0 = d0 + d7
    tmp7 = d0 - d7
    tmp1 = d1 + d6
    tmp6 = d1 - d6
    tmp2 = d2 + d5
    tmp5 = d2 - d5
    tmp3 = d3 + d4
    tmp4 = d3 - d4
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2
    o0 = tmp10 + tmp11
    o4 = tmp10 - tmp11
    z1 = (tmp12 + tmp13) * f(0.707106781)
    o2 = tmp13 + z1
    o6 = tmp13 - z1
    tmp10 = tmp4 + tmp5
    tmp11 = tmp5 + tmp6
    tmp12 = tmp6 + tmp7
    z5 = (tmp10 - tmp12) * f(0.382683433)
    z2 = tmp10 * f(0.541196100) + z5
    z4 = tmp12 * f(1.306562965) + z5
    z3 = tmp11 * f(0.707106781)
    z11 = tmp7 + z3
    z13 = tmp7 - z3
    o5 = z13 + z2
    o3 = z13 - z2
    o1 = z11 + z4
    o7 = z11 - z4
    return np.array([o0, o1, o2, o3, o4, o5, o6, o7], dtype=np.float32)


def jo_quality_scale(quality: int) -> int:
    quality = quality if quality else 90
    quality = min(max(quality, 1), 100)
    return 5000 // quality if quality < 50 else 200 - quality * 2


def jo_jpeg_encode(rgb: np.ndarray, quality: int = 0) -> bytes:
    """Reimplementation of jo_write_jpg(comp=3) -- the reference's plaintext
    ground-truth encoder (include/jo_jpeg.h:173-340)."""
    height, width, _ = rgb.shape
    scale = jo_quality_scale(quality)
    yt = np.clip((YQT * scale + 50) // 100, 1, 255).astype(np.uint8)
    uvt = np.clip((UVQT * scale + 50) // 100, 1, 255).astype(np.uint8)
    ytab = np.zeros(64, dtype=np.uint8)
    uvtab = np.zeros(64, dtype=np.uint8)
    ytab[ZIGZAG] = yt
    uvtab[ZIGZAG] = uvt
    f = np.float32
    fdy = np.zeros(64, dtype=np.float32)
    fduv = np.zeros(64, dtype=np.float32)
    for row in range(8):
        for col in range(8):
            k = row * 8 + col
            fdy[k] = f(1.0) / (f(ytab[ZIGZAG[k]]) * AASF[row] * AASF[col])
            fduv[k] = f(1.0) / (f(uvtab[ZIGZAG[k]]) * AASF[row] * AASF[col])
    out = io.BytesIO()
    write_headers(out, width, height, ytab, uvtab)
    bw = BitWriter(out)
    dcy = dcu = dcv = 0
    rgbf = rgb.astype(np.float32)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    ych = (f(0.29900) * r + f(0.58700) * g + f(0.11400) * b) - f(128.0)
    uch = f(-0.16874) * r - f(0.33126) * g + f(0.50000) * b
    vch = f(0.50000) * r - f(0.41869) * g - f(0.08131) * b
    for y0 in range(0, height, 8):
        for x0 in range(0, width, 8):
            for chan, fdtbl, which in ((ych, fdy, 0), (uch, fduv, 1), (vch, fduv, 2)):
                du = chan[y0 : y0 + 8, x0 : x0 + 8].astype(np.float32).copy()
                for rr in range(8):
                    du[rr] = _jo_dct8(du[rr])
                for cc in range(8):
                    du[:, cc] = _jo_dct8(du[:, cc])
                # jo applies fdtbl in natural order then zigzags with rounding
                vals = du.reshape(64) * fdtbl
                zz = np.zeros(64, dtype=np.int64)
                for j in range(64):
                    v = float(vals[j])
                    zz[ZIGZAG[j]] = int(np.floor(v + 0.5)) if v > 0 else int(np.ceil(v - 0.5))
                if which == 0:
                    dcy = process_block(bw, zz, dcy, YDC_HT, YAC_HT)
                elif which == 1:
                    dcu = process_block(bw, zz, dcu, UVDC_HT, UVAC_HT)
                else:
                    dcv = process_block(bw, zz, dcv, UVDC_HT, UVAC_HT)
    write_trailer(bw)
    return out.getvalue()
