"""Homomorphic JPEG encode pipeline: the server op, port of
``fhetpu/pipelines/jpeg_encode.py``.

A batch of blocks is one ciphertext tensor ``[nb, 3, 64, 2, L, n]``
(block, RGB channel, coefficient slot, ciphertext component, limb, ring
coefficient).  The network functions are op-for-op the reference's (same
constants, same order), and they are duck-typed over the evaluator, so they
run unchanged against ``bfv.golden.GoldenEvaluator`` as the exact
plaintext oracle:
 * rgb_to_ycc:   fhe_image.h:307-325
 * dct8x8:       fhe_image.h:192-288 (AAN network, row pass then col pass,
                 /8 scaling via multiply_plain(0.125))
 * quantize:     fhe_image.h:290-305 (defined-but-never-called in the
                 reference; behind a flag, default off to match)
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..bfv.evaluator import Ct, Evaluator
from ..core import modops
from ..core.dct_kernel import dct8x8_kernel
from ..core.server_kernel import server_ycc_dct_fused

# AAN rotation constants, exactly as multiplied in the reference network
_C0541 = 0.541196100
_C0765 = 0.765366865
_CN1847 = -1.847759065
_C1175 = 1.175875602
_C0298 = 0.298631336
_C2053 = 2.053119869
_C3072 = 3.072711026
_C1501 = 1.501321110
_CN0899 = -0.899976223
_CN2562 = -2.562915447
_CN1961 = -1.961570560
_CN0390 = -0.390180644


def rgb_to_ycc(ev: Evaluator, r: Ct, g: Ct, b: Ct):
    """Color transform on batched pixel ciphertexts (NTT form).

    y  =  .299 r + .587 g + .114 b - 128
    cb = -.168736 r - .331264 g + .5 b
    cr =  .5 r - .418688 g - .081312 b
    """
    y = ev.lincomb([(r, ev.encode(0.299)), (g, ev.encode(0.587)), (b, ev.encode(0.114))])
    y = ev.sub_plain(y, ev.encode(128.0))
    cb = ev.sub(
        ev.multiply_plain(r, ev.encode(-0.168736)),
        ev.multiply_plain(g, ev.encode(0.331264)),
    )
    cb = ev.add(cb, ev.multiply_plain(b, ev.encode(0.5)))
    cr = ev.sub(
        ev.multiply_plain(r, ev.encode(0.5)), ev.multiply_plain(g, ev.encode(0.418688))
    )
    cr = ev.sub(cr, ev.multiply_plain(b, ev.encode(0.081312)))
    return y, cb, cr


def _dct_pass(ev: Evaluator, s: List[Ct], idx: Sequence[int], scale_eighth: bool):
    """One 8-point AAN pass over slots s[idx[0..7]], in place."""
    e = ev.encode
    a = [s[i] for i in idx]
    tmp0 = ev.add(a[0], a[7])
    tmp7 = ev.sub(a[0], a[7])
    tmp1 = ev.add(a[1], a[6])
    tmp6 = ev.sub(a[1], a[6])
    tmp2 = ev.add(a[2], a[5])
    tmp5 = ev.sub(a[2], a[5])
    tmp3 = ev.add(a[3], a[4])
    tmp4 = ev.sub(a[3], a[4])
    tmp10 = ev.add(tmp0, tmp3)
    tmp13 = ev.sub(tmp0, tmp3)
    tmp11 = ev.add(tmp1, tmp2)
    tmp12 = ev.sub(tmp1, tmp2)
    out0 = ev.add(tmp10, tmp11)
    out4 = ev.sub(tmp10, tmp11)
    z1 = ev.multiply_plain(ev.add(tmp12, tmp13), e(_C0541))
    out2 = ev.add(z1, ev.multiply_plain(tmp13, e(_C0765)))
    out6 = ev.add(z1, ev.multiply_plain(tmp12, e(_CN1847)))
    z1 = ev.add(tmp4, tmp7)
    z2 = ev.add(tmp5, tmp6)
    z3 = ev.add(tmp4, tmp6)
    z4 = ev.add(tmp5, tmp7)
    z5 = ev.multiply_plain(ev.add(z3, z4), e(_C1175))
    tmp4 = ev.multiply_plain(tmp4, e(_C0298))
    tmp5 = ev.multiply_plain(tmp5, e(_C2053))
    tmp6 = ev.multiply_plain(tmp6, e(_C3072))
    tmp7 = ev.multiply_plain(tmp7, e(_C1501))
    z1 = ev.multiply_plain(z1, e(_CN0899))
    z2 = ev.multiply_plain(z2, e(_CN2562))
    z3 = ev.multiply_plain(z3, e(_CN1961))
    z4 = ev.multiply_plain(z4, e(_CN0390))
    z3 = ev.add(z3, z5)
    z4 = ev.add(z4, z5)
    out7 = ev.add(ev.add(tmp4, z1), z3)
    out5 = ev.add(ev.add(tmp5, z2), z4)
    out3 = ev.add(ev.add(tmp6, z2), z3)
    out1 = ev.add(ev.add(tmp7, z1), z4)
    outs = [out0, out1, out2, out3, out4, out5, out6, out7]
    if scale_eighth:
        eighth = e(0.125)
        outs = [ev.multiply_plain(o, eighth) for o in outs]
    for i, o in zip(idx, outs):
        s[i] = o


def dct8x8(ev: Evaluator, slots: List[Ct]) -> List[Ct]:
    """Forward 2-D DCT over 64 coefficient-slot ciphertext batches.

    Row pass (no scaling) then column pass (x 0.125), exactly the reference
    network fhe_image.h:206-284.  Each slot is a Ct batched over blocks.
    """
    s = list(slots)
    for c in range(8):
        _dct_pass(ev, s, range(8 * c, 8 * c + 8), scale_eighth=False)
    for c in range(8):
        _dct_pass(ev, s, range(c, 64, 8), scale_eighth=True)
    return s


def quantize(ev: Evaluator, slots: List[Ct], quant: np.ndarray) -> List[Ct]:
    """multiply_plain(1/quant[i]) per slot (fhe_image.h:290-305)."""
    return [
        ev.multiply_plain(ct, ev.encode(1.0 / float(quant[i])))
        for i, ct in enumerate(slots)
    ]


def server_compute_fn(
    ev: Evaluator,
    apply_quantize: bool = False,
    quant: Optional[np.ndarray] = None,
    input_ntt: bool = False,
    output_ntt: bool = False,
    fused_lazy: bool = False,
):
    """The server op: uint32 [nb, 3, 64, 2, L, n] -> same shape, on the
    tensor's device.

    input_ntt/output_ntt say whether the stream is in the NTT evaluation
    domain (``ntt`` in the stream meta) or in coefficient form (the
    client's default).

    Three paths (a CUDA tensor runs the hand-written kernels, a CPU tensor
    their plain versions):

    * quantize off, the default (the reference's): the forward NTT
      kernel, the strict fused YCC+DCT kernel and the inverse NTT kernel;
    * quantize off with fused_lazy: the lazy-reduction fused kernel in
      place of the strict one (same output bits; ValueError where the
      primes leave it no headroom, as in fhetpu);
    * quantize on: the YCC transform on the evaluator's torch ops, the
      DCT-only kernel, then the per-slot quantize products on the
      evaluator.
    """
    ev.server_state()  # build the kernels' tables now, not in the first call

    def fn(cts: torch.Tensor) -> torch.Tensor:
        d = ev.transform_to_ntt(Ct(cts, input_ntt)).data  # [nb, 3, 64, 2, L, n]
        if not apply_quantize:
            out = server_ycc_dct_fused(ev, d, lazy=fused_lazy)
            return out if output_ntt else ev.transform_from_ntt(Ct(out, True)).data
        y, cb, cr = rgb_to_ycc(ev, Ct(d[:, 0], True), Ct(d[:, 1], True), Ct(d[:, 2], True))
        ycc = torch.stack([modops.to_u32(c.data) for c in (y, cb, cr)], dim=1)
        dct = dct8x8_kernel(ev, ycc)  # [nb, 3, 64, 2, L, n]
        slots = quantize(ev, [Ct(dct[:, :, k], True) for k in range(64)], quant)
        out = torch.stack([modops.to_u32(s.data) for s in slots], dim=2)
        return out if output_ntt else ev.transform_from_ntt(Ct(out, True)).data

    return fn


def make_server(ev: Evaluator, apply_quantize: bool = False,
                quant: Optional[np.ndarray] = None):
    """The end-to-end server op for coefficient-form streams:
    ``server_compute_fn(ev, apply_quantize, quant)``.

    The kernel follows the tensor's device: on a CUDA tensor the NTT
    kernels around the fused YCC+DCT kernel (the DCT-only kernel with
    quantize on), on a CPU tensor their plain versions.  fhetpu's
    ``use_pallas``/``use_fused`` switches and its input donation are
    choices of XLA's graph and buffers, so they have no counterpart here."""
    return server_compute_fn(ev, apply_quantize, quant)
