"""Fast YCC + 8x8 DCT server op (lazy reduction + folded constants): port of
``fhetpu/pipelines/jpeg_fast.py`` as torch int64 ops.

It gives the ciphertexts of the reference-order network in ``jpeg_encode``
bit for bit: both optimizations are exact ring identities on
Z_q[x]/(x^n+1):

* **Lazy reduction** (``core/lazy.py``): residues ride in [0, m*p) with m
  tracked statically; reductions are emitted only where a uint32 bound
  would overflow, at the points where fhetpu's are.
* **Constant folding**: the reference's column pass multiplies every output
  by encode(0.125) after the rotations.  Since (x * E(c)) * E(1/8) =
  x * (E(c)*E(1/8)) exactly in the ring, the /8 scaling folds into
  composite plaintext operands (pointwise NTT-domain products, made on the
  host), removing 6 of 21 column-pass multiplies.  Same bits, same noise.

``jpeg_encode.server_compute_fn(use_fast=True)`` selects it; it covers the
``--quantize`` multiplies too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bfv.evaluator import Evaluator
from ..core import modops
from ..core.lazy import Lazy, LazyOps
from ..core.server_kernel import CONST_ORDER

# the 12 AAN rotation constants in the order _aan_pass_lazy takes them, and
# the column pass's 1/8 (reference fhe_image.h:206-284)
ROT, EIGHTH = CONST_ORDER[:12], CONST_ORDER[12]


class _CompositeOperand:
    """Pointwise NTT-domain product of encoded constants: the prepared
    operand for multiply_plain by E(v1)*E(v2)*... (exact ring product).
    Host arrays uint32 [L, n]; ``on(device)`` uploads them once as int64."""

    def __init__(self, ev: Evaluator, values):
        p64 = ev.params.consts.qp.astype(np.uint64)  # [L, 1]
        acc = None
        for v in values:
            m = ev.encode(float(v)).mul_ntt.astype(np.uint64)
            acc = m if acc is None else (acc * m) % p64
        self.mul_ntt = acc.astype(np.uint32)
        self.mul_ntt_shoup = modops.shoup(self.mul_ntt, p64)
        self._on: dict = {}

    def on(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                                     for a in (self.mul_ntt, self.mul_ntt_shoup))
        return self._on[device]


def _operand(ev: Evaluator, *values):
    """(w, w_shoup) int64 [L, n] on the evaluator's device of the cached
    composite operand, or of the plain one for a single value."""
    if len(values) == 1:
        dev = ev.encode(float(values[0])).on(ev.device)
        return dev.mul_ntt, dev.mul_ntt_shoup
    key = ("composite",) + tuple(float(v) for v in values)
    if key not in ev._plain_cache:
        ev._plain_cache[key] = _CompositeOperand(ev, values)
    return ev._plain_cache[key].on(ev.device)


def _aan_pass_lazy(lz: LazyOps, a, C, scale):
    """One 8-point AAN pass over 8 Lazy slots.

    C: 12 prepared rotation operands (composited with 1/8 for the column
    pass); scale: the E(1/8) operand applied to the two add-only outputs
    (out0/out4), or None for the row pass."""

    def mul(x, op):
        return lz.mul_shoup(x, *op)

    t0 = lz.add(a[0], a[7])
    t7 = lz.sub(a[0], a[7])
    t1 = lz.add(a[1], a[6])
    t6 = lz.sub(a[1], a[6])
    t2 = lz.add(a[2], a[5])
    t5 = lz.sub(a[2], a[5])
    t3 = lz.add(a[3], a[4])
    t4 = lz.sub(a[3], a[4])
    tmp10 = lz.add(t0, t3)
    tmp13 = lz.sub(t0, t3)
    tmp11 = lz.add(t1, t2)
    tmp12 = lz.sub(t1, t2)
    out0 = lz.add(tmp10, tmp11)
    out4 = lz.sub(tmp10, tmp11)
    if scale is not None:
        out0 = mul(out0, scale)
        out4 = mul(out4, scale)
    z1 = mul(lz.add(tmp12, tmp13), C[0])
    out2 = lz.add(z1, mul(tmp13, C[1]))
    out6 = lz.add(z1, mul(tmp12, C[2]))
    z1b = lz.add(t4, t7)
    z2b = lz.add(t5, t6)
    z3b = lz.add(t4, t6)
    z4b = lz.add(t5, t7)
    z5 = mul(lz.add(z3b, z4b), C[3])
    t4m = mul(t4, C[4])
    t5m = mul(t5, C[5])
    t6m = mul(t6, C[6])
    t7m = mul(t7, C[7])
    z1m = mul(z1b, C[8])
    z2m = mul(z2b, C[9])
    z3m = mul(z3b, C[10])
    z4m = mul(z4b, C[11])
    z3f = lz.add(z3m, z5)
    z4f = lz.add(z4m, z5)
    out7 = lz.add(lz.add(t4m, z1m), z3f)
    out5 = lz.add(lz.add(t5m, z2m), z4f)
    out3 = lz.add(lz.add(t6m, z2m), z3f)
    out1 = lz.add(lz.add(t7m, z1m), z4f)
    return [out0, out1, out2, out3, out4, out5, out6, out7]


def server_ycc_dct_fast(ev: Evaluator, d: torch.Tensor, apply_quantize: bool = False,
                        quant=None) -> torch.Tensor:
    """The server op on NTT-domain residues [nb, 3, 64, 2, L, n] (uint32 or
    int64) on the evaluator's device -> uint32, same shape.

    Bit-identical to rgb_to_ycc + dct8x8 (+ quantize) of ``jpeg_encode``;
    see the module docstring for why.  Every intermediate is checked to lie
    in [0, 2^32) (``LazyOps.verify``)."""
    par = ev.params
    maxbits = max(int(p).bit_length() for p in par.q_primes)
    lz = LazyOps(ev.p, maxbits)
    d = modops.to_i64(d)

    def op(*vals):
        return _operand(ev, *vals)

    def mul(x, o):
        return lz.mul_shoup(x, *o)

    # --- YCC (reference op order: lincomb / sub / add, fhe_image.h:307-325)
    r = Lazy(d[:, 0], 1)  # [nb, 64, 2, L, n]
    g = Lazy(d[:, 1], 1)
    b = Lazy(d[:, 2], 1)
    y = lz.add(lz.add(mul(r, op(0.299)), mul(g, op(0.587))), mul(b, op(0.114)))
    # sub_plain(E(128)*Delta) touches only component c0
    dm128 = ev.encode(128.0).on(ev.device).add_ntt  # [L, n]
    y = lz.reduce_to(y, lz.M - 1)
    yv = y.v.clone()
    yv[..., 0, :, :] = lz.checked(y.v[..., 0, :, :] + (lz.p - dm128))
    y = Lazy(yv, y.m + 1)
    cb = lz.add(lz.sub(mul(r, op(-0.168736)), mul(g, op(0.331264))), mul(b, op(0.5)))
    cr = lz.sub(lz.sub(mul(r, op(0.5)), mul(g, op(0.418688))), mul(b, op(0.081312)))
    del d, r, g, b

    # --- DCT over the 64 slots (the channel axis rides along as batch) ----
    ycc = torch.stack([y.v, cb.v, cr.v], dim=1)  # [nb, 3, 64, 2, L, n]
    m0 = max(y.m, cb.m, cr.m)
    del y, cb, cr
    s = [Lazy(ycc[:, :, k], m0) for k in range(64)]

    row_C = [op(c) for c in ROT]
    col_C = [op(c, EIGHTH) for c in ROT]
    scale = op(EIGHTH)
    for c in range(8):
        idx = list(range(8 * c, 8 * c + 8))
        outs = _aan_pass_lazy(lz, [s[i] for i in idx], row_C, None)
        for i, o in zip(idx, outs):
            s[i] = o
    del ycc
    for c in range(8):
        idx = list(range(c, 64, 8))
        outs = _aan_pass_lazy(lz, [s[i] for i in idx], col_C, scale)
        for i, o in zip(idx, outs):
            s[i] = o
    if apply_quantize:
        s = [mul(s[k], op(1.0 / float(quant[k]))) for k in range(64)]
    out = torch.stack([modops.to_u32(lz.canon(x)) for x in s], dim=2)
    lz.verify()
    return out
