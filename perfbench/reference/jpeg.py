"""Plain reference of the encrypted JPEG server op: RGB -> YCbCr and the
8x8 AAN DCT of the reference's network (``fhe_image.h``), evaluated on
ciphertext residues.

Every step multiplies a ciphertext by a plaintext constant or adds two, so
the output is fixed exactly by the input: in the evaluation domain a
multiply_plain is the pointwise product with NTT(lift(encode(c))), and the
Y channel's "- 128" subtracts NTT(Delta lift(encode(128))) from component
0.  The constants are encoded here, the NTT is ``ring.Ring``'s own.
"""

from __future__ import annotations

import torch

from .ring import Encoder, Ring

# the reference network's constants (fhe_image.h:192-325)
YCC = (0.299, 0.587, 0.114, -0.168736, 0.331264, 0.5, 0.418688, 0.081312)
AAN = (0.541196100, 0.765366865, -1.847759065, 1.175875602, 0.298631336, 2.053119869,
       3.072711026, 1.501321110, -0.899976223, -2.562915447, -1.961570560, -0.390180644,
       0.125)


class JpegReference:
    def __init__(self, ring: Ring, encoder: Encoder):
        self.ring = ring
        q = 1
        for p in ring.primes:
            q *= p
        delta = ring._up([[(q // encoder.t) % p] for p in ring.primes])
        consts = set(YCC) | set(AAN)
        self.w = {c: self._plain_ntt(encoder, c) for c in consts}
        self.sub128 = ring.mul(self._plain_ntt(encoder, 128.0), delta)

    def _plain_ntt(self, encoder: Encoder, value: float) -> torch.Tensor:
        small = torch.from_numpy(encoder.lifted(encoder.encode(value))).to(self.ring.device)
        return self.ring.ntt(self.ring.lift(small))  # [L, n]

    def _m(self, x, c):
        return self.ring.mul(x, self.w[c])

    def _pass(self, a, eighth: bool):
        r, m = self.ring, self._m
        add, sub = r.add, r.sub
        t0, t7 = add(a[0], a[7]), sub(a[0], a[7])
        t1, t6 = add(a[1], a[6]), sub(a[1], a[6])
        t2, t5 = add(a[2], a[5]), sub(a[2], a[5])
        t3, t4 = add(a[3], a[4]), sub(a[3], a[4])
        t10, t13 = add(t0, t3), sub(t0, t3)
        t11, t12 = add(t1, t2), sub(t1, t2)
        out = [None] * 8
        out[0], out[4] = add(t10, t11), sub(t10, t11)
        z1 = m(add(t12, t13), AAN[0])
        out[2] = add(z1, m(t13, AAN[1]))
        out[6] = add(z1, m(t12, AAN[2]))
        z1, z2 = add(t4, t7), add(t5, t6)
        z3, z4 = add(t4, t6), add(t5, t7)
        z5 = m(add(z3, z4), AAN[3])
        t4, t5, t6, t7 = m(t4, AAN[4]), m(t5, AAN[5]), m(t6, AAN[6]), m(t7, AAN[7])
        z1, z2, z3, z4 = m(z1, AAN[8]), m(z2, AAN[9]), m(z3, AAN[10]), m(z4, AAN[11])
        z3, z4 = add(z3, z5), add(z4, z5)
        out[7] = add(add(t4, z1), z3)
        out[5] = add(add(t5, z2), z4)
        out[3] = add(add(t6, z2), z3)
        out[1] = add(add(t7, z1), z4)
        return [m(o, AAN[12]) for o in out] if eighth else out

    def _dct(self, slots):
        s = list(slots)
        for g in range(8):
            s[8 * g:8 * g + 8] = self._pass(s[8 * g:8 * g + 8], False)
        for c in range(8):
            col = self._pass(s[c::8], True)
            for g in range(8):
                s[8 * g + c] = col[g]
        return s

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficient-form ciphertexts [nb, 3, 64, 2, L, n] (RGB, slot,
        component) -> int64 [nb, 3, 64, 2, L, n] (Y, Cb, Cr)."""
        r = self.ring
        d = r.ntt(r.reduce(x.to(torch.int64)))
        m = self._m
        red, grn, blu = d[:, 0], d[:, 1], d[:, 2]
        y = r.add(r.add(m(red, 0.299), m(grn, 0.587)), m(blu, 0.114))
        y[:, :, 0] = r.sub(y[:, :, 0], self.sub128)  # - 128 on component 0
        cb = r.add(r.sub(m(red, -0.168736), m(grn, 0.331264)), m(blu, 0.5))
        cr = r.sub(r.sub(m(red, 0.5), m(grn, 0.418688)), m(blu, 0.081312))
        del d, red, grn, blu
        chans = [torch.stack(self._dct([c[:, k] for k in range(64)]), dim=1)
                 for c in (y, cb, cr)]
        return r.intt(torch.stack(chans, dim=1))
