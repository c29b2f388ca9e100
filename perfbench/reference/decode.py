"""The plain reference of the harmonic run-length decode server.

The reference's server (fhe_decode.h:244-282, the trusted overload) sums,
at every output position i, the Fourier series of each (value, count) run
of a channel.  Regrouped by linearity, the series of a whole channel is
h0 + sum_j cos(a_j i) hc_j + sin(a_j i) hs_j, a_j = float32(j) pi / order:
the client aggregates its runs into these 2 * degree + 1 harmonics, and the
server weighs the encrypted harmonics with the encodings of 1, cos(a_j i)
and sin(a_j i).  So the server's output for position i decrypts to
sum_k W_k[i] m_k in Z_t[X]/(X^n + 1), m_k the harmonics' plaintexts and
W_k[i] the encoded weights; this module computes that sum.

The negacyclic products are float64 matrix products on centred
coefficients, |c| <= t/2: each product is below t^2 / 4 and each output
coefficient a sum of H * n of them, below 2^53 at t = 2^14 (2^41.6 at
H = 25, n = 2048), so every partial sum is an exact integer in any order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ring import Encoder


def run_length_pairs(values) -> list:
    """[(value, count)] runs of a 1-D sequence, as the client sends them."""
    pairs = []
    for v in values:
        if pairs and pairs[-1][0] == v:
            pairs[-1][1] += 1
        else:
            pairs.append([int(v), 1])
    return pairs


def channel_harmonics(pairs, order: int, degree: int, delta: float) -> np.ndarray:
    """The client's aggregation of one channel's runs into doubles
    [h0, hc_1..hc_degree, hs_1..hs_degree], the reference's float32(j)
    included."""
    h = np.zeros(2 * degree + 1)
    index = 0.0
    for val, cnt in pairs:
        amp = float(val)
        b = cnt / 2.0
        offset = -(index + b - 0.5)
        b += delta - 0.5
        h[0] += amp * b / float(order)
        for j in range(1, degree + 1):
            jf = float(np.float32(j))
            a_j = jf * math.pi / float(order)
            w = 2.0 / (math.pi * jf) * math.sin(a_j * b) * amp
            h[j] += w * math.cos(a_j * offset)
            h[degree + j] += -w * math.sin(a_j * offset)
        index += cnt
    return h


def weights(positions, order: int, degree: int) -> np.ndarray:
    """Doubles [H, P]: 1, cos(a_j i) for j = 1..degree, sin(a_j i) likewise."""
    pos = np.asarray(positions, dtype=np.float64)
    w = np.ones((2 * degree + 1, len(pos)))
    for j in range(1, degree + 1):
        a_j = float(np.float32(j)) * math.pi / float(order)
        w[j] = np.cos(a_j * pos)
        w[degree + j] = np.sin(a_j * pos)
    return w


def encode_batch(enc: Encoder, values) -> np.ndarray:
    """``Encoder.encode`` of every value, int64 [..., n] in [0, t): the same
    digits from the same float64 operations, over arrays."""
    v = np.asarray(values, dtype=np.float64)
    flat = v.reshape(-1)
    a = np.abs(flat)
    whole = np.floor(a)
    if (whole >= 2.0**62).any():
        raise ValueError("a value's integer part exceeds what this encoder reads")
    frac = a - whole
    w = whole.astype(np.int64)
    out = np.zeros((flat.size, enc.n), dtype=np.int64)
    k = 0
    while w.any():
        if k == enc.n_int:
            raise ValueError(f"a value has more than {enc.n_int} integer digits")
        out[:, k] = w & 1
        w >>= 1
        k += 1
    for i in range(1, enc.n_frac + 1):
        frac = frac * 2.0
        d = np.floor(frac)
        frac = frac - d
        out[:, enc.n - i] = np.where(d != 0, -1, 0)
    out = np.where(flat[:, None] < 0, -out, out)
    return np.mod(out, enc.t).reshape(v.shape + (enc.n,))


class DecodeReference:
    """The weights' encodings of one image's positions, centred, on a
    device; ``plain`` expands one channel's harmonic plaintexts."""

    def __init__(self, enc: Encoder, positions, order: int, degree: int, device):
        self.t, self.n = enc.t, enc.n
        self.device = torch.device(device)
        w = weights(positions, order, degree)
        self.w = torch.stack([torch.from_numpy(enc.lifted(encode_batch(enc, row))
                                               .astype(np.int32)).to(self.device)
                              for row in w])  # [H, P, n]
        i = torch.arange(self.n, device=self.device)
        # row i, column j: x^i * x^(j - i) = x^j, negated where j - i wraps below 0
        self.index = (i[None, :] - i[:, None]) % self.n
        self.sign = torch.where(i[None, :] >= i[:, None], 1.0, -1.0).to(torch.float64)

    def plain(self, m: np.ndarray) -> torch.Tensor:
        """One channel's harmonic plaintexts [H, n] in [0, t) to its output
        plaintexts, int64 [P, n] in [0, t)."""
        mc = torch.from_numpy(np.where(m >= (self.t + 1) // 2, m - self.t, m)
                              .astype(np.float64)).to(self.device)
        acc = torch.zeros((self.w.shape[1], self.n), dtype=torch.float64, device=self.device)
        for k in range(self.w.shape[0]):
            acc += self.w[k].to(torch.float64) @ (mc[k][self.index] * self.sign)
        return acc.to(torch.int64) % self.t
