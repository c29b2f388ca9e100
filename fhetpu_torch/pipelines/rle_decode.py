"""Encrypted run-length decode: Taylor sin/cos and the Fourier-series step.

Port of ``fhetpu/pipelines/rle_decode.py`` (the reference's fhe_decode.h),
at its three levels of fidelity:

* ``homomorphic_sin`` / ``homomorphic_cos``: the reference's degree-10
  Taylor chains centred at 3*pi/2 (fhe_decode.h:48-200), with their exact
  power-building op order (BEHZ bits depend on which products are formed);
* ``approximated_step_trusted`` and ``fourier_channel_trusted``: the
  decrypt-evaluate-reencrypt overload the reference server calls
  (fhe_decode.h:244-282), host NumPy only, and it needs the secret key;
* ``approximated_step_fhe``: the batched pure-FHE Fourier step with the
  reference's offset-mutation bug fixed and the plaintext/encrypted angle
  split; correct only inside a shallow envelope (degree <= 2, t >= 2^24,
  about 10 fractional digits, small amplitudes), where the carry-free
  fractional encoder's digits stay below t/2;
* the harmonic protocol (``fourier_harmonics_host`` on the client,
  ``expand_harmonics_batched`` on the server): the client aggregates its
  plaintext pairs into 2*degree+1 channel harmonics and the server expands
  them at every output position with plaintext weights, multiply_plain and
  add only.

The per-pair ``index += count`` of the reference (server_decode.cpp:135) is
an encrypted prefix sum (``cumulative_counts``).  fhetpu's jit, fori_loop
and compiled-closure cache have no counterpart: torch runs the ops as they
come.  Tables of plaintext weights are NTTs of centred-lifted encodings,
built on the evaluator's device through ``core.ntt`` (the CUDA kernel on a
card) and cached on the evaluator per value array.  Products with them are
``modops.mulmod`` (exact int64), where fhetpu uses Barrett: the residues are
the same.  The harmonic expansion runs on a card as one hand-written CUDA
kernel (``core/expand_kernel.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..bfv.crypto import centered_lift_plain
from ..bfv.evaluator import Ct, Evaluator
from ..core import expand_kernel, modops, ntt
from ..trace import span

M_PI = math.pi


def _power_chain(ev, shifted, squarings: int, extra_mults: int, relin=None):
    """(x)^(2^squarings) * x^extra_mults via the reference's op order."""
    p = shifted
    for _ in range(squarings):
        p = ev.square(p)
        if relin is not None:
            p = ev.relinearize(p, relin)
    for _ in range(extra_mults):
        p = ev.multiply(p, shifted)
        if relin is not None:
            p = ev.relinearize(p, relin)
    return p


def _taylor_3pi2(ev, x: Ct, signs, zero_order: float, relin=None) -> Ct:
    """Shared structure of homomorphic_sin/cos: shift by -3pi/2, build powers
    2, 4, 6, 8, 10 (square/multiply chains, fhe_decode.h:59-110), scale by
    1/k! with the given signs, sum with the zero-order term."""
    shifted = ev.add_plain(x, ev.encode(-3 * M_PI / 2.0))
    p2 = _power_chain(ev, shifted, 1, 0, relin)
    p4 = _power_chain(ev, shifted, 2, 0, relin)
    p6 = _power_chain(ev, shifted, 2, 2, relin)
    p8 = _power_chain(ev, shifted, 3, 0, relin)
    p10 = _power_chain(ev, shifted, 3, 2, relin)
    terms = [
        ev.multiply_plain(p2, ev.encode(signs[0] * 0.5)),
        ev.multiply_plain(p4, ev.encode(signs[1] / 24.0)),
        ev.multiply_plain(p6, ev.encode(signs[2] / 720.0)),
        ev.multiply_plain(p8, ev.encode(signs[3] / 40320.0)),
        ev.multiply_plain(p10, ev.encode(signs[4] / 3628800.0)),
    ]
    acc = terms[0]
    for t in terms[1:]:
        acc = ev.add(acc, t)
    return ev.add_plain(acc, ev.encode(zero_order))


def homomorphic_sin(ev: Evaluator, x: Ct, relin=None) -> Ct:
    """sin(x) for x near 3pi/2: Taylor about 3pi/2 (fhe_decode.h:48-120):
    -1 + z^2/2 - z^4/24 + z^6/720 - z^8/40320 + z^10/3628800, z = x-3pi/2."""
    return _taylor_3pi2(ev, x, (+1, -1, +1, -1, +1), -1.0, relin)


def homomorphic_cos(ev: Evaluator, x: Ct, relin=None) -> Ct:
    """The reference's 'cos' (fhe_decode.h:123-200): despite its comment it
    also shifts by -3pi/2 and applies the cos(z) series, so it computes
    cos(x - 3pi/2) == -sin(x).  Ported as it is."""
    return _taylor_3pi2(ev, x, (-1, +1, -1, +1, -1), 1.0, relin)


def cumulative_counts(ev: Evaluator, counts: List[Ct]) -> List[Optional[Ct]]:
    """Encrypted prefix sums: index_p = sum_{k<p} count_k (exclusive scan),
    in place of the reference's serial index += count
    (server_decode.cpp:135).  out[0] is None (index 0)."""
    out = []
    acc = None
    for c in counts:
        out.append(acc)
        acc = c if acc is None else ev.add(acc, c)
    return out


def _relin(ev, ct, relin):
    return ev.relinearize(ct, relin) if relin is not None and ct.size > 2 else ct


# Taylor series about the origin (the pure-FHE step's encrypted residual
# arguments are centred near 0 after the plaintext/encrypted angle split).
_SIN0 = {1: 1.0, 3: -1.0 / 6, 5: 1.0 / 120, 7: -1.0 / 5040, 9: 1.0 / 362880}
_COS0 = {2: -0.5, 4: 1.0 / 24, 6: -1.0 / 720, 8: 1.0 / 40320, 10: -1.0 / 3628800}


def _origin_powers(ev, x: Ct, ks, relin):
    """Minimal-depth power chains for the required exponents, relinearized
    after every ct x ct when keys are given."""
    pows = {1: x}

    def get(k):
        if k not in pows:
            if k % 2 == 0:
                pows[k] = _relin(ev, ev.square(get(k // 2)), relin)
            else:
                pows[k] = _relin(ev, ev.multiply(get(k - 1), x), relin)
        return pows[k]

    for k in ks:
        get(k)
    return pows


def taylor_sin_origin(ev: Evaluator, x: Ct, relin=None, max_power: int = 9) -> Ct:
    """sin(y) ~= y - y^3/6 + y^5/120 - y^7/5040 + y^9/362880, |y| <~ pi,
    truncated after y^max_power (error <= |y|^(max_power+2)/(max_power+2)!).
    Coefficient form out."""
    ks = [k for k in sorted(_SIN0) if k <= max_power]
    pows = _origin_powers(ev, x, ks, relin)
    acc = None
    for k in ks:
        c = _SIN0[k]
        term = pows[k] if c == 1.0 else ev.multiply_plain(pows[k], ev.encode(c))
        term = ev.transform_from_ntt(term)
        acc = term if acc is None else ev.add(acc, term)
    return acc


def taylor_cos_origin(ev: Evaluator, x: Ct, relin=None, max_power: int = 10) -> Ct:
    """cos(y) ~= 1 - y^2/2 + y^4/24 - ... + y^10/3628800, |y| <~ pi,
    truncated after y^max_power.  Coefficient form out."""
    ks = [k for k in sorted(_COS0) if k <= max_power]
    pows = _origin_powers(ev, x, ks, relin)
    acc = None
    for k in ks:
        term = ev.transform_from_ntt(ev.multiply_plain(pows[k], ev.encode(_COS0[k])))
        acc = term if acc is None else ev.add(acc, term)
    return ev.add_plain(acc, ev.encode(1.0))


def approximated_step_fhe(
    ev: Evaluator,
    amplitude: Ct,
    index: Optional[Ct],
    count: Ct,
    order: int,
    degree: int,
    delta: float,
    positions: np.ndarray,
    relin=None,
    taylor_max_power: Optional[int] = None,
) -> Ct:
    """Pure-FHE Fourier step of one (amplitude, count) pair, batched over
    the output positions:

    run[i] = amp * [ b/order + sum_{j=1..degree} (2/(j pi)) *
                     sin(j pi b / order) * cos(j pi (i + offset) / order) ]

    with b = count/2 + delta - 0.5 and offset = -(index + count/2 - 0.5)
    (fhe_decode.h:214-241, with the reference's in-place corruption of
    offset at :229 fixed).  The cosine argument splits into its plaintext
    part A = a_j*i and its encrypted residual B = a_j*offset by
    cos(A+B) = cos(A)cos(B) - sin(A)sin(B): cos(A) and sin(A) are exact
    doubles, and only the residuals a_j*offset and a_j*b go through the
    origin-centred Taylor chains (truncated after ``taylor_max_power``,
    default 3).  Outside the shallow envelope (degree <= 2, t >= 2^24,
    about 10 fractional digits, amplitudes up to about 50) the fractional
    encoder's carry-free digits overflow t and the decrypted values wrap;
    fhetpu's docstring gives the measurements.

    Inputs are [size, L, n] ciphertexts; returns [P, size', L, n] in
    coefficient form (size 2 with relinearization keys)."""
    mp = 3 if taylor_max_power is None else taylor_max_power

    b = ev.multiply_plain(count, ev.encode(0.5))
    offset = b if index is None else ev.add(index, b)
    offset = ev.add_plain(offset, ev.encode(-0.5))
    offset = ev.negate(offset)
    b = ev.add_plain(b, ev.encode(delta - 0.5))

    P = len(positions)

    def bcast(ct: Ct) -> Ct:
        """The ciphertext repeated along a new leading axis of P, no copy;
        row-wise ops on it equal the op on ct, so they run before it where
        a kernel needs contiguous input."""
        return Ct(ct.data.expand((P,) + tuple(ct.data.shape)), ct.ntt_form)

    pos = np.asarray(positions, dtype=np.float64)
    acc = bcast(ev.transform_to_ntt(ev.multiply_plain(b, ev.encode(1.0 / float(order)))))
    for j in range(1, degree + 1):
        a_j = float(np.float32(j)) * M_PI / float(order)
        w_j = 2.0 / (M_PI * float(np.float32(j)))
        sin_b = taylor_sin_origin(
            ev, ev.multiply_plain(b, ev.encode(a_j)), relin, max_power=mp
        )
        y = ev.multiply_plain(offset, ev.encode(a_j))
        cos_o = taylor_cos_origin(ev, y, relin, max_power=mp + 1)
        sin_o = taylor_sin_origin(ev, y, relin, max_power=mp)
        pj = _relin(ev, ev.multiply(sin_b, cos_o), relin)
        qj = _relin(ev, ev.multiply(sin_b, sin_o), relin)
        # term_i = w_j * sin_b * (cos(a_j i) cos_o - sin(a_j i) sin_o)
        term = mul_plain_stacked(ev, bcast(ev.transform_to_ntt(pj)), w_j * np.cos(a_j * pos))
        term = ev.add(term, mul_plain_stacked(ev, bcast(ev.transform_to_ntt(qj)),
                                              -w_j * np.sin(a_j * pos)))
        acc = ev.add(acc, term)
    out = ev.multiply(acc, bcast(amplitude))
    return _relin(ev, out, relin)


def _ev_cache(ev) -> dict:
    cache = getattr(ev, "_stacked_tab_cache", None)
    if cache is None:
        cache = ev._stacked_tab_cache = {}
    return cache


def mul_plain_stacked(ev: Evaluator, ct: Ct, values: np.ndarray) -> Ct:
    """Row-wise multiply_plain: batched ct [P, size, L, n] times
    encode(values[p]) per row.  Returns NTT form, int64."""
    tab = _stacked_mul_table(ev, values)  # [P, L, n]
    ctn = ev.transform_to_ntt(ct)
    out = modops.mulmod(modops.to_i64(ctn.data), tab[:, None], ev.p)
    return Ct(out, True)


def _stacked_mul_table(ev: Evaluator, values: np.ndarray) -> torch.Tensor:
    """NTT(centered_lift(encode(v))) for each v: int64 [P, L, n] on the
    evaluator's device, the NTTs there.  Cached on the evaluator per value
    array and device, so the three channels and repeated batches reuse it."""
    values = np.asarray(values, dtype=np.float64)
    key = ("stacked", values.shape, hash(values.tobytes()), ev.device)
    cache = _ev_cache(ev)
    if key not in cache:
        lifted = centered_lift_plain(ev.encoder.encode_batch(values), ev.params)
        tab = ntt.ntt(torch.from_numpy(lifted).to(ev.device), ev.tables_q)
        cache[key] = modops.to_i64(tab)
    return cache[key]


# --------------------------------------------------------------------------
# Client-side-trig harmonic protocol.
#
# The Fourier step is linear in the per-pair quantities amp*sin(a_j b)*
# cos(a_j offset) etc., and the client knows its own plaintext pairs, so it
# evaluates the trig in exact doubles, aggregates the per-pair contributions
# into 2*degree+1 channel harmonics and ships those encrypted.  The server,
# with no secret key and no approximation, expands the encrypted Fourier
# series at every output position with plaintext weights:
# out_i = h0 + sum_j cos(a_j i) hc_j + sin(a_j i) hs_j.  Depth 0, and the
# server's cost is O(degree * positions), independent of the pair count.
# The semantics are the trusted overload's (fhe_decode.h:244-282) regrouped
# by linearity, its float32(j) quirk included.
# --------------------------------------------------------------------------


def fourier_harmonics_host(pairs, order: int, degree: int, delta: float) -> np.ndarray:
    """Aggregate per-pair Fourier contributions into channel harmonics.

    pairs: [(value, count)] plaintext RLE pairs (client side).
    Returns doubles [2*degree+1]: [h0, hc_1..hc_degree, hs_1..hs_degree].
    """
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
            a_j = jf * M_PI / float(order)
            w = 2.0 / (M_PI * jf) * math.sin(a_j * b) * amp
            h[j] += w * math.cos(a_j * offset)
            h[degree + j] += -w * math.sin(a_j * offset)
        index += cnt
    return h


def harmonic_weight_tables(ev: Evaluator, positions: np.ndarray, order: int,
                           degree: int) -> torch.Tensor:
    """uint32 [H, P, L, n] NTT tables of the expansion weights' encodings on
    the evaluator's device, rows [1, cos(a_1 i).., cos(a_d i), sin(a_1 i)..,
    sin(a_d i)].

    The weights cross to the device as compact mod-t coefficients (16 bits
    each where t <= 2^16, else 32), are centred-lifted there one harmonic's
    rows at a time (c >= ceil((t+1)/2) -> c - t + p_l) into one uint32
    buffer, and go through one forward NTT.  uint32 halves the tables
    against int64 (0.94 GB at 25 x 2304 x 2 x 2048).  Cached per (order,
    degree, positions) and device on the evaluator, shared by the three
    channels."""
    pos = np.asarray(positions, dtype=np.float64)
    key = ("harmW", order, degree, len(pos), hash(pos.tobytes()), ev.device)
    cache = _ev_cache(ev)
    if key in cache:
        return cache[key]
    with span("pipelines.rle_decode.weight_tables"):
        tab = _build_weight_tables(ev, pos, order, degree)
    cache[key] = tab
    return tab


def _build_weight_tables(ev: Evaluator, pos: np.ndarray, order: int,
                         degree: int) -> torch.Tensor:
    par = ev.params
    H, P = 2 * degree + 1, len(pos)
    W = np.ones((H, P))
    for j in range(1, degree + 1):
        a_j = float(np.float32(j)) * M_PI / float(order)
        W[j] = np.cos(a_j * pos)
        W[degree + j] = np.sin(a_j * pos)
    coeffs = ev.encoder.encode_batch(W.reshape(-1))  # [H*P, n] in [0, t)
    if par.t <= 1 << 16:  # the uint16 bits travel as int16 and are masked back
        c_dev = torch.from_numpy(coeffs.astype(np.uint16).view(np.int16)).to(ev.device)
        mask = 0xFFFF
    else:
        c_dev = torch.from_numpy(coeffs.astype(np.int32)).to(ev.device)
        mask = None
    del coeffs
    lifted = torch.empty((H * P, par.L, par.n), dtype=torch.uint32, device=ev.device)
    thr, t = par.plain_upper_half_threshold, par.t
    for k in range(H):
        c = c_dev[k * P:(k + 1) * P].to(torch.int64)
        if mask is not None:
            c &= mask
        c = c[:, None, :]
        lifted[k * P:(k + 1) * P] = torch.where(c >= thr, c - t + ev.p, c).to(torch.uint32)
    del c_dev
    return ntt.ntt(lifted, par.tables_q).reshape(H, P, par.L, par.n)


def expand_harmonics_plain(tabs: torch.Tensor, hn: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The expansion in torch int64 ops: sum_k tabs[k, pos] * hn[k] mod p
    for uint32 tables [H, P, L, n] and int64 harmonics [H, size, L, n] in
    NTT form -> int64 [P, size, L, n], canonical.  One accumulator, one
    harmonic's tables widened at a time, reduced once at the end.  The CPU
    path of expand_harmonics_batched and the kernel's oracle."""
    acc = torch.zeros((tabs.shape[1],) + tuple(hn.shape[1:]), dtype=torch.int64,
                      device=hn.device)
    for k in range(tabs.shape[0]):
        acc += modops.mulmod(tabs[k].to(torch.int64)[:, None], hn[k][None], p)
    acc %= p  # a sum of H residues below p: below 2^35
    return acc


def expand_harmonics_batched(
    ev: Evaluator, harm: Ct, positions: np.ndarray, order: int, degree: int
) -> Ct:
    """Expansion of encrypted harmonics [H, size, L, n] at the given
    positions through the cached weight tables, bit-identical to
    expand_harmonics_server; returns NTT form [P, size, L, n].  On a CUDA
    tensor one launch of the hand-written kernel
    (``core/expand_kernel.py``), uint32 out; on the CPU its plain version,
    ``expand_harmonics_plain``, int64 out.

    Counts its ``calls`` and its modular ``products`` (H * P * size * L * n
    a call) as attributes of the function."""
    with span("pipelines.rle_decode.expand"):
        tabs = harmonic_weight_tables(ev, positions, order, degree)
        hn = ev.transform_to_ntt(harm).data  # [H, size, L, n]
        if hn.device.type == "cuda":
            out = expand_kernel.harmonic_expand(tabs, modops.to_u32(hn).contiguous(),
                                                ev.params.q_primes)
        else:
            out = expand_harmonics_plain(tabs, modops.to_i64(hn), ev.p)
    expand_harmonics_batched.calls += 1
    expand_harmonics_batched.products += tabs.shape[0] * out.numel()
    return Ct(out, True)


expand_harmonics_batched.calls = expand_harmonics_batched.products = 0


def serve_harmonics_channel(ev: Evaluator, harm: Ct, positions: np.ndarray, order: int,
                            degree: int) -> Ct:
    """The harmonic decode server's step for one channel: the expansion of
    its encrypted harmonics [H, size, L, n] at every position, returned in
    coefficient form, [P, size, L, n] uint32, as the server writes it."""
    return ev.transform_from_ntt(expand_harmonics_batched(ev, harm, positions, order, degree))


def expand_harmonics_server(
    ev: Evaluator, harm: Ct, positions: np.ndarray, order: int, degree: int
) -> Ct:
    """Expand encrypted harmonics [H=2*degree+1, size, L, n] at the given
    positions: out_i = h0 + sum_j cos(a_j i) hc_j + sin(a_j i) hs_j, one
    mul_plain_stacked per harmonic.  Returns Ct [P, size, L, n] (NTT
    form)."""
    pos = np.asarray(positions, dtype=np.float64)
    P = len(pos)
    hn = ev.transform_to_ntt(harm)

    def row(k) -> Ct:
        d = hn.data[..., k, :, :, :]
        return Ct(d.expand((P,) + tuple(d.shape)), True)

    acc = row(0)
    for j in range(1, degree + 1):
        a_j = float(np.float32(j)) * M_PI / float(order)
        acc = ev.add(acc, mul_plain_stacked(ev, row(j), np.cos(a_j * pos)))
        acc = ev.add(acc, mul_plain_stacked(ev, row(degree + j), np.sin(a_j * pos)))
    return acc


def fourier_channel_trusted(
    amps: np.ndarray, counts: np.ndarray,
    order: int, degree: int, delta: float, positions: np.ndarray,
    pair_chunk: int = 256,
) -> np.ndarray:
    """Whole-channel trusted evaluation, vectorized over pairs x positions.

    Value-identical to summing approximated_step_trusted over all pairs
    (decode is linear, so one re-encryption of the channel sum decrypts to
    the same values as the reference's per-pair re-encrypt and ciphertext
    adds, server_decode.cpp:131-134), in one host pass.  Chunked over pairs
    to bound the [k, P, degree] intermediate."""
    amps = np.asarray(amps, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    pos = np.asarray(positions, dtype=np.float64)
    k = len(amps)
    index = np.concatenate([[0.0], np.cumsum(counts)[:-1]])
    b = counts / 2.0
    offset = -(index + b - 0.5)
    b = b + delta - 0.5
    jf = np.float32(np.arange(1, degree + 1)).astype(np.float64)
    af = jf * M_PI / float(order)  # [degree]
    out = np.zeros(len(pos))
    for lo in range(0, k, pair_chunk):
        hi = min(lo + pair_chunk, k)
        # cos(af_j * (i + offset_k)) : [chunk, P, degree]
        arg = af[None, None, :] * (pos[None, :, None] + offset[lo:hi, None, None])
        series = np.sin(af[None, :] * b[lo:hi, None])  # [chunk, degree]
        w = (2.0 / (M_PI * jf))[None, :] * series  # [chunk, degree]
        res = b[lo:hi, None] / float(order) + np.einsum("kpj,kj->kp", np.cos(arg), w)
        out += amps[lo:hi] @ res
    return out


def approximated_step_trusted(
    encoder, encryptor, decryptor, amplitude, index, count,
    order: int, degree: int, delta: float, positions: np.ndarray
) -> np.ndarray:
    """The reference's decrypt-evaluate-reencrypt overload
    (fhe_decode.h:244-282): decrypt amp/index/count, evaluate the Fourier
    series in doubles, re-encrypt per position.  Needs the secret key, like
    the reference server (which loads it, server_jpeg.cpp:97-98)."""
    amp = encoder.decode(decryptor.decrypt(amplitude))
    ind = 0.0 if index is None else encoder.decode(decryptor.decrypt(index))
    cnt = encoder.decode(decryptor.decrypt(count))
    b = cnt / 2.0
    offset = -(ind + b - 0.5)
    b += delta - 0.5
    vals = np.zeros(len(positions))
    for pi, i in enumerate(positions):
        res = b / float(order)
        for j in range(1, degree + 1):
            arg_factor = float(np.float32(j)) * M_PI / float(order)
            res += (
                2.0 / (M_PI * float(np.float32(j)))
                * math.cos(arg_factor * (i + offset))
                * math.sin(arg_factor * b)
            )
        vals[pi] = res * amp
    return encryptor.encrypt_batch(encoder.encode_batch(vals))
