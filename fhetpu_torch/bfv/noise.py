"""Analytic invariant-noise estimates of the JPEG and resize server ops.

The part of ``fhetpu/bfv/noise.py`` that ``estimate_jpeg_pipeline`` and
``estimate_resize_pipeline`` need, for the servers' pre-dispatch noise gate
and the clients' ring-degree chooser.  Tracks log2 of a conservative bound
on the invariant noise ||v||, where t/q * ct(s) = m + v + a*t and
decryption is correct iff ||v|| < 1/2; budget = -log2(2*||v||), SEAL's
convention.  The decode estimates are not carried over yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .params import BfvParams


@dataclass(frozen=True)
class NoiseBudget:
    """log2 of the invariant-noise bound (negative exponent; budget =
    -log2(2*noise) = -(log2_noise + 1))."""

    log2_noise: float
    params: BfvParams

    @property
    def budget_bits(self) -> float:
        return max(-(self.log2_noise + 1.0), 0.0)

    def exhausted(self) -> bool:
        return self.log2_noise >= -1.0

    def check(self, where: str = ""):
        if self.exhausted():
            raise NoiseExhausted(
                f"noise budget exhausted{' at ' + where if where else ''}: "
                f"log2(noise)={self.log2_noise:.1f} (decryption would be garbage; "
                f"increase n / reduce plain modulus t)"
            )
        return self


class NoiseExhausted(RuntimeError):
    pass


# Typical l2 norm of a base-2 fractional encoding (~200 coefficients in
# {-1,0,1}): the effective message-norm factor of the MEAN-case multiply
# model, calibrated in fhetpu against measured budgets.
MEAN_MSG_L2 = 14.0


def fresh(params: BfvParams, mean: bool = False) -> NoiseBudget:
    """Public-key encryption noise: e*u + e0 + e1*s with ternary u,s."""
    n, t, q = params.n, params.t, params.q
    b_err = 6.0 * params.sigma
    width = math.sqrt(2.0 * n + 1.0) if mean else (2.0 * n + 1.0)
    bound = t / q * b_err * width
    return NoiseBudget(math.log2(bound), params)


def multiply_plain(a: NoiseBudget, operand_norm: float) -> NoiseBudget:
    """operand_norm: l1 of the centered operand for the worst-case model,
    l2 (encoded_scalar_l2) for the mean-case model."""
    return NoiseBudget(a.log2_noise + math.log2(max(operand_norm, 1.0)), a.params)


def multiply(a: NoiseBudget, b: NoiseBudget, k1: int = 2, k2: int = 2,
             mean: bool = False, msg_l2: float = None) -> NoiseBudget:
    """msg_l2 overrides the mean-case message-norm factor: a product of j
    fract encodings has l2 ~ MEAN_MSG_L2**j, not MEAN_MSG_L2."""
    p = a.params
    if mean:
        # central-limit width sqrt(n*(k1+k2)) x typical message l2 instead
        # of the worst-case n*(k1+k2) x ||m||_inf<=t envelope
        m = MEAN_MSG_L2 if msg_l2 is None else msg_l2
        growth = math.log2(p.t * m * math.sqrt(p.n * (k1 + k2)))
    else:
        growth = math.log2(p.t * p.n * (k1 + k2))
    base = _log2add(a.log2_noise, b.log2_noise) + growth
    # BEHZ fast-floor alpha error: <= L additive units of t/q scale
    alpha = math.log2(p.t * p.L) - p.q.bit_length()
    return NoiseBudget(_log2add(base, alpha), p)


def relinearize(a: NoiseBudget, digit_bits: int = 0) -> NoiseBudget:
    """Key-switch noise: sum over G digits of ||digit||_inf * n * B_err * t/q.
    One digit per limb => ||digit|| < p_max; with dbc sub-digits =>
    ||digit|| < 2^dbc but D = ceil(bits(p)/dbc) times as many digits."""
    p = a.params
    p_max = max(int(x) for x in p.q_primes)
    if digit_bits:
        n_sub = -(-p_max.bit_length() // digit_bits)
        digit_term = n_sub * (1 << digit_bits)
    else:
        digit_term = p_max
    ks = math.log2(p.L * p.n * digit_term * 6.0 * p.sigma * p.t) - p.q.bit_length()
    return NoiseBudget(_log2add(a.log2_noise, ks), p)


def encoded_scalar_l1(encoder, value: float) -> float:
    """l1 norm of the centered encoding of a scalar (for multiply_plain)."""
    coeffs = encoder.encode(value).balanced()
    return float(abs(coeffs).sum())


def encoded_scalar_l2(encoder, value: float) -> float:
    """l2 norm of the centered encoding (mean-case multiply_plain model)."""
    coeffs = encoder.encode(value).balanced().astype(float)
    return float((coeffs ** 2).sum() ** 0.5)


def _log2add(x: float, y: float) -> float:
    hi, lo = (x, y) if x >= y else (y, x)
    return hi + math.log1p(2.0 ** (lo - hi)) / math.log(2.0)


def estimate_jpeg_pipeline(params: BfvParams, encoder,
                           mean: bool = False) -> NoiseBudget:
    """Static estimate for the YCC+DCT pipeline: the worst slot passes
    through ~2 multiply_plain per DCT pass (x2 passes) plus the YCC combo
    and the 0.125 scale."""
    norm = encoded_scalar_l2 if mean else encoded_scalar_l1
    nb = fresh(params, mean)
    ycc = multiply_plain(nb, norm(encoder, 0.587))
    for _ in range(2):  # row + column pass, worst path ~2 chained const muls
        ycc = multiply_plain(ycc, norm(encoder, 1.175875602))
        ycc = multiply_plain(ycc, norm(encoder, -2.562915447))
    ycc = multiply_plain(ycc, norm(encoder, 0.125))
    # sums of 8 terms per pass (root-sum-square in the mean model)
    width = math.log2(8.0) if mean else math.log2(64)
    # +2 bits dispersion allowance in the mean model: measured budgets at
    # n=8192/16384 sit ~1.2-1.7 bits under the raw estimate
    # (docs/noise_validation.md jpeg rows); margin keeps the gate
    # conservative at every measured point without changing any decision
    margin = 2.0 if mean else 0.0
    return NoiseBudget(ycc.log2_noise + width + margin, params)


def estimate_resize_pipeline(params: BfvParams, encoder, bicubic: bool,
                             plain_fracts: bool = False,
                             mean: bool = False,
                             relin_dbc=None) -> NoiseBudget:
    """Noise trajectory of the resize server op.

    The default multiplies ENCRYPTED fractional offsets: bilinear is 2
    chained ct x ct (horizontal then vertical), bicubic is the depth-4 t^3
    chain into the 4x4 stencil combine.  The plain-fract path replaces
    every ct x ct with multiply_plain by the fract-polynomial encodings
    (same decrypted polynomials).  With relin_dbc (not None), every ct x ct
    is keyswitched back to size 2."""
    norm = encoded_scalar_l2 if mean else encoded_scalar_l1
    nb = fresh(params, mean)
    if plain_fracts:
        # worst tap coefficient magnitude ~2.6 (Catmull-Rom), fract ~0.5;
        # two passes (horizontal, vertical) of one const-mul + 4-term sum
        taps = 4 if bicubic else 2
        for _ in range(2):
            nb = multiply_plain(nb, norm(encoder, -2.5625))
            nb = NoiseBudget(nb.log2_noise + math.log2(float(taps)), params)
        return nb

    def rl(x: NoiseBudget) -> NoiseBudget:
        return relinearize(x, relin_dbc) if relin_dbc is not None else x

    if not bicubic:
        h = rl(multiply(nb, fresh(params, mean), mean=mean))
        k1 = 2 if relin_dbc is not None else 3
        return rl(multiply(h, fresh(params, mean), k1, 2, mean=mean))
    # power-chain operand message norms: t^2 / t^3 are PRODUCTS of fract
    # encodings, l2 ~ MEAN_MSG_L2^j, capped by the centered-mod-t bound
    # (t/2)*sqrt(support): fract^j spans ~j*200 coefficients each < t/2
    l2_t2 = min(MEAN_MSG_L2 ** 2, (params.t / 2.0) * math.sqrt(400.0))
    l2_t3 = min(MEAN_MSG_L2 ** 3, (params.t / 2.0) * math.sqrt(600.0))
    if relin_dbc is not None:
        tsq = rl(multiply(fresh(params, mean), fresh(params, mean), mean=mean))
        tcu = rl(multiply(tsq, fresh(params, mean), mean=mean, msg_l2=l2_t2))
        h = rl(multiply(nb, tcu, mean=mean, msg_l2=l2_t3))
        return rl(multiply(h, tcu, mean=mean, msg_l2=l2_t3))
    tsq = multiply(fresh(params, mean), fresh(params, mean), mean=mean)
    tcu = multiply(tsq, fresh(params, mean), 3, 2, mean=mean, msg_l2=l2_t2)
    h = multiply(nb, tcu, 2, 4, mean=mean, msg_l2=l2_t3)  # a*t^3, size 5
    out = multiply(h, tcu, 5, 4, mean=mean, msg_l2=l2_t3)  # vertical, size 8
    # +2 bits chain-dispersion allowance in the mean model (fhetpu's
    # measured budgets sit within ~+-2 bits of this estimate across n)
    return NoiseBudget(out.log2_noise + 2.0, params) if mean else out
