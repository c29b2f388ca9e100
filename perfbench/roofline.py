"""The least time a step could take on the card, from its shapes.

A frozen copy of ``chip_smoke.py``'s ``kernel_work`` and ``bound_times``
(the integer-operation model of the NTT and fused YCC+DCT kernels), so that
a change to the program never changes the yardstick.  A step's bound is the
larger of its bytes over HBM's rate (each input byte read once, each output
byte written once) and its fewest integer operations over the SMs' rate.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
LANE_OPS_PER_CLOCK = np.array([64, 64])  # FMA pipe, ALU pipe, int32 results per SM per clock
DISPATCH_PER_CLOCK = 128  # 4 warp schedulers x 32 lanes, per SM

# int32 operations per modular operation as (FMA pipe, ALU pipe, either)
LAZY_ADD = np.array([0, 0, 1])  # a + k*p - b, one three-input add
LAZY_MUL = np.array([3, 0, 0])  # Shoup: mulhi(x, w'), then x*w - q*p
RED = np.array([0, 1, 1])  # one conditional subtraction: subtract, min
# one lazy 8-point AAN pass (28 three-input adds, 12 products) reduced by 3
# subtractions after a row pass; a column pass adds the 8 x0.125 products
LAZY_DCT = (8 * (28 * LAZY_ADD + 12 * LAZY_MUL + 8 * 3 * RED)
            + 8 * (28 * LAZY_ADD + 20 * LAZY_MUL + 8 * RED))


def lazy_multiple(primes) -> int:
    """The headroom multiple m of the lazy operation graph (2 where every
    prime leaves 16p of u32 headroom, 1 for 8p, else 0)."""
    hr = (1 << 32) // max(int(p) for p in primes)
    return 2 if hr >= 16 else 1 if hr >= 8 else 0


def ntt_ops(name: str, polys: int, n: int) -> np.ndarray:
    """Fewest operations of one NTT (``ntt_forward`` or ``ntt_inverse``)
    over ``polys`` (polynomial, limb) pairs of degree n."""
    fly = LAZY_MUL + 2 * LAZY_ADD + RED  # a lazy product, x + t, x - t + 2p, a subtraction
    stages = n.bit_length() - 1
    if name == "ntt_forward":  # values < 4p; two subtractions at the end
        per = stages * (n // 2) * fly + n * 2 * RED
    else:  # n^-1 folded into the last stage's products; one subtraction
        last = 2 * LAZY_MUL + 2 * LAZY_ADD
        per = (stages - 1) * (n // 2) * fly + (n // 2) * last + n * RED
    return polys * per


def ycc_dct_ops(blocks: int, L: int, n: int, m: int) -> np.ndarray:
    """Fewest operations of the fused YCC+DCT over ``blocks`` blocks of
    3 x 64 two-component ciphertexts: per (block, component, lane) 64 slots
    of 9 products, 6 three-input adds and 3 reductions, and 3 DCTs."""
    if m <= 0:
        raise ValueError("the lazy operation graph needs u32 headroom")
    steps = 3 if m == 1 else 2
    ycc = 64 * (9 * LAZY_MUL + 6 * LAZY_ADD + 3 * steps * RED)
    return blocks * 2 * L * n * (ycc + 3 * LAZY_DCT)


def bound_s(nbytes: float, ops, sms: int, clock_hz: float) -> float:
    """The larger of bytes over HBM's rate and the least integer time, in
    which each pipe runs its own operations and all of them dispatch at the
    dispatch rate."""
    ops = np.asarray(ops if ops is not None else [0, 0, 0], dtype=np.float64)
    clocks = max(*(ops[:2] / LANE_OPS_PER_CLOCK), ops.sum() / DISPATCH_PER_CLOCK)
    return max(nbytes / HBM_BYTES_PER_S, clocks / (sms * clock_hz))
