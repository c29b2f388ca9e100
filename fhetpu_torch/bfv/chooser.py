"""Ring-degree choice for the JPEG and resize pipelines: the
``select_parameters``, ``jpeg_parameters`` and ``resize_parameters`` part of
``fhetpu/bfv/chooser.py``.  Simulates the pipeline's noise growth with the
analytic tracker and picks the smallest ring degree whose default modulus
chain leaves a safety margin."""

from __future__ import annotations

from typing import Callable

from . import noise
from .encoder import FractionalEncoder
from .params import BfvParams

SUPPORTED_N = (1024, 2048, 4096, 8192, 16384, 32768)


def select_parameters(
    simulate: Callable[[BfvParams, FractionalEncoder], "noise.NoiseBudget"],
    t: int = 1 << 14,
    margin_bits: float = 10.0,
    n_int: int = 100,
    n_frac: int = 100,
) -> BfvParams:
    """Smallest-n BfvParams whose simulated final budget exceeds margin.
    Raises if even the largest supported ring cannot support the sequence."""
    for n in SUPPORTED_N:
        if n < n_int + n_frac:
            continue
        par = BfvParams.create(n=n, t=t)
        enc = FractionalEncoder(t, n, n_int, n_frac)
        try:
            budget = simulate(par, enc)
        except noise.NoiseExhausted:
            continue
        if budget.budget_bits >= margin_bits:
            return par
    raise noise.NoiseExhausted(
        f"no supported ring degree sustains this pipeline at t={t}"
    )


def jpeg_parameters(t: int = 1 << 14, margin_bits: float = 10.0) -> BfvParams:
    """Parameter choice for the YCC+DCT JPEG pipeline."""
    return select_parameters(
        lambda par, enc: noise.estimate_jpeg_pipeline(par, enc),
        t=t, margin_bits=margin_bits,
    )


def resize_parameters(bicubic: bool, t: int = 1 << 14,
                      margin_bits: float = 10.0,
                      plain_fracts: bool = False,
                      relin_dbc=None) -> BfvParams:
    """Parameter choice for the encrypted resize (encrypted-fract ct*ct path
    by default; plain_fracts selects the plain-fract path's trajectory;
    relin_dbc models relinearize-after-every-multiply)."""
    return select_parameters(
        lambda par, enc: noise.estimate_resize_pipeline(
            par, enc, bicubic, plain_fracts=plain_fracts, relin_dbc=relin_dbc
        ),
        t=t, margin_bits=margin_bits,
    )
