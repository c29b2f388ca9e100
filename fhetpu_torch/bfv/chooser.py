"""Ring-degree choice for the JPEG pipeline: the ``jpeg_parameters`` part of
``fhetpu/bfv/chooser.py``.  Simulates the pipeline's noise growth with the
analytic tracker and picks the smallest ring degree whose default modulus
chain leaves a safety margin."""

from __future__ import annotations

from . import noise
from .encoder import FractionalEncoder
from .params import BfvParams

SUPPORTED_N = (1024, 2048, 4096, 8192, 16384, 32768)


def jpeg_parameters(t: int = 1 << 14, margin_bits: float = 10.0) -> BfvParams:
    """Smallest-n BfvParams whose estimated YCC+DCT budget exceeds margin,
    for the default 100 + 100 coefficient fractional encoder."""
    for n in SUPPORTED_N:
        if n < 200:
            continue
        par = BfvParams.create(n=n, t=t)
        enc = FractionalEncoder(t, n)
        budget = noise.estimate_jpeg_pipeline(par, enc)
        if budget.budget_bits >= margin_bits:
            return par
    raise noise.NoiseExhausted(
        f"no supported ring degree sustains this pipeline at t={t}"
    )
