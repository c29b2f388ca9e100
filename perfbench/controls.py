"""The correctness controls: the precision one step below the
configuration's, planted for a run (``control.py``).  The configurations
state exact integer arithmetic on residues below 2^30, products in int64;
one step below is float64, which rounds products above 2^53.

A kind names its control in ``CONTROL``:
* ``reference_in_place``: the plain reference, its products in float64, in
  the place of the program's JPEG op (``server_compute_fn``);
* ``float64_products``: the program's own modular products (``modops.mulmod``
  and ``mulmod_shoup``, the BEHZ steps and multiply_plain) in float64.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench.kinds.common import reference_encoder
from perfbench.reference.jpeg import JpegReference
from perfbench.reference.ring import Ring

BLOCKS = 8


@contextlib.contextmanager
def _patched(targets: list):
    """Set (object, attribute, value) for the enclosed run, then restore."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    try:
        for obj, name, value in targets:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


@contextlib.contextmanager
def reference_in_place(config: dict):
    from fhetpu_torch.pipelines import jpeg_encode

    refs = {}

    def server_compute_fn(ev, *args, **kwargs):
        def fn(cts):
            if cts.device not in refs:
                ring = Ring(config["q_primes"], config["n"], cts.device, mul="float64")
                refs[cts.device] = JpegReference(ring, reference_encoder(config))
            ref = refs[cts.device]
            return torch.cat([ref(cts[b:b + BLOCKS]) for b in range(0, cts.shape[0], BLOCKS)]
                             ).to(torch.uint32)

        return fn

    with _patched([(jpeg_encode, "server_compute_fn", server_compute_fn)]):
        yield


def _mulmod(a, b, p):
    p = p.to(torch.float64) if torch.is_tensor(p) else float(p)
    return torch.remainder(a.to(torch.float64) * b.to(torch.float64), p).to(torch.int64)


@contextlib.contextmanager
def float64_products(config: dict):
    from fhetpu_torch.core import modops

    with _patched([(modops, "mulmod", _mulmod),
                   (modops, "mulmod_shoup", lambda x, w, ws, p: _mulmod(x, w, p))]):
        yield
