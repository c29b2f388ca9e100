"""Faults planted under the timed path, for the tests that see ``correct``
come out false: a step that returns its input unchanged, half of the batch
left out, and one residue altered where the answer is produced."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def planted(module, name: str, wrap):
    """module.name replaced by wrap(original) for the enclosed run."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _half(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _altered(out: torch.Tensor) -> torch.Tensor:
    """One residue moved by one, staying below its prime."""
    wide = out.to(torch.int64).reshape(-1)
    wide[0] = 1 if int(wide[0]) == 0 else int(wide[0]) - 1
    return wide.to(out.dtype).reshape(out.shape)


def jpeg(fault: str):
    """On the fused YCC+DCT kernel of the JPEG op."""
    from fhetpu_torch.pipelines import jpeg_encode

    def wrap(fused):
        def fn(ev, x, lazy=False):
            if fault == "unchanged":
                return x
            out = fused(ev, x, lazy=lazy)
            return _half(out) if fault == "half" else _altered(out)

        return fn

    return planted(jpeg_encode, "server_ycc_dct_fused", wrap)


def resize(fault: str):
    """On the resize: the interpolation returning its first input, or the
    tile's output rows."""
    from fhetpu_torch.pipelines import resize as rz

    if fault == "unchanged":
        return planted(rz, "linear_interp", lambda f: lambda ev, a, b, fr, plain, relin=None: a)

    def wrap(tile):
        def fn(*args, **kwargs):
            out = tile(*args, **kwargs)
            return _half(out) if fault == "half" else _altered(out)

        return fn

    return planted(rz, "resize_tile", wrap)
