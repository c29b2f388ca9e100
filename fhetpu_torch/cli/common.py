"""Shared CLI plumbing for the client/server drivers: the flag surface of
``fhetpu/cli/common.py`` with ``--device`` in place of ``--platform``.

Mirrors the reference's cxxopts flags (client_jpeg.cpp:31-44):
-r/--recieve -s/--send -v/--verbose -f/--file -c/--coutfile -i/--cinfile
-o/--outfile --ncoeff --fcoeff --cmod --pmod --base (+ pipeline extras).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..bfv.encoder import FractionalEncoder
from ..bfv.params import DEFAULT_PLAIN_MODULUS, DEFAULT_POLY_DEGREE, BfvParams

N_NUMBER_COEFFS = 100  # fhe_image.h:24
N_FRACTIONAL_COEFFS = 100  # fhe_image.h:23
POLY_BASE = 2  # fhe_image.h:22


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("-r", "--recieve", action="store_true",
                   help="client is decrypting results")
    p.add_argument("-s", "--send", action="store_true",
                   help="client is encrypting the raw image")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-f", "--file", default="./image/test.jpg",
                   help="input image filename")
    p.add_argument("-c", "--coutfile", default="./image/nothingpersonnel.txt",
                   help="ciphertext output stream")
    p.add_argument("-i", "--cinfile", default="./image/zoop.txt",
                   help="ciphertext input stream")
    p.add_argument("-o", "--outfile", default="./image/test_out.jpg",
                   help="result image filename")
    p.add_argument("--ncoeff", type=int, default=N_NUMBER_COEFFS)
    p.add_argument("--fcoeff", type=int, default=N_FRACTIONAL_COEFFS)
    p.add_argument("--cmod", type=int, default=None,
                   help="polynomial ring degree n (reference's misnamed flag; "
                        f"default {DEFAULT_POLY_DEGREE}; receiving stages "
                        "self-configure from the stream header)")
    p.add_argument("--pmod", type=int, default=None,
                   help=f"plaintext modulus t (default {DEFAULT_PLAIN_MODULUS})")
    p.add_argument("--base", type=int, default=POLY_BASE,
                   help="fractional encoding base")
    p.add_argument("--keydir", default="./keys", help="key/params directory")
    p.add_argument("--device", default="cuda",
                   help="torch device of the server op (cuda, cuda:N or cpu)")
    p.add_argument("--chunk-blocks", type=int, default=64,
                   help="blocks per device dispatch (streaming window)")
    p.add_argument("--no-noise-check", action="store_true",
                   help="skip the pre-dispatch invariant-noise budget check")
    return p


def resolve_device(args) -> torch.device:
    """The ``--device`` as a torch.device; a CUDA device without a usable
    card is an error, never a silent move to the CPU."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available "
            "(pass --device cpu to run the server op on the CPU)")
    return dev


def _apply_param_defaults(args):
    if args.cmod is None:
        args.cmod = DEFAULT_POLY_DEGREE
    if args.pmod is None:
        args.pmod = DEFAULT_PLAIN_MODULUS


def adopt_stream_params(args, reader=None, pmod=None):
    """Self-configure a receiving stage from the wire instead of flags.

    The ciphertext stream header carries (size, L, n) and the sender's
    params.txt carries t, so servers / --recieve need no --cmod/--pmod at
    all; an explicitly-passed flag that contradicts the wire is a hard
    error."""
    if reader is not None:
        if args.cmod is not None and args.cmod != reader.n:
            raise SystemExit(
                f"--cmod {args.cmod} contradicts the ciphertext stream "
                f"(n={reader.n}); omit --cmod to adopt the stream's"
            )
        args.cmod = reader.n
    if pmod is not None:
        if args.pmod is not None and args.pmod != pmod:
            raise SystemExit(
                f"--pmod {args.pmod} contradicts params.txt (t={pmod}); "
                "omit --pmod to adopt the sender's"
            )
        args.pmod = pmod


def auto_select_n(args, pipeline: str, bicubic: bool = False,
                  plain_fracts: bool = False, relin_dbc=None):
    """When --send omits --cmod, pick the smallest ring degree whose
    worst-case noise estimate survives the pipeline (SEAL 2.3's
    ChooserEvaluator role) instead of a blind default.  The jpeg and resize
    pipelines are ported."""
    if args.cmod is not None:
        return
    if pipeline not in ("jpeg", "resize"):
        raise ValueError(f"no ring-degree chooser for the {pipeline} pipeline")
    if args.pmod is None:
        args.pmod = DEFAULT_PLAIN_MODULUS
    from ..bfv import chooser, noise

    try:
        if pipeline == "jpeg":
            par = chooser.jpeg_parameters(t=args.pmod)
        else:
            par = chooser.resize_parameters(bicubic, t=args.pmod,
                                            plain_fracts=plain_fracts,
                                            relin_dbc=relin_dbc)
    except noise.NoiseExhausted as e:
        raise SystemExit(str(e))
    args.cmod = par.n
    print(f"[chooser] --cmod omitted: selected n={par.n} for the {pipeline}"
          f"{' (bicubic)' if bicubic else ''} pipeline at t={args.pmod}",
          file=sys.stderr)


def make_params(args) -> BfvParams:
    _apply_param_defaults(args)
    return BfvParams.create(n=args.cmod, t=args.pmod)


def make_encoder(args) -> FractionalEncoder:
    _apply_param_defaults(args)
    return FractionalEncoder(
        args.pmod, args.cmod, args.ncoeff, args.fcoeff, args.base
    )


def runtime_noise_check(args, budget, where: str):
    """Refuse to start a server op whose mean-case noise estimate is
    already exhausted; --verbose prints the remaining budget;
    --no-noise-check bypasses."""
    from ..bfv.noise import NoiseExhausted

    if getattr(args, "no_noise_check", False):
        return
    try:
        budget.check(where)
    except NoiseExhausted as e:
        raise SystemExit(f"{e}\n(--no-noise-check runs it anyway)")
    if args.verbose:
        print(f"[noise] {where}: ~{budget.budget_bits:.0f} bits of invariant-"
              "noise budget remain (mean-case estimate)", file=sys.stderr)


class OpTimer:
    """Per-op CSV timing in the reference's stdout schema: prints
    'Label,ms,ms,...,' rows.  Each sample is normalized per unit of work
    (e.g. per coefficient) so the values are comparable with the
    reference's per-op numbers."""

    def __init__(self, label: str):
        self.label = label
        self.samples = []

    def span(self, units: int):
        return _Span(self, units)

    def emit(self):
        print(self.label + "," + ",".join(f"{s:.6g}" for s in self.samples) + ",")


class _Span:
    def __init__(self, timer: OpTimer, units: int):
        self.timer = timer
        self.units = max(units, 1)

    def __enter__(self):
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1000.0 / self.units
        self.timer.samples.append(ms)
