"""Shared CLI plumbing for the client/server drivers: the flag surface of
``fhetpu/cli/common.py``, with ``--device`` choosing the torch device.
fhetpu's ``--platform cpu`` means ``--device cpu``; its other platforms are
JAX backends and are refused.  ``--profile-dir`` writes a ``torch.profiler``
trace of the server op.

Mirrors the reference's cxxopts flags (client_jpeg.cpp:31-44):
-r/--recieve -s/--send -v/--verbose -f/--file -c/--coutfile -i/--cinfile
-o/--outfile --ncoeff --fcoeff --cmod --pmod --base (+ pipeline extras).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
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
    p.add_argument("--platform", default="",
                   help="fhetpu's flag: 'cpu' means --device cpu; other values "
                        "are JAX backends and are refused (use --device)")
    p.add_argument("--profile-dir", default="",
                   help="write a torch.profiler trace of the server op to this "
                        "directory (Chrome trace JSON), with the program's spans "
                        "(fhetpu_torch/trace.py; PERF.md lists them)")
    p.add_argument("--chunk-blocks", type=int, default=64,
                   help="blocks per device dispatch (streaming window)")
    p.add_argument("--no-noise-check", action="store_true",
                   help="skip the pre-dispatch invariant-noise budget check")
    return p


def resolve_device(args) -> torch.device:
    """The ``--device`` as a torch.device; a CUDA device without a usable
    card is an error, never a silent move to the CPU.  ``--platform cpu``
    sets ``--device cpu``; any other ``--platform`` is refused."""
    if args.platform:
        if args.platform != "cpu":
            raise SystemExit(f"--platform {args.platform} names a JAX backend; "
                             "this server runs on torch devices: pass --device "
                             "(cuda, cuda:N or cpu)")
        args.device = "cpu"
    return device_or_exit(args.device)


def device_or_exit(name: str) -> torch.device:
    """``name`` as a torch.device; exits at once when it names CUDA and no
    card is usable."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return dev


@contextlib.contextmanager
def maybe_profile(args):
    """Context manager: a ``torch.profiler`` trace of the enclosed server op,
    written on exit as ``trace-<pid>.json`` into ``--profile-dir``; a no-op
    without the flag.  While it records, the program's spans
    (``fhetpu_torch/trace.py``, listed in PERF.md's span table) appear in the
    trace around the kernels they launched."""
    if not args.profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(args.profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(args.profile_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"[profile] server op trace written to {path}", file=sys.stderr)


def load_relin_keys(keydir: str, flag: str, client: str):
    """evalkeys.npz (k2, k3, ... and digit_bits) of either package's client,
    as ``DeviceRelinKeys``; exits naming ``flag`` and the client that writes
    them when the file is missing."""
    from types import SimpleNamespace

    from ..bfv.evaluator import DeviceRelinKeys

    path = os.path.join(keydir, "evalkeys.npz")
    if not os.path.exists(path):
        raise SystemExit(f"{flag} requires evaluation keys at {path}; run "
                         f"{client} --send --relin (add --dbc for finer digits)")
    with np.load(path) as loaded:
        keys = {int(k[1:]): loaded[k] for k in loaded.files if k.startswith("k")}
        bits = int(loaded["digit_bits"]) if "digit_bits" in loaded.files else 0
    return DeviceRelinKeys(SimpleNamespace(keys=keys, digit_bits=bits))


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
                  plain_fracts: bool = False, degree: int = 12,
                  relin_dbc=None):
    """When --send omits --cmod, pick the smallest ring degree whose
    worst-case noise estimate survives the pipeline (SEAL 2.3's
    ChooserEvaluator role) instead of a blind default: the jpeg, resize and
    decode-harmonics pipelines."""
    if args.cmod is not None:
        return
    if pipeline not in ("jpeg", "resize", "decode-harmonics"):
        raise ValueError(f"no ring-degree chooser for the {pipeline} pipeline")
    if args.pmod is None:
        args.pmod = DEFAULT_PLAIN_MODULUS
    from ..bfv import chooser, noise

    try:
        if pipeline == "jpeg":
            par = chooser.jpeg_parameters(t=args.pmod)
        elif pipeline == "resize":
            par = chooser.resize_parameters(bicubic, t=args.pmod,
                                            plain_fracts=plain_fracts,
                                            relin_dbc=relin_dbc)
        else:
            par = chooser.harmonics_decode_parameters(degree, t=args.pmod)
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
