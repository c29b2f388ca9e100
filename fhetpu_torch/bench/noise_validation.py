"""Measured-against-analytic noise validation on the port's device ops.

Port of ``fhetpu/bench/noise_validation.py``.  The analytic tracker
(``bfv/noise.py``) gates every server run; this module backs each gate
decision with a measurement: run the real pipeline computation on tiny
inputs on ``device``, decrypt on the host with the secret key, and take the
exact ``invariant_noise_budget`` of every output ciphertext.  A point is
*conservative* when its mean-case model budget, floored, is at most the
measured minimum budget, and a *gate mismatch* is the dangerous direction:
the model says "run" (budget > 0) but the measured budget is 0.

The seeds (key 11, encryptor 12, images from ``default_rng(3)`` and
``(4)``), ``RELIN_DBC`` and the row schema are fhetpu's, and every op is
residue-equal to fhetpu's, so the measured budgets equal the committed
sweep ``bench_results/noise_validation.json`` that fhetpu measured on a
TPU, point for point.  ``--from-artifact`` re-measures a sweep's points
and exits non-zero on any difference:

    python -m fhetpu_torch.bench.noise_validation \\
        --from-artifact bench_results/noise_validation.json [--device cpu] \\
        [--pipelines jpeg,bilinear_ctct] [--ns 2048]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from ..bfv import noise
from ..bfv.crypto import Decryptor, Encryptor, KeyGenerator
from ..bfv.encoder import FractionalEncoder
from ..bfv.evaluator import Ct, DeviceRelinKeys, Evaluator
from ..bfv.params import BfvParams
from ..pipelines import resize as rz

RELIN_DBC = 16


def _ctx(n: int, t: int, device, seed: int = 11):
    par = BfvParams.create(n=n, t=t)
    kg = KeyGenerator(par, seed=seed)
    enc = Encryptor(par, kg.public_key(), seed=seed + 1)
    dec = Decryptor(par, kg.secret)
    encoder = FractionalEncoder(t, n)
    ev = Evaluator(par, encoder, device=device)
    return par, kg, enc, dec, encoder, ev


def _host(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.int64).cpu().numpy().astype(np.uint32)


def measure_jpeg(n: int, t: int, device):
    """One 8x8 RGB block through the YCC+DCT server op."""
    from ..io import images
    from ..pipelines.jpeg_encode import server_compute_fn

    par, kg, enc, dec, encoder, ev = _ctx(n, t, device)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    blocks = np.stack(
        [images.split_blocks(img[..., c].astype(np.float64)) for c in range(3)],
        axis=1,
    )  # [1, 3, 64]
    cts = enc.encrypt_batch(encoder.encode_batch(blocks).reshape(-1, n))
    cts = cts.reshape(1, 3, 64, 2, par.L, n)
    out = _host(server_compute_fn(ev)(torch.from_numpy(cts).to(ev.device)))
    return int(dec.invariant_noise_budget_batch(out.reshape(-1, 2, par.L, n)).min())


def measure_resize(n: int, t: int, bicubic: bool, plain_fracts: bool, device,
                   relin_dbc=None):
    """6x6 -> 3x3 resize tile in the requested mode."""
    par, kg, enc, dec, encoder, ev = _ctx(n, t, device)
    mode = rz.BICUBIC if bicubic else rz.BILINEAR
    relin = None
    if relin_dbc is not None:
        relin = DeviceRelinKeys(kg.relin_keys(max_power=2, digit_bits=relin_dbc))
    rng = np.random.default_rng(4)
    H = W = 6
    H2 = W2 = 3
    img = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
    cts = enc.encrypt_batch(
        encoder.encode_batch(img.astype(np.float64)).reshape(-1, n)
    ).reshape(H, W, 3, 2, par.L, n)
    rp = rz.axis_plan(H, H2, mode)
    cp = rz.axis_plan(W, W2, mode)
    yops, xops = rz.make_fract_bundles(
        ev, rp, cp, mode, encryptor=None if plain_fracts else enc, relin=relin)
    out = _host(rz.resize_tile(ev, torch.from_numpy(cts).to(ev.device), rp, cp, yops,
                               xops, mode, plain=plain_fracts, relin=relin))
    size = out.shape[3]
    return int(dec.invariant_noise_budget_batch(out.reshape(-1, size, par.L, n)).min())


def measure_harmonics(n: int, t: int, degree: int, device):
    """Harmonic-expansion decode server: multiply_plain by cos-weight
    encodings summed over 2*degree+1 terms (rle_decode depth-0 protocol)."""
    par, kg, enc, dec, encoder, ev = _ctx(n, t, device)
    amp = enc.encrypt(encoder.encode(137.0))
    ct = ev.transform_to_ntt(Ct(torch.from_numpy(amp[None]).to(ev.device), False))
    acc = None
    for j in range(2 * degree + 1):
        w = float(np.cos(0.37 * (j + 1)))
        term = ev.multiply_plain(ct, ev.encode(w))
        acc = term if acc is None else ev.add(acc, term)
    out = _host(ev.transform_from_ntt(acc).data)
    return int(dec.invariant_noise_budget_batch(out).min())


# pipeline -> (measurement, model estimate(params, encoder, mean))
PIPELINES = {
    "jpeg": (measure_jpeg,
             lambda par, enc, mean: noise.estimate_jpeg_pipeline(par, enc, mean=mean)),
    "bilinear_plain": (
        lambda n, t, d: measure_resize(n, t, False, True, d),
        lambda par, enc, mean: noise.estimate_resize_pipeline(
            par, enc, False, plain_fracts=True, mean=mean)),
    "bilinear_ctct": (
        lambda n, t, d: measure_resize(n, t, False, False, d),
        lambda par, enc, mean: noise.estimate_resize_pipeline(
            par, enc, False, plain_fracts=False, mean=mean)),
    "bicubic_plain": (
        lambda n, t, d: measure_resize(n, t, True, True, d),
        lambda par, enc, mean: noise.estimate_resize_pipeline(
            par, enc, True, plain_fracts=True, mean=mean)),
    "bicubic_ctct": (
        lambda n, t, d: measure_resize(n, t, True, False, d),
        lambda par, enc, mean: noise.estimate_resize_pipeline(
            par, enc, True, plain_fracts=False, mean=mean)),
    "bicubic_ctct_relin": (
        lambda n, t, d: measure_resize(n, t, True, False, d, relin_dbc=RELIN_DBC),
        lambda par, enc, mean: noise.estimate_resize_pipeline(
            par, enc, True, plain_fracts=False, mean=mean, relin_dbc=RELIN_DBC)),
    "decode_harmonics48": (
        lambda n, t, d: measure_harmonics(n, t, 48, d),
        lambda par, enc, mean: noise.estimate_harmonics_decode(par, enc, 48, mean=mean)),
}


def model_row(pipeline: str, n: int, t: int, measured: int) -> dict:
    """The row of a point whose budget was measured: the model columns
    (mean- and worst-case estimates, rounded to 0.1 bit, and the gate) and
    the verdict columns."""
    estimate = PIPELINES[pipeline][1]
    par = BfvParams.create(n=n, t=t)
    encoder = FractionalEncoder(t, n)
    est_mean, est_worst = estimate(par, encoder, True), estimate(par, encoder, False)
    return {
        "pipeline": pipeline, "n": n, "t": t, "measured_budget": measured,
        "model_mean_budget": round(est_mean.budget_bits, 1),
        "model_worst_budget": round(est_worst.budget_bits, 1),
        "gate": "run" if not est_mean.exhausted() else "refuse",
        # conservative: the gate's promise never exceeds the measurement.
        # measured_budget is floor(log2(...)), an integer, so the
        # like-for-like comparison floors the UNROUNDED model too.
        "conservative": bool(math.floor(est_mean.budget_bits) <= measured),
        # dangerous direction: gate says run but decryption is garbage
        "gate_mismatch": bool(not est_mean.exhausted() and measured == 0),
    }


def run_point(pipeline: str, n: int, t: int, device="cuda") -> dict:
    """Measure one point on ``device`` and return its row."""
    return model_row(pipeline, n, t, PIPELINES[pipeline][0](n, t, torch.device(device)))


def select(rows, pipelines=None, ns=None) -> list:
    """The artifact rows whose pipeline and n are among those given (None
    keeps every value)."""
    return [r for r in rows if (pipelines is None or r["pipeline"] in pipelines)
            and (ns is None or r["n"] in ns)]


def main(argv=None) -> int:
    from ..cli.common import device_or_exit

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--from-artifact", required=True,
                    help="a committed sweep (JSON list of rows) to re-measure")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--pipelines", default="", help="comma list (default: all)")
    ap.add_argument("--ns", default="", help="comma list of ring degrees (default: all)")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)

    with open(args.from_artifact) as f:
        rows = select(json.load(f), set(args.pipelines.split(",")) if args.pipelines else None,
                      {int(v) for v in args.ns.split(",")} if args.ns else None)
    if not rows:
        raise SystemExit("no artifact point matches the selection")
    differ = 0
    t_all = time.perf_counter()
    for want in rows:
        t0 = time.perf_counter()
        got = run_point(want["pipeline"], want["n"], want["t"], device)
        sec = time.perf_counter() - t0
        same = got["measured_budget"] == want["measured_budget"]
        differ += not same
        print(json.dumps({"pipeline": got["pipeline"], "n": got["n"], "t": got["t"],
                          "measured_budget": got["measured_budget"],
                          "artifact_budget": want["measured_budget"], "equal": same,
                          "gate": got["gate"], "conservative": got["conservative"],
                          "gate_mismatch": got["gate_mismatch"],
                          "seconds": round(sec, 3)}), flush=True)
    print(f"[noise] {len(rows) - differ} of {len(rows)} points equal to "
          f"{args.from_artifact} on {device} in {time.perf_counter() - t_all:.1f} s",
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
