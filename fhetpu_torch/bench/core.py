"""Core-op bench on the card: the NTTs, BEHZ ct x ct, relinearization, the
resize interpolations and the harmonic decode expansion, one number each.

The counterpart of ``scripts/bench_core.py``, which times fhetpu on a TPU;
its sections, labels and fields are kept:

* ``ntt_sweep``: the forward NTT over uint32 [B, L, n] at B = 16, 64, 256,
  1024 (``--sweep``), column ``kernel`` (``csrc/ntt.cu``): us_per_call,
  ntts_per_s and achieved_gb_per_s against the 2*4*B*L*n bytes a
  single-pass transform reads and writes, with the card's 3.35 TB/s beside
  it.  fhetpu's XLA, dispatcher and four-step columns have no counterpart,
  and the plain torch NTT is not timed: it is no yardstick;
* ``ops``: ``ntt_fwd_kernel`` and ``ntt_inv_kernel`` at ``--batch``;
  ``behz_multiply`` (2 x 2 -> 3) and ``relinearize`` (3 -> 2, dbc 16) over
  ``--batch`` ciphertexts; ``linear_plainfract`` and ``cubic_plainfract``
  (12x12 -> 17x17), ``cubic_ctct_relin16`` (8x8 -> 4x4) and
  ``cubic_ctct_faithful`` (8x8 -> 2x2), fhetpu's tile shapes, as ms per
  tile, interps/s and ms per interp; ``harmonics_order16`` and
  ``harmonics_order64`` (degrees 48 and 192) as positions/s.

Every op is chained (its output folded into its next input, so nothing is
skipped and shapes stay fixed) through ``timing.measure`` ``REPEATS`` = 3
times, and reports the minimum (CUDA events on the card).  Data are random
residues below the primes of ``BfvParams.create(n)``, seeded.  The JSON
names the card and its power limit, and counts the NTT kernels' launches
of the run (``ntt_launches``).  With ``--only`` (comma-separated
label substrings) only matching sections run, merged into an existing
``--out`` file.

    python -m fhetpu_torch.bench.core [--device cuda] [--n 4096] [--batch 64]
        [--sweep 16,64,256,1024] [--only a,b] [--out bench_core_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..bfv.crypto import Encryptor, KeyGenerator
from ..bfv.encoder import FractionalEncoder
from ..bfv.evaluator import Ct, DeviceRelinKeys, Evaluator
from ..bfv.params import BfvParams
from ..core import modops, ntt, ntt_kernel
from ..pipelines import resize as rz
from ..pipelines import rle_decode as rd
from .headline import card
from .timing import measure

REPEATS = 3  # samples per op; the minimum is reported
HBM_GB_PER_S = 3350.0  # H100 SXM, NVIDIA's data sheet
SWEEP = (16, 64, 256, 1024)
# label, mode, plain fracts, relin dbc, source side, output side (bench_core.py:296-312)
RESIZE = (("linear_plainfract", rz.BILINEAR, True, None, 12, 17),
          ("cubic_plainfract", rz.BICUBIC, True, None, 12, 17),
          ("cubic_ctct_relin16", rz.BICUBIC, False, 16, 8, 4),
          ("cubic_ctct_faithful", rz.BICUBIC, False, None, 8, 2))
HARMONICS = ((16, 48), (64, 192))  # (order, degree)


def _best(fn, x, label: str, device: torch.device) -> tuple:
    """(seconds per call, k, dt) of the fastest of ``REPEATS`` samples."""
    return min(measure(fn, x, f"{label}#{rep}", device) for rep in range(REPEATS))


class CoreBench:
    """The bench's state for one (n, batch, device): params, evaluator,
    seeded random residues, and the results dict it fills."""

    def __init__(self, n: int, batch: int, device: torch.device):
        self.par = BfvParams.create(n=n, t=1 << 14)
        self.ev = Evaluator(self.par, FractionalEncoder(self.par.t, n), device=device)
        self.n, self.L, self.batch, self.device = n, self.par.L, batch, device
        self.gen = torch.Generator(device=device).manual_seed(0)
        self._kg = None
        self.results = {"n": n, "L": self.L, "batch": batch, "device": card(device),
                        "estimator": f"min of {REPEATS}", "ops": {}, "ntt_sweep": {}}

    @property
    def kg(self) -> KeyGenerator:
        if self._kg is None:
            self._kg = KeyGenerator(self.par, seed=7)
        return self._kg

    def rand(self, prefix) -> torch.Tensor:
        """uint32 [*prefix, L, n], limb l uniform below prime l."""
        p = self.ev.p  # [L, 1] int64
        r = torch.randint(0, 1 << 62, tuple(prefix) + (self.L, self.n), generator=self.gen,
                          device=self.device, dtype=torch.int64)
        return modops.to_u32(r % p)

    def _ntt_entry(self, fn, x, label: str) -> dict:
        sec, k, dt = _best(fn, x, label, self.device)
        polys = x.shape[0] * self.L
        return {"us_per_call": sec * 1e6, "ntts_per_s": polys / sec,
                "achieved_gb_per_s": 2 * 4 * polys * self.n / sec / 1e9,
                "peak_gb_per_s": HBM_GB_PER_S if self.device.type == "cuda" else None,
                "k": k, "dt_s": dt}

    # -- sections ------------------------------------------------------------

    def ntt_sweep(self, batches):
        tables = self.par.tables_q
        for B in batches:
            x = self.rand((B,))
            self.results["ntt_sweep"][str(B)] = {
                "kernel": self._ntt_entry(lambda a: ntt.ntt(a, tables), x, f"ntt_kernel_B{B}"),
            }

    def ntt_ops(self, wanted):
        tables = self.par.tables_q
        x = self.rand((self.batch,))
        for label, fn in (("ntt_fwd_kernel", ntt.ntt), ("ntt_inv_kernel", ntt.intt)):
            if wanted(label):
                self.results["ops"][label] = self._ntt_entry(lambda a: fn(a, tables), x, label)

    def behz_multiply(self):
        a, b = Ct(self.rand((self.batch, 2))), Ct(self.rand((self.batch, 2)))

        def step(acc):  # feed the first two components back: shapes stay fixed
            return modops.to_u32(self.ev.multiply(Ct(acc), b).data[..., :2, :, :])

        sec, k, dt = _best(step, a.data, "behz_multiply", self.device)
        self.results["ops"]["behz_multiply"] = {
            "ms_per_batch": sec * 1e3, "ct_mults_per_s": self.batch / sec, "k": k, "dt_s": dt}

    def relinearize(self):
        rk = DeviceRelinKeys(self.kg.relin_keys(max_power=2, digit_bits=16))
        c3 = self.rand((self.batch, 3))

        def step(acc):
            out = self.ev.relinearize(Ct(acc), rk).data
            return torch.cat([modops.to_u32(out), acc[..., 2:, :, :]], dim=-3)

        sec, k, dt = _best(step, c3, "relinearize", self.device)
        self.results["ops"]["relinearize"] = {
            "ms_per_batch": sec * 1e3, "relins_per_s": self.batch / sec, "dbc": 16,
            "k": k, "dt_s": dt}

    def resize(self, label, mode, plain, dbc, hs, h2):
        ev = self.ev
        rp, cp = rz.axis_plan(hs, h2, mode), rz.axis_plan(hs, h2, mode)
        relin = None if dbc is None else DeviceRelinKeys(
            self.kg.relin_keys(max_power=2, digit_bits=dbc))
        enc = None if plain else Encryptor(self.par, self.kg.public_key(), seed=8)
        yops, xops = rz.make_fract_bundles(ev, rp, cp, mode, encryptor=enc, relin=relin)
        interps = h2 * h2 * (20 if mode == rz.BICUBIC else 3)

        def step(w):  # fold one output pixel back into the window
            out = rz.resize_tile(ev, w, rp, cp, yops, xops, mode, plain, relin)
            fold = modops.to_i64(out[0, 0, :, :2])[None, None]
            return modops.to_u32(modops.addmod(modops.to_i64(w), fold, ev.p))

        sec, k, dt = _best(step, self.rand((hs, hs, 3, 2)), label, self.device)
        self.results["ops"][label] = {
            "ms_per_tile": sec * 1e3, "out_px": h2 * h2, "interps_per_s": interps / sec,
            "ms_per_interp": sec * 1e3 / interps, "k": k, "dt_s": dt}

    def harmonics(self, order, degree):
        ev = self.ev
        positions = np.arange(order, dtype=np.float64)
        rd.harmonic_weight_tables(ev, positions, order, degree)  # build the cached tables
        hn = ntt.ntt(self.rand((2 * degree + 1, 2)), self.par.tables_q)

        def step(h):  # expand every position, fold position 0 back into h
            out = rd.expand_harmonics_batched(ev, Ct(h, True), positions, order, degree).data
            fold = modops.to_i64(out[0][None])
            return modops.to_u32(modops.addmod(modops.to_i64(h), fold, ev.p))

        label = f"harmonics_order{order}"
        sec, k, dt = _best(step, hn, label, self.device)
        self.results["ops"][label] = {
            "degree": degree, "positions": order, "ms_per_channel_expand": sec * 1e3,
            "positions_per_s": order / sec, "k": k, "dt_s": dt}


def run(bench: CoreBench, sweep, only: str = "") -> dict:
    """Every section whose label matches ``only`` (all when empty)."""
    def wanted(label: str) -> bool:
        return not only or any(s and s in label for s in only.split(","))

    if wanted("ntt_sweep"):
        bench.ntt_sweep(sweep)
    bench.ntt_ops(wanted)
    if wanted("behz_multiply"):
        bench.behz_multiply()
    if wanted("relinearize"):
        bench.relinearize()
    for label, *spec in RESIZE:
        if wanted(label):
            bench.resize(label, *spec)
    for order, degree in HARMONICS:
        if wanted(f"harmonics_order{order}"):
            bench.harmonics(order, degree)
    # the NTT kernels' launches in this run, warm-up calls included (0 on the CPU)
    bench.results["ntt_launches"] = {"forward": ntt_kernel.ntt_forward.launches,
                                     "inverse": ntt_kernel.ntt_inverse.launches}
    return bench.results


def main(argv=None) -> int:
    from ..cli.common import device_or_exit

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sweep", default=",".join(str(b) for b in SWEEP),
                    help="batches of the NTT sweep")
    ap.add_argument("--only", default="",
                    help="comma-separated label substrings: run only matching sections and "
                         "merge them into an existing --out file")
    ap.add_argument("--out", default="bench_core_torch.json")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    sweep = [int(b) for b in args.sweep.split(",")]
    results = run(CoreBench(args.n, args.batch, device), sweep, args.only)
    if args.only and os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
        prior["ops"].update(results["ops"])
        prior["ntt_sweep"].update(results["ntt_sweep"])
        prior["ntt_launches"] = results["ntt_launches"]
        results = prior
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["ops"], indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
