"""The harmonic run-length decode server's step
(``pipelines.rle_decode.serve_harmonics_channel``) over the harmonics of
images encrypted once and resident on the card, the weight tables built in
set-up; a unit is one image, its three channels back to back.

Each image is drawn from the seed as RGB runs (geometric lengths, uniform
8-bit values); the reference's copy of the client's aggregation turns each
channel's runs into 2 * degree + 1 harmonics, encoded by the reference's
encoder and encrypted under the benchmark's key.

While a profiler records, a window's first unit starts with a device pause
of ``EDGE_S`` and its last traced unit ends with one (``torch.cuda._sleep``,
no counted kernel).  The harness's launch check counts the device ops that
overlap its window's host span, which has no margin; a unit opens with a
forward NTT of a few microseconds, and the profiler has placed that first
NTT before the span's start, failing the check.  An untraced run never
pauses."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import controls, roofline
from perfbench.kinds.common import program_encoder, program_params, reference_encoder
from perfbench.reference.bfv import SecretKey
from perfbench.reference.decode import (DecodeReference, channel_harmonics,
                                        run_length_pairs)
from perfbench.reference.ring import Ring

CONTROL = controls.float64_products
DECRYPT_BATCH = 1152
EDGE_S = 0.003


def run_length_image(rng: np.random.Generator, pixels: int, mean_run: float) -> np.ndarray:
    """uint8 [pixels, 3]: runs of one RGB value, lengths geometric with
    mean ``mean_run``, values uniform in 0..255, the last run cut at the
    image's end."""
    ends = np.cumsum(rng.geometric(1.0 / mean_run, size=pixels))
    values = rng.integers(0, 256, (int(np.searchsorted(ends, pixels)) + 1, 3), dtype=np.uint8)
    return values[np.searchsorted(ends, np.arange(pixels), side="right")]


class Cell:
    def __init__(self, ctx):
        from fhetpu_torch.bfv.evaluator import Ct, Evaluator
        from fhetpu_torch.pipelines import rle_decode as rd

        if not hasattr(rd, "serve_harmonics_channel"):
            raise SystemExit("the program has no harmonic decode server step "
                             "(pipelines.rle_decode.serve_harmonics_channel)")
        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        self.rd = rd
        par = program_params(cfg)
        self.ev = Evaluator(par, program_encoder(cfg), device=ctx.device)
        self.ring = Ring(cfg["q_primes"], cfg["n"], ctx.device)
        self.sk = SecretKey(self.ring, cfg["t"], ctx.gen)
        h, w = cfg["image_hw"]
        self.positions = np.arange(h * w)
        self.order, self.degree = cfg["order"], cfg["degree"]
        H = 2 * self.degree + 1
        enc = reference_encoder(cfg)
        self.plain, self.harm = [], []
        for _ in range(tr["images"]):
            img = run_length_image(ctx.rng, h * w, tr["mean_run"])
            harm = [channel_harmonics(run_length_pairs(img[:, c]), self.order, self.degree,
                                      cfg["delta"]) for c in range(3)]
            plain = np.stack([enc.encode(v) for v in np.concatenate(harm)])  # [3 H, n]
            cts = self.sk.encrypt(plain, ctx.gen).to(torch.uint32)
            self.plain.append(plain.reshape(3, H, par.n))
            self.harm.append([Ct(c) for c in cts.reshape(3, H, 2, par.L, par.n)])
        rd.harmonic_weight_tables(self.ev, self.positions, self.order, self.degree)
        self.work = {"images": 1}
        self.bound_s = self._least_bytes(par, H) / roofline.HBM_BYTES_PER_S

    def _least_bytes(self, par, H: int) -> int:
        """The weight tables and the image's harmonics read once and its
        three channels' outputs written once, 4 bytes a residue."""
        poly = par.L * par.n * 4
        P = len(self.positions)
        return H * P * poly + 3 * H * 2 * poly + 3 * P * 2 * poly

    def _pause(self):
        torch.cuda._sleep(int(EDGE_S * (self.ctx.clock_hz or 2e9)))

    def unit(self, i: int, keep: bool):
        edge = self.ctx.cuda and torch.autograd._profiler_enabled()
        if edge and i == 0:
            self._pause()
        out = [self.rd.serve_harmonics_channel(self.ev, harm, self.positions, self.order,
                                               self.degree).data
               for harm in self.harm[i % len(self.harm)]]
        if edge and i == self.ctx.traffic["trace_units"] - 1:
            self._pause()
        return out

    def release(self):
        self.ev = self.harm = None

    def check(self, kept: dict) -> tuple:
        ref = DecodeReference(reference_encoder(self.ctx.config), self.positions, self.order,
                              self.degree, self.ctx.device)
        bad, failed, margin = 0, 0, 0.0
        for i, outs in kept.items():
            k = 0
            for plain, out in zip(self.plain[i % len(self.plain)], outs):
                want = ref.plain(plain)
                for b in range(0, len(want), DECRYPT_BATCH):
                    got, dist = self.sk.decrypt(out[b:b + DECRYPT_BATCH])
                    k += int((got != want[b:b + DECRYPT_BATCH]).sum())
                    margin = max(margin, dist)
            bad += k
            failed += k > 0
        from perfbench.harness import log

        log(f"decryption: largest distance of t/q x from its rounding {margin:.3g}")
        return [("mismatched_coeffs", bad, 0)], failed
