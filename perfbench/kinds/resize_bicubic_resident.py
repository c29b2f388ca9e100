"""The encrypted bicubic resize's tiles (``pipelines.resize.resize_tile``
with ``BICUBIC``) over source images encrypted once and resident on the
card; each tile's fracts t, t^2 and t^3 encrypted under the benchmark's key
and raised once (``make_fract_bundles``); every ct x ct product
unrelinearized, so the outputs are of size 8.  A unit is one image, all of
its tiles back to back with no host sync.  Tiles of ``tile_rows`` output
rows, as the server cuts them (``cli.server_resize.tile_rows``)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import controls, roofline
from perfbench.kinds import resize_resident
from perfbench.kinds.common import program_encoder, program_params, reference_encoder
from perfbench.reference.bfv import SecretKey
from perfbench.reference.resize_cubic import CubicResizeReference
from perfbench.reference.ring import Ring

CONTROL = controls.float64_products
OUT_SIZE = 8  # (2 + 4 - 1) + 4 - 1: a size-5 row result times t^3
FRACT_POLYS = 2 + 3 + 4  # the fract ciphertexts t, t^2, t^3


class Cell(resize_resident.Cell):
    def __init__(self, ctx):
        from fhetpu_torch.bfv.evaluator import Evaluator
        from fhetpu_torch.cli.server_resize import tile_rows
        from fhetpu_torch.pipelines import resize as rz

        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        if tr["mode"] != "bicubic" or tr["fracts"] != "encrypted" or cfg["relinearize"]:
            raise ValueError("this kind resizes bicubic with encrypted fracts, unrelinearized")
        self.rz, self.mode, self.plain = rz, rz.BICUBIC, False
        par = program_params(cfg)
        self.ev = Evaluator(par, program_encoder(cfg), device=ctx.device)
        self.ring = Ring(cfg["q_primes"], cfg["n"], ctx.device)
        self.sk = SecretKey(self.ring, cfg["t"], ctx.gen)
        (h, w), (h2, w2) = tr["src_hw"], tr["dst_hw"]
        self.pixels = ctx.rng.integers(0, 256, (tr["images"], h, w, 3), dtype=np.uint8)
        enc = reference_encoder(cfg)
        table = np.stack([enc.encode(float(v)) for v in range(256)])
        self.src = []
        for img in self.pixels:
            plain = table[img.reshape(-1)]
            cts = [self.sk.encrypt(plain[b:b + resize_resident.ENCRYPT_BATCH], ctx.gen)
                   .to(torch.uint32)
                   for b in range(0, len(plain), resize_resident.ENCRYPT_BATCH)]
            self.src.append(torch.cat(cts).reshape(h, w, 3, 2, par.L, par.n))
        row_plan, col_plan = rz.axis_plan(h, h2, self.mode), rz.axis_plan(w, w2, self.mode)
        encryptor = resize_resident._Encryptor(self.sk, ctx.gen)
        self.tiles = []
        for y0, y1, lo, hi in tile_rows(row_plan, h2, tr["tile_rows"]):
            rp = rz.AxisPlan(idx=row_plan.idx[y0:y1] - lo, fract=row_plan.fract[y0:y1])
            yops, xops = rz.make_fract_bundles(self.ev, rp, col_plan, self.mode,
                                               encryptor=encryptor)
            self.tiles.append((lo, hi, rp, col_plan, yops, xops))
        self.work = {"images": 1}
        self.bound_s = self._least_bytes(par, h2, w2) / roofline.HBM_BYTES_PER_S

    def _least_bytes(self, par, h2, w2) -> int:
        """Each tile's distinct source ciphertexts and its fract ciphertexts
        t, t^2, t^3 read once, and the image's size-8 outputs written once,
        4 bytes a residue."""
        poly = par.L * par.n * 4
        total = h2 * w2 * 3 * OUT_SIZE * poly
        for _, _, rp, cp, _, _ in self.tiles:
            total += len(np.unique(rp.idx)) * len(np.unique(cp.idx)) * 3 * 2 * poly
            total += (len(rp.fract) + len(cp.fract)) * FRACT_POLYS * poly
        return total

    def check(self, kept: dict) -> tuple:
        tr = self.ctx.traffic
        ref = CubicResizeReference(reference_encoder(self.ctx.config), tuple(tr["src_hw"]),
                                   tuple(tr["dst_hw"]), self.ctx.device)
        bad, failed, margin, wants = 0, 0, 0.0, {}
        for i, outs in kept.items():
            img = i % len(self.pixels)
            if img not in wants:
                wants[img] = ref.plain(self.pixels[img]).reshape(-1, self.ring.n)
            want = wants[img]
            out = torch.cat(outs).reshape((-1,) + outs[0].shape[3:])
            k = 0
            for b in range(0, out.shape[0], resize_resident.DECRYPT_BATCH):
                got, dist = self.sk.decrypt(out[b:b + resize_resident.DECRYPT_BATCH])
                k += int((got != want[b:b + resize_resident.DECRYPT_BATCH]).sum())
                margin = max(margin, dist)
            bad += k
            failed += k > 0
        from perfbench.harness import log

        log(f"decryption: largest distance of t/q x from its rounding {margin:.3g}")
        return [("mismatched_coeffs", bad, 0)], failed
