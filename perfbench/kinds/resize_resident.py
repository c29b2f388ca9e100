"""The encrypted resize's tiles (``pipelines.resize.resize_tile``) over
source images encrypted once and resident on the card, the fracts prepared
once (``make_fract_bundles``: encrypted under the benchmark's key, or plain
operands); a unit is one image, all of its tiles.  Tiles of ``tile_rows``
output rows, as the server cuts them (``cli.server_resize.tile_rows``)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import controls, roofline
from perfbench.kinds.common import program_encoder, program_params, reference_encoder
from perfbench.reference.bfv import SecretKey
from perfbench.reference.resize import ResizeReference
from perfbench.reference.ring import Ring

CONTROL = controls.float64_products
ENCRYPT_BATCH = 1152  # ciphertexts per batch of the benchmark's encryption
DECRYPT_BATCH = 289


class _Encryptor:
    """The benchmark's key in the role of the client's public key: what
    ``EncryptedFracts`` calls to encrypt the fract plaintexts."""

    def __init__(self, sk: SecretKey, gen: torch.Generator):
        self.sk, self.gen = sk, gen

    def encrypt_batch(self, coeffs: np.ndarray) -> np.ndarray:
        return self.sk.encrypt(np.asarray(coeffs), self.gen).to(torch.uint32).cpu().numpy()


class Cell:
    def __init__(self, ctx):
        from fhetpu_torch.bfv.evaluator import Evaluator
        from fhetpu_torch.cli.server_resize import tile_rows
        from fhetpu_torch.pipelines import resize as rz

        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        if tr["mode"] != "bilinear":
            raise ValueError("the reference resizes bilinear only")
        self.rz, self.mode = rz, rz.BILINEAR
        par = program_params(cfg)
        self.ev = Evaluator(par, program_encoder(cfg), device=ctx.device)
        self.ring = Ring(cfg["q_primes"], cfg["n"], ctx.device)
        self.sk = SecretKey(self.ring, cfg["t"], ctx.gen)
        (h, w), (h2, w2) = tr["src_hw"], tr["dst_hw"]
        self.pixels = ctx.rng.integers(0, 256, (tr["images"], h, w, 3), dtype=np.uint8)
        enc = reference_encoder(cfg)
        self.src = []
        for img in self.pixels:
            plain = np.stack([enc.encode(float(v)) for v in range(256)])[img.reshape(-1)]
            cts = [self.sk.encrypt(plain[b:b + ENCRYPT_BATCH], ctx.gen).to(torch.uint32)
                   for b in range(0, len(plain), ENCRYPT_BATCH)]
            self.src.append(torch.cat(cts).reshape(h, w, 3, 2, par.L, par.n))
        self.plain = tr["fracts"] == "plain"
        row_plan, col_plan = rz.axis_plan(h, h2, self.mode), rz.axis_plan(w, w2, self.mode)
        encryptor = None if self.plain else _Encryptor(self.sk, ctx.gen)
        self.tiles = []
        for y0, y1, lo, hi in tile_rows(row_plan, h2, tr["tile_rows"]):
            rp = rz.AxisPlan(idx=row_plan.idx[y0:y1] - lo, fract=row_plan.fract[y0:y1])
            yops, xops = rz.make_fract_bundles(self.ev, rp, col_plan, self.mode,
                                               encryptor=encryptor)
            self.tiles.append((lo, hi, rp, col_plan, yops, xops))
        self.work = {"images": 1}
        self.bound_s = self._least_bytes(par, h2, w2) / roofline.HBM_BYTES_PER_S

    def _least_bytes(self, par, h2, w2) -> int:
        """Each tile's source ciphertexts and fract operands read once and
        its output written once, 4 bytes a residue."""
        poly = par.L * par.n * 4
        fract_polys = 2 if self.plain else 4  # t and 1 - t, plaintexts or size-2 ciphertexts
        size = 2 if self.plain else 4
        total = h2 * w2 * 3 * size * poly
        for _, _, rp, cp, _, _ in self.tiles:
            total += len(np.unique(rp.idx)) * len(np.unique(cp.idx)) * 3 * 2 * poly
            total += (len(rp.fract) + len(cp.fract)) * fract_polys * poly
        return total

    def unit(self, i: int, keep: bool):
        src = self.src[i % len(self.src)]
        return [self.rz.resize_tile(self.ev, src[lo:hi], rp, cp, yops, xops, self.mode,
                                    self.plain)
                for lo, hi, rp, cp, yops, xops in self.tiles]

    def release(self):
        self.ev = self.tiles = self.src = None

    def check(self, kept: dict) -> tuple:
        tr = self.ctx.traffic
        ref = ResizeReference(reference_encoder(self.ctx.config), tuple(tr["src_hw"]),
                              tuple(tr["dst_hw"]), self.ctx.device)
        bad, failed, margin = 0, 0, 0.0
        for i, outs in kept.items():
            want = ref.plain(self.pixels[i % len(self.pixels)]).reshape(-1, self.ring.n)
            out = torch.cat(outs).reshape((-1,) + outs[0].shape[3:])
            k = 0
            for b in range(0, out.shape[0], DECRYPT_BATCH):
                got, dist = self.sk.decrypt(out[b:b + DECRYPT_BATCH])
                k += int((got != want[b:b + DECRYPT_BATCH]).sum())
                margin = max(margin, dist)
            bad += k
            failed += k > 0
        from perfbench.harness import log

        log(f"decryption: largest distance of t/q x from its rounding {margin:.3g}")
        return [("mismatched_coeffs", bad, 0)], failed
