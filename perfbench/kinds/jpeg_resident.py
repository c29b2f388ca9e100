"""The JPEG server op (``server_compute_fn``, the CLI's op: coefficient form
in and out, the forward NTT, the strict fused YCC+DCT kernel, the inverse
NTT) on chunks of random residues resident on the card, fed round-robin with
no host sync; a unit is one chunk."""

from __future__ import annotations

import torch

from perfbench import controls, roofline
from perfbench.kinds.common import program_encoder, program_params, reference_encoder
from perfbench.reference.jpeg import JpegReference
from perfbench.reference.ring import Ring

CONTROL = controls.reference_in_place
REF_BLOCKS = 8  # blocks per batch of the reference


def random_residues(shape: tuple, primes, gen: torch.Generator) -> torch.Tensor:
    """uint32 residues [*shape, L, n] below each limb's prime."""
    p = torch.tensor(primes, dtype=torch.int64, device=gen.device).reshape(-1, 1)
    x = torch.randint(0, 1 << 62, shape, generator=gen, device=gen.device, dtype=torch.int64)
    return (x % p).to(torch.uint32)


class Cell:
    def __init__(self, ctx):
        from fhetpu_torch.bfv.evaluator import Evaluator
        from fhetpu_torch.pipelines import jpeg_encode

        self.ctx, cfg, tr = ctx, ctx.config, ctx.traffic
        par = program_params(cfg)
        self.ev = Evaluator(par, program_encoder(cfg), device=ctx.device)
        self.op = jpeg_encode.server_compute_fn(self.ev)
        nb, L, n = tr["blocks"], par.L, par.n
        self.chunks = [random_residues((nb, 3, 64, 2, L, n), cfg["q_primes"], ctx.gen)
                       for _ in range(tr["chunks"])]
        self.work = {"channel_blocks": nb * 3}
        self.bound_s = None
        if ctx.sms:
            polys = nb * 3 * 64 * 2 * L
            ops = (roofline.ntt_ops("ntt_forward", polys, n)
                   + roofline.ntt_ops("ntt_inverse", polys, n)
                   + roofline.ycc_dct_ops(nb, L, n, roofline.lazy_multiple(cfg["q_primes"])))
            self.bound_s = roofline.bound_s(2 * self.chunks[0].numel() * 4, ops, ctx.sms,
                                            ctx.clock_hz)

    def unit(self, i: int, keep: bool):
        return self.op(self.chunks[i % len(self.chunks)])

    def release(self):
        self.ev = self.op = None

    def check(self, kept: dict) -> tuple:
        cfg = self.ctx.config
        ref = JpegReference(Ring(cfg["q_primes"], cfg["n"], self.ctx.device),
                            reference_encoder(cfg))
        bad, failed = 0, 0
        for i, out in kept.items():
            x, k = self.chunks[i % len(self.chunks)], 0
            for b in range(0, x.shape[0], REF_BLOCKS):
                want = ref(x[b:b + REF_BLOCKS])
                k += int((out[b:b + REF_BLOCKS].to(torch.int64) != want).sum())
            bad += k
            failed += k > 0
        return [("mismatched_residues", bad, 0)], failed
