#!/usr/bin/env python3
"""Time fhetpu_torch's NTT kernels on one NVIDIA GPU at every ring degree.

    python3 scripts/torch_ntt_times.py

Builds the kernels, prints their launch shape (threads, ring bytes, CTAs per
SM, registers, spills), then for n = 4096 and 2048 at the CLI's 64-block
chunk, 8192 at 16 blocks and 16384 at 8 blocks: checks the forward kernel
against its plain version on two blocks and the roundtrip on all of them,
and prints CUDA-event times of both kernels beside the HBM time of the bytes
they must move (input read once, output written once, at 3.35 TB/s).  The
card's name and power limit come first.  Exits non-zero without a CUDA
device or on a mismatch.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402

SHAPES = ((4096, 64), (2048, 64), (8192, 16), (16384, 8))  # (n, blocks)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_ntt_times: no CUDA device is available", file=sys.stderr)
        return 2
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import ntt_kernel

    print(smoke.smi("name,power.limit"), flush=True)
    for line in smoke.ntt_occupancy():
        print(line, flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    for n, nb in SHAPES:
        par = BfvParams.create(n=n)
        dt = ntt_kernel.device_tables(par.tables_q, dev)
        x = smoke.rand_residues((nb, 3, 64, 2), par.q_primes, n, gen, dev)
        xf = ntt_kernel.ntt_forward(x, dt)
        smoke.check(smoke.max_abs_err(xf[:2], ntt_kernel.ntt_plain(x[:2], dt)) == 0,
                    f"forward kernel vs plain at n={n}")
        smoke.check(smoke.max_abs_err(ntt_kernel.ntt_inverse(xf, dt), x) == 0,
                    f"roundtrip at n={n}")
        fwd = smoke.time_ms(lambda: ntt_kernel.ntt_forward(x, dt), 20)
        inv = smoke.time_ms(lambda: ntt_kernel.ntt_inverse(xf, dt), 20)
        hbm = 2 * x.numel() * 4 / smoke.HBM_BYTES_PER_S * 1e3
        print(f"n={n} nb={nb} L={par.L}: forward {fwd:.3f} ms, inverse {inv:.3f} ms; "
              f"HBM time {hbm:.3f} ms ({100 * hbm / fwd:.1f} %, {100 * hbm / inv:.1f} %)",
              flush=True)
        del x, xf
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
