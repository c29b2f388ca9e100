#!/usr/bin/env python3
"""Time fhetpu_torch's fused YCC+DCT kernels on one NVIDIA GPU.

    python3 scripts/torch_server_times.py

Builds the kernels and prints the card's name and power limit, the strict
kernel's launch shape (threads, shared bytes, CTAs per SM, registers,
spills) and its SASS instruction count per thread (cuobjdump -sass, where
the toolkit has it).  Then, at n = 4096 and the CLI's 64-block chunk, checks
the strict kernel against its plain version on two blocks of random
residues and on two blocks with every input at p - 1, and prints CUDA-event
times of the strict fused, lazy fused and DCT-only kernels, taken in turns
(strict, lazy, DCT, DCT, lazy, strict), beside the HBM time of the bytes
they must move (input read once, output written once, at 3.35 TB/s).  Then
the strict kernel alone at n = 2048 (64 blocks), 8192 (16) and 16384 (8).
Exits non-zero without a CUDA device or on a mismatch.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402

SHAPES = ((2048, 64), (8192, 16), (16384, 8))  # (n, blocks) beside n = 4096
STRICT = re.compile(r"server_ycc_dct_(strict_kernel|kernelILi0E)")


def sass_instructions(lib_path: str) -> str:
    """The strict kernel's SASS instruction count, or why there is none."""
    from fhetpu_torch.core import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return "no cuobjdump"
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    count, inside = 0, False
    for line in r.stdout.splitlines():
        if "Function :" in line:
            inside = bool(STRICT.search(line))
        elif inside and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            count += 1
    return f"{count} SASS instructions (static)"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_server_times: no CUDA device is available", file=sys.stderr)
        return 2
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import build, dct_kernel, server_kernel

    build.lib()
    print(smoke.smi("name,power.limit"), flush=True)
    if hasattr(build.lib(), "fhetpu_server_ycc_dct_occupancy"):  # not in older trees
        print(smoke.server_occupancy(), flush=True)
    print(f"strict kernel: {sass_instructions(build.LIB_PATH)}", flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)

    par = BfvParams.create(n=4096)
    ev = Evaluator(par, device=dev)
    st = ev.server_state(dev)
    m = server_kernel.lazy_bound_multiple(ev)
    x = smoke.rand_residues((64, 3, 64, 2), par.q_primes, par.n, gen, dev)
    worst = smoke.worst_residues((2, 3, 64, 2), par.q_primes, par.n, dev)
    for name, xs in (("random", x[:2]), ("p-1", worst)):
        e = smoke.max_abs_err(server_kernel.server_ycc_dct_fused(ev, xs),
                              server_kernel.server_ycc_dct_plain(xs, st))
        smoke.check(e == 0, f"strict kernel vs plain on {name} inputs at n={par.n}: {e}")
    kernels = {
        "strict": lambda: server_kernel.server_ycc_dct_fused(ev, x),
        "lazy": lambda: server_kernel.server_ycc_dct_fused(ev, x, lazy=True),
        "dct": lambda: dct_kernel.dct8x8_kernel(ev, x),
    }
    times = {k: [] for k in kernels}
    for name in ("strict", "lazy", "dct", "dct", "lazy", "strict"):
        times[name].append(smoke.time_ms(kernels[name], 20))
    hbm = 2 * x.numel() * 4 / smoke.HBM_BYTES_PER_S * 1e3
    for name, ts in times.items():
        print(f"n={par.n} nb=64 L={par.L} {name}: {ts[0]:.3f} / {ts[1]:.3f} ms; HBM time "
              f"{hbm:.3f} ms ({100 * hbm / min(ts):.1f} %)", flush=True)
    smoke.check(m > 0, "n=4096 must leave the lazy kernel headroom")
    del x, worst
    torch.cuda.empty_cache()

    for n, nb in SHAPES:
        par = BfvParams.create(n=n)
        ev = Evaluator(par, device=dev)
        st = ev.server_state(dev)
        x = smoke.rand_residues((nb, 3, 64, 2), par.q_primes, n, gen, dev)
        e = smoke.max_abs_err(server_kernel.server_ycc_dct_fused(ev, x[:1]),
                              server_kernel.server_ycc_dct_plain(x[:1], st))
        smoke.check(e == 0, f"strict kernel vs plain at n={n}: {e}")
        t = smoke.time_ms(lambda: server_kernel.server_ycc_dct_fused(ev, x), 20)
        hbm = 2 * x.numel() * 4 / smoke.HBM_BYTES_PER_S * 1e3
        print(f"n={n} nb={nb} L={par.L} strict: {t:.3f} ms; HBM time {hbm:.3f} ms "
              f"({100 * hbm / t:.1f} %)", flush=True)
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
