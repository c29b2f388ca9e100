"""Headline benchmark: encrypted 8x8 channel-blocks per second through the
JPEG server op (RGB->YCC + 8x8 AAN DCT, the reference's hot loop,
server_jpeg.cpp:127-135) at the four reference ring degrees, on the card.

The counterpart of the root ``bench.py``, which drives fhetpu on a TPU.
Baseline (BASELINE.md, benchmark/results.txt:47,41,101,53): single-core
SEAL 2.3 DCT ms per 8x8 channel-block by ring degree.  The printed JSON
line reports n = 4096; the ``--details`` sidecar carries the four-row table
with ``vs_baseline`` per n and per variant.  SEAL's figure includes its own
NTTs and the NTT-free headline's does not (fhetpu's protocol: a client may
stream NTT-form ciphertexts, ``--ntt-form``); the ``with_ntt`` variant's
``vs_baseline`` is the comparison of like work.

Each n runs at t = 2^14 (the SEAL chain) over random residues below each
prime, with a batch of about 1.61 GB of ciphertexts in: nb = 64 at
n = 4096 (the CLI's ``--chunk-blocks``), 256 at 2048, 16 at 8192 and 4 at
16384 (``DEFAULT_NB``).  Variants:

* ``strict_nttfree``: ``server_compute_fn(ev, input_ntt=True,
  output_ntt=True)``, the strict fused kernel alone on NTT-form data;
* ``lazy_nttfree``: the same with ``fused_lazy=True``, the lazy kernel;
  refused at n = 16384, where the primes leave it no headroom (an error
  row, as fhetpu's bench.py records it);
* ``with_ntt``: forward NTT -> strict fused -> inverse NTT on
  coefficient-form data, what ``server_jpeg`` runs on the client's stream.

Each variant is chained in its own domain through ``timing.measure``
``REPEATS`` = 3 times; the per-n headline is the fastest NTT-free variant's
minimum sample (``"headline_estimator": "min"``: interference only slows a
sample).  fhetpu's ``_bench_native28`` rows are not ported
(``BfvParams.create_native`` is on ROADMAP's "Not to port" list).

    python -m fhetpu_torch.bench.headline [--device cuda] [--ns 2048,4096,8192,16384]
        [--blocks NB] [--details bench_details_torch.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..bfv.encoder import FractionalEncoder
from ..bfv.evaluator import Evaluator
from ..bfv.params import BfvParams
from ..core.server_kernel import lazy_bound_multiple
from ..pipelines.jpeg_encode import server_compute_fn
from .timing import measure

# single-core SEAL 2.3 DCT ms per channel-block (benchmark/results.txt)
BASELINE_DCT_MS = {2048: 55.7, 4096: 198.8, 8192: 758.9, 16384: 3084.5}
# blocks per batch: about 1.61 GB of ciphertexts in at every n
# (nb * 3*64 * 2*L*n * 4 bytes; L = 2, 4, 8, 15)
DEFAULT_NB = {2048: 256, 4096: 64, 8192: 16, 16384: 4}
HEADLINE_N = 4096
REPEATS = 3  # samples per variant; the headline takes their minimum
# (label, NTT form in and out, lazy kernel)
VARIANTS = (("strict_nttfree", True, False), ("lazy_nttfree", True, True),
            ("with_ntt", False, False))


def card(device: torch.device) -> str:
    """'name, power limit' of the card as nvidia-smi gives them; on the CPU
    a marker that the numbers are no device metric."""
    if device.type != "cuda":
        return "CPU (plain torch versions; not a device measurement)"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                        f"--id={device.index or 0}"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def random_residues(par: BfvParams, nb: int, device) -> torch.Tensor:
    """uint32 [nb, 3, 64, 2, L, n], limb l uniform below prime l (seeded):
    timing-equivalent to real ciphertexts, in either domain (bench.py:59-64)."""
    gen = torch.Generator(device=device).manual_seed(0)
    p = torch.tensor([int(q) for q in par.q_primes], dtype=torch.int64,
                     device=device).reshape(-1, 1)
    x = torch.empty((nb, 3, 64, 2, par.L, par.n), dtype=torch.uint32, device=device)
    for b in range(nb):  # one block at a time bounds the int64 temporary
        r = torch.randint(0, 1 << 62, (3, 64, 2, par.L, par.n), generator=gen,
                          device=device, dtype=torch.int64)
        x[b] = (r % p).to(torch.uint32)
    return x


def bench_one_n(n: int, nb: int, device: torch.device) -> dict:
    """The per-n row: every variant's samples, the headline variant, its
    channel-blocks/s and vs_baseline."""
    par = BfvParams.create(n=n, t=1 << 14)
    ev = Evaluator(par, FractionalEncoder(par.t, par.n), device=device)
    x = random_residues(par, nb, device)
    row = {"nb": nb, "L": par.L, "bytes_in": x.numel() * 4,
           "baseline_dct_ms_per_channel_block": BASELINE_DCT_MS[n], "variants": {}}
    best = {}
    for label, ntt_form, lazy in VARIANTS:
        fn = server_compute_fn(ev, input_ntt=ntt_form, output_ntt=ntt_form, fused_lazy=lazy)
        try:
            runs = [measure(fn, x, f"n{n}:{label}#{rep}", device) for rep in range(REPEATS)]
        except ValueError as e:
            if not lazy or lazy_bound_multiple(ev):
                raise
            row["variants"][label] = {"error": str(e)}  # refused, as in fhetpu
            print(f"[bench] n={n} {label} refused: {e}", file=sys.stderr)
            continue
        samples = sorted(s for s, _, _ in runs)
        cbs = nb * 3 / samples[0]
        row["variants"][label] = {
            "vs_baseline": cbs / (1000.0 / BASELINE_DCT_MS[n]),
            "ms_per_op_min": samples[0] * 1e3,
            "ms_per_op_median": samples[len(samples) // 2] * 1e3,
            "ms_per_op_samples": [s * 1e3 for s, _, _ in runs],
            "channel_blocks_per_s": cbs,
            "k": [k for _, k, _ in runs],
            "measured_dt_s": [dt for _, _, dt in runs],
        }
        if ntt_form:
            best[label] = cbs
    del x
    if device.type == "cuda":
        torch.cuda.empty_cache()
    label = max(best, key=best.get)
    row.update(headline_variant=label, channel_blocks_per_s=best[label],
               vs_baseline=row["variants"][label]["vs_baseline"])
    return row


def main(argv=None) -> int:
    from ..cli.common import device_or_exit

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--ns", default=",".join(str(n) for n in DEFAULT_NB),
                    help="ring degrees to time")
    ap.add_argument("--blocks", type=int, default=0,
                    help="blocks per batch at every n (default: DEFAULT_NB's)")
    ap.add_argument("--details", default="bench_details_torch.json",
                    help="where to write the per-n table")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    ns = [int(s) for s in args.ns.split(",")]
    where = card(device)
    details = {"device": where, "headline_estimator": "min", "per_n": {}}
    for n in ns:
        details["per_n"][str(n)] = bench_one_n(n, args.blocks or DEFAULT_NB[n], device)
    with open(args.details, "w") as f:
        json.dump(details, f, indent=1)
    for n in ns:
        d = details["per_n"][str(n)]
        print(f"[bench] n={n} nb={d['nb']}: {d['channel_blocks_per_s']:.2f} channel-blocks/s "
              f"({d['vs_baseline']:.2f}x baseline, {d['headline_variant']}; with_ntt "
              f"{d['variants']['with_ntt']['vs_baseline']:.2f}x); {where}", file=sys.stderr)
    n_head = HEADLINE_N if HEADLINE_N in ns else ns[0]
    head = details["per_n"][str(n_head)]
    print(json.dumps({
        "metric": f"encrypted 8x8 channel-blocks/s (FHE YCC+DCT server op, n={n_head}, "
                  f"nb={head['nb']}) on {where}",
        "value": round(head["channel_blocks_per_s"], 2),
        "unit": "channel-blocks/s",
        "vs_baseline": round(head["vs_baseline"], 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
