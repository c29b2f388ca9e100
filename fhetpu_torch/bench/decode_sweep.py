"""Decode-pipeline sweep (port of benchmark/decode.py).

Port of ``fhetpu/bench/decode_sweep.py``.  The reference sweeps the
Fourier-step hyperparameters over the encrypted run-length decode pipeline
(benchmark/decode.py:4-12): one --send, then for each (degree, delta) a
server run and a --recieve producing ``out_<degree>_<delta>.png``.  The
client sends run-length pairs, so the server runs the trusted overload, or
with ``--pure-fhe`` the homomorphic Taylor step (the client then also sends
evaluation keys).

As in ``benchmark``, the client halves run in this process
(``client_decode.send_array`` and ``recieve_arrays``; the image is a seeded
48x48 NumPy array unless ``--image`` names a file, which needs PIL), the
server as a subprocess.  The outputs are PNGs where PIL exists, else
``.npy``; every stage's output goes to ``<out>/sweep.log``, each point's
``RMSError,`` row included.

Usage: python -m fhetpu_torch.bench.decode_sweep [--image PATH] [--out DIR]
       [--quick] [--pure-fhe] [--order N] [--cmod N] [--pmod T] [--device cuda]
Exits 1 when a point failed.
"""

from __future__ import annotations

import argparse
import os
import sys

from .benchmark import run, run_here, save_image, server_env, source_image

DEGREE = [8, 16, 32, 48, 64]  # benchmark/decode.py:4
DELTA = [0.1, 0.2, 0.3, 0.4, 0.5]  # benchmark/decode.py:5
IMG_HW = 48  # the reference benchmark's image size


def main(argv=None) -> int:
    from ..cli import client_decode
    from ..cli.common import device_or_exit
    from ..io import images

    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default="",
                    help="source image file (needs PIL); default: seeded noise")
    ap.add_argument("--out", default="./decode_out_torch")
    ap.add_argument("--workdir", default="./decodework_torch")
    ap.add_argument("--quick", action="store_true",
                    help="single (degree, delta) config (smoke)")
    ap.add_argument("--pure-fhe", action="store_true",
                    help="sweep the pure homomorphic Fourier-step path")
    ap.add_argument("--order", type=int, default=64)
    ap.add_argument("--cmod", type=int, default=4096)
    ap.add_argument("--pmod", type=int, default=1 << 14)
    ap.add_argument("--device", default="cuda", help="the server's --device")
    args = ap.parse_args(argv)
    device_or_exit(args.device)
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.workdir, exist_ok=True)
    keydir = os.path.join(args.workdir, "keys")
    c2s = os.path.join(args.workdir, "c2s.bin")
    s2c = os.path.join(args.workdir, "s2c.bin")
    log = os.path.join(args.out, "sweep.log")
    open(log, "w").close()
    img = (images.load_rgb(args.image) if args.image
           else source_image(IMG_HW))

    common = ["--cmod", str(args.cmod), "--pmod", str(args.pmod),
              "--order", str(args.order), "--keydir", keydir]
    sargs = client_decode.parser().parse_args(
        ["--send", "-c", c2s] + common + (["--relin"] if args.pure_fhe else []))
    rc = run_here(f"client_decode.send_array {' '.join(common)}",
                  lambda: client_decode.send_array(sargs, img), log)
    if rc:
        print(f"send FAILED rc={rc}", flush=True)
        return rc

    def recieve(degree, delta):
        rargs = client_decode.parser().parse_args(["--recieve", "-i", s2c] + common)
        pix = client_decode.to_pixels(client_decode.recieve_arrays(rargs))
        print(f"RMSError,{images.rms_error(pix, img):.6g},")
        save_image(os.path.join(args.out, f"out_{degree}_{delta}"), pix)

    grid = [(12, 0.5)] if args.quick else [(dg, dl) for dg in DEGREE for dl in DELTA]
    failed = 0
    for degree, delta in grid:
        print(degree, delta, flush=True)
        srv = [sys.executable, "-m", "fhetpu_torch.cli.server_decode", "-i", c2s, "-c", s2c,
               "--degree", str(degree), "--delta", str(delta), "--device", args.device
               ] + common + (["--pure-fhe"] if args.pure_fhe else [])
        rc = run(srv, log, server_env())
        if rc == 0:
            rc = run_here(f"client_decode.recieve_arrays degree={degree} delta={delta}",
                          lambda: recieve(degree, delta), log)
        if rc:
            failed += 1
            print(f"  FAILED rc={rc}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
