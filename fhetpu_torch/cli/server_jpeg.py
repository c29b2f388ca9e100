"""Server driver for the encrypted JPEG pipeline (untrusted compute side).

Port of ``fhetpu/cli/server_jpeg.py`` with the same file protocol: streams
ciphertext blocks from the client file in chunks of ``--chunk-blocks``,
moves each chunk to the device, runs the RGB->YCC + 8x8 DCT server op there
and streams Y/Cb/Cr DCT coefficients back (per block: 64 Y, 64 Cb, 64 Cr).
Only the public parameters are read; the server never sees a secret key.

    python -m fhetpu_torch.cli.server_jpeg -i c2s.bin -c s2c.bin --keydir keys

``--device`` defaults to ``cuda``; a CPU run passes ``--device cpu``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..bfv import noise
from ..bfv.evaluator import Evaluator
from ..codec.jpeg import ZIGZAG, build_quant_tables
from ..io import serial
from ..pipelines.jpeg_encode import server_compute_fn
from .common import (OpTimer, adopt_stream_params, base_parser, make_encoder,
                     make_params, resolve_device, runtime_noise_check)


def main(argv=None):
    p = base_parser("Server-side FHE JPEG (fhetpu_torch)")
    p.add_argument("--quantize", action="store_true",
                   help="apply homomorphic quantization (the reference defines "
                        "but never calls it; default off for parity)")
    args = p.parse_args(argv)
    device = resolve_device(args)

    w, h, _c, pmod = serial.read_params_txt(os.path.join(args.keydir, "params.txt"))
    reader = serial.CtReader(args.cinfile)
    adopt_stream_params(args, reader, pmod)
    par = make_params(args)
    encoder = make_encoder(args)
    ev = Evaluator(par, encoder, device=device)
    runtime_noise_check(
        args, noise.estimate_jpeg_pipeline(par, encoder, mean=True),
        "YCC+DCT server op",
    )
    quant = None
    if args.quantize:
        ytab, _ = build_quant_tables(0)
        quant = ytab[ZIGZAG].astype(np.float64)  # natural-order per-slot table
    in_ntt = bool(reader.meta.get("ntt", False))
    server = server_compute_fn(
        ev, apply_quantize=args.quantize, quant=quant,
        input_ntt=in_ntt, output_ntt=in_ntt,
    )
    writer = serial.CtWriter(args.coutfile, 2, par.L, par.n,
                             meta={"w": w, "h": h, "layout": "ycc-blocks",
                                   "ntt": in_ntt})
    nb_total = (w // 8) * (h // 8)
    t = OpTimer("DCT")
    chunk = max(args.chunk_blocks, 1)
    done = 0
    try:
        while done < nb_total:
            k = min(chunk, nb_total - done)
            cts = reader.read(k * 192)
            if cts is None or cts.shape[0] != k * 192:
                raise SystemExit(f"ciphertext stream truncated after {done} blocks")
            batch = torch.from_numpy(cts.reshape(k, 3, 64, 2, par.L, par.n)).to(device)
            with t.span(k * 3):
                out = server(batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            writer.append(out.cpu().numpy().reshape(-1, 2, par.L, par.n))
            done += k
            if args.verbose:
                print(f"processed {done}/{nb_total} blocks", file=sys.stderr)
    finally:
        reader.close()
        writer.close()
    t.emit()


if __name__ == "__main__":
    main()
