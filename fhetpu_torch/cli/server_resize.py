"""Server entry point for encrypted resize (untrusted compute side).

Port of ``fhetpu/cli/server_resize.py`` with the same file protocol:
streams the raster-RGB ciphertext grid from the client file and computes
the resized output in tiles of ``--tile-rows`` output rows (and
``--tile-cols`` columns), each one batched computation on the device.  The
reference's 2/4-row sliding window (fhe_resize.h:324-379) becomes a bounded
window of source rows on the device.  Fractional offsets are encrypted here
under the client's public key, like the reference (fhe_resize.h:230),
unless --plain-fracts multiplies them in as plaintext operands.  Only
public material is read: params.txt, pubkey.npz and, with --relin,
evalkeys.npz (written by either package's client).

    python -m fhetpu_torch.cli.server_resize -i c2s.bin -c s2c.bin --keydir keys

``--device`` defaults to ``cuda``; a CPU run passes ``--device cpu``.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ..bfv import noise
from ..bfv.crypto import Encryptor, PublicKey
from ..bfv.evaluator import DeviceRelinKeys, Evaluator
from ..io import serial
from ..pipelines import resize as rz
from .client_resize import add_resize_flags
from .common import (OpTimer, adopt_stream_params, base_parser, make_encoder,
                     make_params, resolve_device, runtime_noise_check)


class SourceWindow:
    """Source rows [lo, hi) of a raster-RGB ciphertext stream, on the device.

    Tiles ask for row ranges whose bounds never decrease.  Every source row
    is read from the stream exactly once, in order: rows in a gap between
    two tiles' stencils are read and dropped, never skipped (a skip would
    desynchronize every later read) and never uploaded.  The window is one
    buffer ``win_h`` rows high, slid in place, so each row crosses to the
    device once.  With ``on_host`` the window stays in host memory and is
    uploaded whole for every tile (lower peak device memory)."""

    def __init__(self, reader, w: int, L: int, n: int, win_h: int, device,
                 on_host: bool = False):
        self.reader, self.row_shape = reader, (w, 3, 2, L, n)
        self.device, self.on_host = device, on_host
        self.buf = (np.empty((0,) + self.row_shape, np.uint32) if on_host else
                    torch.empty((win_h,) + self.row_shape, dtype=torch.uint32,
                                device=device))
        self.win_h = win_h
        self.lo = 0  # source row held in buf[0]
        self.valid = 0  # buf rows [0, valid) hold source rows [lo, lo + valid)
        self.rows_read = 0

    def advance(self, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) as a tensor [hi - lo, W, 3, 2, L, n] on the device."""
        if lo < self.lo or hi - lo > self.win_h:
            raise ValueError(f"rows [{lo}, {hi}) outside the window's order or height")
        new, first = None, self.rows_read
        if self.rows_read < hi:
            count = (hi - self.rows_read) * self.row_shape[0] * 3
            cts = self.reader.read(count)
            if cts is None or cts.shape[0] != count:
                raise SystemExit(f"ciphertext stream truncated after {self.rows_read} rows")
            new = cts.reshape((-1,) + self.row_shape)[max(lo - first, 0):]
            self.rows_read = hi
        drop = min(max(lo - self.lo, 0), self.valid)
        keep = self.valid - drop
        if self.on_host:
            self.buf = self.buf[drop:] if new is None else np.concatenate([self.buf[drop:], new])
        else:
            for i in range(keep):  # row by row: source and target never overlap
                self.buf[i].copy_(self.buf[drop + i])
            if new is not None and new.shape[0]:
                self.buf[keep:keep + new.shape[0]].copy_(torch.from_numpy(new))
        self.valid = keep + (0 if new is None else new.shape[0])
        self.lo = lo
        if self.valid != hi - lo:
            raise AssertionError((self.valid, lo, hi))
        if self.on_host:
            return torch.from_numpy(self.buf).to(self.device)
        return self.buf[:self.valid]


def load_relin_keys(keydir: str) -> DeviceRelinKeys:
    """evalkeys.npz (k2, k3, ... and digit_bits) of either package's client."""
    path = os.path.join(keydir, "evalkeys.npz")
    if not os.path.exists(path):
        raise SystemExit(f"--relin requires evaluation keys at {path}; run "
                         "client_resize --send --relin (add --dbc for finer digits)")
    with np.load(path) as loaded:
        keys = {int(k[1:]): loaded[k] for k in loaded.files if k.startswith("k")}
        bits = int(loaded["digit_bits"]) if "digit_bits" in loaded.files else 0
    return DeviceRelinKeys(SimpleNamespace(keys=keys, digit_bits=bits))


def tile_rows(row_plan: rz.AxisPlan, h2: int, tile: int) -> list:
    """(y0, y1, lo, hi) per tile: output rows [y0, y1) need source rows
    [lo, hi)."""
    out = []
    for y0 in range(0, h2, tile):
        idx = row_plan.idx[y0:min(y0 + tile, h2)]
        out.append((y0, min(y0 + tile, h2), int(idx.min()), int(idx.max()) + 1))
    return out


def parser():
    p = add_resize_flags(base_parser("Server-side FHE resize (fhetpu_torch)"))
    p.add_argument("--tile-rows", type=int, default=4,
                   help="output rows per tile")
    p.add_argument("--tile-cols", type=int, default=0,
                   help="output columns per tile (0 = all; shrink with "
                        "--tile-rows to bound device memory for the "
                        "unrelinearized ct*ct bicubic path at large n)")
    p.add_argument("--sharded", action="store_true",
                   help="shard source rows over several devices (not ported: "
                        "ROADMAP.md queue 1 item 11)")
    p.add_argument("--host-window", action="store_true",
                   help="keep the source window in host memory and upload it "
                        "for every tile (lower peak device memory)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if args.sharded:
        raise SystemExit("--sharded is not ported yet: row sharding with halo "
                         "exchange over several GPUs is ROADMAP.md queue 1 item 11")
    device = resolve_device(args)

    w, h, _c, pmod = serial.read_params_txt(os.path.join(args.keydir, "params.txt"))
    reader = serial.CtReader(args.cinfile)
    try:
        adopt_stream_params(args, reader, pmod)
        par = make_params(args)
        encoder = make_encoder(args)
        ev = Evaluator(par, encoder, device=device)
        mode = rz.BICUBIC if args.bicubic else rz.BILINEAR
        relin = load_relin_keys(args.keydir) if args.relin and not args.plain_fracts else None
        runtime_noise_check(
            args,
            noise.estimate_resize_pipeline(
                par, encoder, args.bicubic, plain_fracts=args.plain_fracts, mean=True,
                relin_dbc=(relin.digit_bits if relin is not None else None)),
            ("bicubic" if args.bicubic else "bilinear")
            + (" (plain fracts)" if args.plain_fracts
               else (" (encrypted fracts, ct*ct, relin)" if relin is not None
                     else " (encrypted fracts, ct*ct)"))
            + " resize server op",
        )
        encryptor = None
        if not args.plain_fracts:
            pk = PublicKey(data=serial.load_public_key(os.path.join(args.keydir, "pubkey.npz")),
                           params=par)
            encryptor = Encryptor(par, pk)
        size_out = 2 if args.plain_fracts or relin is not None else (
            4 if mode == rz.BILINEAR else 8)
        writer = serial.CtWriter(args.coutfile, size_out, par.L, par.n,
                                 meta={"w": args.width, "h": args.height,
                                       "layout": "raster-rgb"})
        try:
            _run_tiles(args, ev, encryptor, relin, reader, writer, mode, w, h, size_out)
        finally:
            writer.close()
    finally:
        reader.close()


def _run_tiles(args, ev, encryptor, relin, reader, writer, mode, w, h, size_out):
    par = ev.params
    w2, h2 = args.width, args.height
    row_plan = rz.axis_plan(h, h2, mode)
    col_plan = rz.axis_plan(w, w2, mode)
    tiles = tile_rows(row_plan, h2, args.tile_rows)
    window = SourceWindow(reader, w, par.L, par.n, max(hi - lo for _, _, lo, hi in tiles),
                          ev.device, on_host=args.host_window)
    ctile = args.tile_cols if args.tile_cols > 0 else w2
    t = OpTimer("Cubic" if args.bicubic else "Linear")
    interp_per_px = 20 if args.bicubic else 3
    for y0, y1, lo, hi in tiles:
        win = window.advance(lo, hi)
        rp = rz.AxisPlan(idx=row_plan.idx[y0:y1] - lo, fract=row_plan.fract[y0:y1])
        chunks = []
        for x0 in range(0, w2, ctile):
            x1 = min(x0 + ctile, w2)
            cp = rz.AxisPlan(idx=col_plan.idx[x0:x1], fract=col_plan.fract[x0:x1])
            yops, xops = rz.make_fract_bundles(ev, rp, cp, mode, encryptor=encryptor,
                                               relin=relin)
            with t.span((y1 - y0) * (x1 - x0) * interp_per_px):
                out = rz.resize_tile(ev, win, rp, cp, yops, xops, mode,
                                     args.plain_fracts, relin)
                if ev.device.type == "cuda":
                    torch.cuda.synchronize(ev.device)
            chunks.append(out.cpu().numpy())
            del out, yops, xops
        full = chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=1)
        writer.append(full.reshape(-1, size_out, par.L, par.n))
        if args.verbose:
            print(f"rows {y0}..{y1} done (window {lo}..{hi})", file=sys.stderr)
    t.emit()


if __name__ == "__main__":
    main()
