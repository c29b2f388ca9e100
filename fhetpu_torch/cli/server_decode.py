"""Server entry point for encrypted run-length decode.

Port of ``fhetpu/cli/server_decode.py`` (the reference's server_decode.cpp),
with the same file protocol, in three modes chosen by the stream and flags:

* harmonic streams (``client_decode --send --harmonics``): the expansion of
  each channel's encrypted Fourier harmonics at every output position, on
  the device, with plaintext weights (``rle_decode.serve_harmonics_channel``).
  Reads params.txt only: no secret key and no evaluation keys.
* ``--pure-fhe`` on pair streams: the batched homomorphic Taylor step per
  (value, count) pair on the device, BEHZ ct x ct and relinearization
  (``rle_decode.approximated_step_fhe``); needs ``evalkeys.npz`` from
  ``client_decode --send --relin``.  Its output is right only inside the
  shallow envelope the pipeline documents (degree <= 2, t >= 2^24, about
  10 fractional digits, small amplitudes); outside it a warning is printed.
* the trusted overload, the default on pair streams: like the reference
  server, it reads the client's seckey.npz, decrypts every pair, evaluates
  the Fourier series in doubles and encrypts each channel's sum
  (``rle_decode.fourier_channel_trusted``).  All of it is host work; the
  device does nothing in this mode.

Output: one size-2 ciphertext per position and channel, channel-planar
(``layout: raster-rgb-planar``).

    python -m fhetpu_torch.cli.server_decode -i c2s.bin -c s2c.bin --keydir keys

``--device`` defaults to ``cuda``; a CPU run passes ``--device cpu``.  The
plaintext modulus comes from ``--pmod`` (decode's params.txt holds none).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..bfv import noise
from ..bfv.crypto import Decryptor, Encryptor, PublicKey, SecretKey
from ..bfv.evaluator import Ct, Evaluator
from ..core import modops
from ..io import serial
from ..pipelines import rle_decode as rd
from .client_decode import add_decode_flags, apply_decode_defaults
from .common import (OpTimer, adopt_stream_params, base_parser, load_relin_keys,
                     make_encoder, make_params, maybe_profile, resolve_device,
                     runtime_noise_check)


def parser():
    p = add_decode_flags(base_parser("Server-side FHE RLE decode (fhetpu_torch)"))
    p.add_argument("--pure-fhe", action="store_true",
                   help="pure homomorphic Fourier step on pair streams (needs "
                        "evalkeys.npz); without it a pair stream runs the "
                        "trusted overload, which reads seckey.npz and works on "
                        "the host only, as the reference server does")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args)

    parts = serial.read_params_txt(os.path.join(args.keydir, "params.txt"))
    w, h = parts[0], parts[1]
    npairs = parts[2:5]
    reader = serial.CtReader(args.cinfile)
    try:
        adopt_stream_params(args, reader)  # decode's params.txt carries no pmod
        par = make_params(args)
        encoder = make_encoder(args)
        ev = Evaluator(par, encoder, device=device)
        positions = np.arange(w * h)
        t = OpTimer("Step")
        writer = serial.CtWriter(args.coutfile, 2, par.L, par.n,
                                 meta={"w": w, "h": h, "layout": "raster-rgb-planar"})
        try:
            if reader.meta.get("layout") == "fourier-harmonics":
                _run_harmonics(args, ev, reader, writer, positions, t)
            elif args.pure_fhe:
                _run_pure_fhe(args, ev, reader, writer, positions, npairs, t)
            else:
                _run_trusted(args, ev, reader, writer, positions, npairs, t)
        finally:
            writer.close()
    finally:
        reader.close()
    t.emit()


def _run_harmonics(args, ev, reader, writer, positions, t):
    """Client-side-trig protocol: the stream carries 2*degree+1 encrypted
    harmonics per channel; expansion is multiply_plain and add only."""
    degree, order = int(reader.meta["degree"]), int(reader.meta["order"])
    runtime_noise_check(args, noise.estimate_harmonics_decode(ev.params, ev.encoder, degree),
                        "harmonic-expansion decode server op")
    for flag, wire, name in ((args.degree, degree, "--degree"), (args.order, order, "--order")):
        if flag is not None and flag != wire:
            raise SystemExit(f"{name} {flag} contradicts the harmonic stream "
                             f"({name.strip('-')}={wire}); omit it to adopt the wire's")
    H = 2 * degree + 1
    with maybe_profile(args):
        for ch in range(3):
            cts = reader.read(H)
            if cts is None or cts.shape[0] != H:
                raise SystemExit(f"harmonic stream truncated in channel {ch}")
            harm = Ct(torch.from_numpy(cts).to(ev.device))
            with t.span(len(positions)):
                out = rd.serve_harmonics_channel(ev, harm, positions, order, degree)
                _sync(ev)
            writer.append(out.data.cpu().numpy())
            del harm, out
            if args.verbose:
                print(f"channel {ch}: {H} harmonics", file=sys.stderr)
    _report_peak(ev)


def _run_pure_fhe(args, ev, reader, writer, positions, npairs, t):
    """The batched homomorphic Taylor step per pair, with the encrypted
    prefix sum of the counts as each pair's index."""
    relin = load_relin_keys(args.keydir, "--pure-fhe", "client_decode")
    apply_decode_defaults(args)
    runtime_noise_check(
        args, noise.estimate_taylor_decode(ev.params, ev.encoder, relin_dbc=relin.digit_bits),
        "pure-FHE Taylor decode server op (consider --harmonics on the client: "
        "depth-1, any ring size)")
    # Orthogonal to noise: the fractional encoder's carry-free digits
    # overflow t outside a shallow envelope (pipelines.rle_decode).  Warn,
    # don't refuse: the noise check governs crypto failure, this governs
    # plaintext semantics.
    if args.degree > 2 or args.pmod < (1 << 24):
        print(f"[warn] --pure-fhe at degree={args.degree}, t={args.pmod}: plaintext digit "
              "growth exceeds t/2 outside degree<=2 / t>=2^24 / ~10 fractional digits / "
              "small amplitudes; the decrypted output will wrap (use client --harmonics "
              "for the exact pure-FHE protocol)", file=sys.stderr)
    with maybe_profile(args):
        for ch, k in enumerate(npairs):
            cts = reader.read(2 * k)  # (value, count) interleaved
            if cts is None or cts.shape[0] != 2 * k:
                raise SystemExit(f"pair stream truncated in channel {ch}")
            pairs = torch.from_numpy(cts).to(ev.device)
            counts = [Ct(pairs[2 * i + 1]) for i in range(k)]
            idxs = rd.cumulative_counts(ev, counts)
            chan = None
            for i in range(k):
                with t.span(len(positions)):
                    run = rd.approximated_step_fhe(ev, Ct(pairs[2 * i]), idxs[i], counts[i],
                                                   args.order, args.degree, args.delta,
                                                   positions, relin)
                    _sync(ev)
                chan = run if chan is None else ev.add(chan, run)
                del run
            writer.append(modops.to_u32(ev.transform_from_ntt(chan).data).cpu().numpy())
            del pairs, counts, idxs, chan
            if args.verbose:
                print(f"channel {ch}: {k} pairs", file=sys.stderr)
    _report_peak(ev)


def _run_trusted(args, ev, reader, writer, positions, npairs, t):
    """The reference's trusted overload, batched: decrypt every pair of a
    channel at once, evaluate the channel's Fourier series in vectorized
    doubles and encrypt the channel sum once (value-identical to the
    reference's per-pair re-encrypt and ciphertext adds by linearity).
    Host only."""
    par, encoder = ev.params, ev.encoder
    apply_decode_defaults(args)
    sk = SecretKey(small=serial.load_secret_key(os.path.join(args.keydir, "seckey.npz")),
                   params=par)
    decryptor = Decryptor(par, sk)
    pk = PublicKey(data=serial.load_public_key(os.path.join(args.keydir, "pubkey.npz")),
                   params=par)
    enc = Encryptor(par, pk)
    for ch, k in enumerate(npairs):
        cts = reader.read(2 * k)  # (value, count) interleaved
        if cts is None or cts.shape[0] != 2 * k:
            raise SystemExit(f"pair stream truncated in channel {ch}")
        dv = encoder.decode_batch(decryptor.decrypt_batch(cts))
        with t.span(k * len(positions)):
            vals = rd.fourier_channel_trusted(dv[0::2], dv[1::2], args.order, args.degree,
                                              args.delta, positions)
        writer.append(enc.encrypt_batch(encoder.encode_batch(vals)))
        if args.verbose:
            print(f"channel {ch}: {k} pairs", file=sys.stderr)


def _sync(ev):
    if ev.device.type == "cuda":
        torch.cuda.synchronize(ev.device)


def _report_peak(ev):
    if ev.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(ev.device)
        print(f"peak device memory {peak / 2**30:.3f} GiB", file=sys.stderr)


if __name__ == "__main__":
    main()
