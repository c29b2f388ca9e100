"""Client entry point for encrypted resize (trusted side).

Port of ``fhetpu/cli/client_resize.py``, host only: --send batch-encrypts
every pixel-channel in raster RGB-interleaved order (client_resize.cpp:
147-154) and writes params.txt, the keys and, with --relin, the evaluation
keys; --recieve decrypts W'*H'*3 values, truncates toward zero and clamps
to [0, 255] (client_resize.cpp:201-210), prints the RMS against the
OpenCV-equivalent ground truth and saves a PNG.

The work is in ``send_array`` and ``recieve_arrays``, which take and return
NumPy arrays; ``main`` adds the image files (PIL) around them.

    python -m fhetpu_torch.cli.client_resize --send -f in.png -c c2s.bin
    python -m fhetpu_torch.cli.client_resize --recieve -f in.png -i s2c.bin -o out.png
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..bfv.crypto import Decryptor, Encryptor, KeyGenerator, SecretKey
from ..io import images, serial
from ..pipelines.cv_resize import cv_ground_truth
from .common import (OpTimer, adopt_stream_params, auto_select_n, base_parser,
                     make_encoder, make_params)


def add_resize_flags(p):
    p.add_argument("-b", "--bicubic", action="store_true",
                   help="bicubic instead of bilinear")
    p.add_argument("--width", type=int, default=17)
    p.add_argument("--height", type=int, default=17)
    p.add_argument("--dbc", type=int, default=30,
                   help="relinearization decomposition bit count")
    p.add_argument("--relin", action="store_true",
                   help="relinearize after ct*ct multiplies (the reference "
                        "never does; sizes then grow to 4/8)")
    p.add_argument("--plain-fracts", action="store_true",
                   help="fractional offsets as plaintext operands "
                        "(the same decrypted output, far cheaper)")
    return p


def parser():
    return add_resize_flags(base_parser("Client-side FHE resize (fhetpu_torch)"))


def send_array(args, img: np.ndarray):
    """Encrypt an RGB image uint8 [H, W, 3] into ``args.coutfile``, writing
    params.txt, the keys and, with --relin, evalkeys.npz into
    ``args.keydir``."""
    auto_select_n(args, "resize", bicubic=args.bicubic,
                  plain_fracts=args.plain_fracts,
                  relin_dbc=(args.dbc if args.relin else None))
    par = make_params(args)
    encoder = make_encoder(args)
    h, w, _ = img.shape
    os.makedirs(args.keydir, exist_ok=True)
    serial.write_params_txt(os.path.join(args.keydir, "params.txt"), w, h, 3, args.pmod)
    kg = KeyGenerator(par)
    pk = kg.public_key()
    serial.save_secret_key(os.path.join(args.keydir, "seckey.npz"), kg.secret.small)
    serial.save_public_key(os.path.join(args.keydir, "pubkey.npz"), pk.data)
    if args.relin:
        # with relin after every multiply the largest ciphertext the server
        # keyswitches is size 3, so keys for s^2 suffice
        rk = kg.relin_keys(max_power=2, digit_bits=args.dbc)
        np.savez_compressed(os.path.join(args.keydir, "evalkeys.npz"),
                            digit_bits=np.int64(rk.digit_bits),
                            **{f"k{k}": v for k, v in rk.keys.items()})
    enc = Encryptor(par, pk)
    vals = img.astype(np.float64).reshape(-1)  # raster RGBRGB...
    writer = serial.CtWriter(args.coutfile, 2, par.L, par.n,
                             meta={"w": w, "h": h, "layout": "raster-rgb"})
    t = OpTimer("Encryption")
    chunk = 4096
    try:
        for lo in range(0, len(vals), chunk):
            hi = min(lo + chunk, len(vals))
            coeffs = encoder.encode_batch(vals[lo:hi])
            with t.span(hi - lo):
                cts = enc.encrypt_batch(coeffs)
            writer.append(cts)
    finally:
        writer.close()
    t.emit()
    if args.verbose:
        print(f"encrypted {len(vals)} pixel-channels -> {args.coutfile}",
              file=sys.stderr)


def recieve_arrays(args, keep_plain: bool = False):
    """Decrypt and decode the server's stream ``args.cinfile``.

    Returns ``(vals, plain)``: the decoded values float64 [H', W', 3] and,
    with keep_plain, the decrypted plaintext coefficients int64
    [H', W', 3, n] (else None)."""
    _w, _h, _c, pmod = serial.read_params_txt(os.path.join(args.keydir, "params.txt"))
    reader = serial.CtReader(args.cinfile)
    adopt_stream_params(args, reader, pmod)
    par = make_params(args)
    encoder = make_encoder(args)
    sk = SecretKey(small=serial.load_secret_key(os.path.join(args.keydir, "seckey.npz")),
                   params=par)
    dec = Decryptor(par, sk)
    w2, h2 = args.width, args.height
    total = w2 * h2 * 3
    vals = np.zeros(total, dtype=np.float64)
    plain = np.zeros((total, par.n), dtype=np.int64) if keep_plain else None
    t = OpTimer("Decryption")
    done = 0
    try:
        while done < total:
            cts = reader.read(min(4096, total - done))
            if cts is None:
                break
            with t.span(cts.shape[0]):
                coeffs = dec.decrypt_batch(cts)
            k = coeffs.shape[0]
            vals[done:done + k] = encoder.decode_batch(coeffs)
            if keep_plain:
                plain[done:done + k] = coeffs
            done += k
    finally:
        reader.close()
    if done != total:
        raise ValueError(f"stream holds {done} ciphertexts, expected {total}")
    t.emit()
    return (vals.reshape(h2, w2, 3),
            plain.reshape(h2, w2, 3, par.n) if keep_plain else None)


def to_pixels(vals: np.ndarray) -> np.ndarray:
    """The reference's decode, ``int pixel = encoder.decode(p); CLAMP(pixel,
    0, 255)`` (client_resize.cpp:203-209): C truncation toward zero, not
    rounding; every decrypted value is an exact dyadic rational, so this is
    deterministic."""
    return np.clip(np.trunc(vals), 0, 255).astype(np.uint8)


def run_recieve(args):
    vals, _ = recieve_arrays(args)
    pix = to_pixels(vals)
    gt = cv_ground_truth(images.load_rgb(args.file), args.width, args.height, args.bicubic)
    print(f"RMSError,{images.rms_error(pix, gt):.6g},")
    images.save_rgb(args.outfile, pix)


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if not args.send and not args.recieve:
        p.error("use --send or --recieve")
    if args.send:
        send_array(args, images.load_rgb(args.file))
    else:
        run_recieve(args)


if __name__ == "__main__":
    main()
