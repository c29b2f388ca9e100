"""Client driver for the encrypted JPEG pipeline (trusted side).

Port of ``fhetpu/cli/client_jpeg.py``, host only: --send encrypts every
8x8-block coefficient of an image and streams them (per block: 64 R, 64 G,
64 B); --recieve decrypts the server's Y/Cb/Cr DCT stream, rounds,
entropy-codes a JFIF file and prints the RMS against the jo_jpeg-equivalent
plaintext baseline, both files decoded by ``codec.jpeg_decode``.  The
secret never leaves the client.

The work is in ``send_array`` and ``recieve_arrays``, which take and return
NumPy arrays; ``main`` adds the image files (PIL) around them, and
``run_recieve`` the JFIF output and the RMS.

    python -m fhetpu_torch.cli.client_jpeg --send -f in.png -c c2s.bin
    python -m fhetpu_torch.cli.client_jpeg --recieve -f in.png -i s2c.bin -o out.jpg
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np

from ..bfv.crypto import Decryptor, Encryptor, KeyGenerator, SecretKey
from ..codec import jpeg as jpeg_codec
from ..codec.jpeg_decode import decode_baseline
from ..core import ntt as nttmod
from ..io import images, serial
from .common import (OpTimer, adopt_stream_params, auto_select_n, base_parser,
                     make_encoder, make_params)


def send_array(args, img: np.ndarray):
    """Encrypt an RGB image uint8 [H, W, 3] into ``args.coutfile``, writing
    params.txt and the keys into ``args.keydir``.  Dimensions that are not
    multiples of 8 are cropped."""
    auto_select_n(args, "jpeg")
    par = make_params(args)
    encoder = make_encoder(args)
    h, w, _ = img.shape
    if h % 8 or w % 8:
        # the reference assumes 8-divisible dims and reads out of bounds
        # otherwise (fhe_image.h:108-124); we crop instead
        h, w = h - h % 8, w - w % 8
        img = img[:h, :w]
        print(f"cropped input to {w}x{h} (multiple of 8)", file=sys.stderr)
    os.makedirs(args.keydir, exist_ok=True)
    serial.write_params_txt(
        os.path.join(args.keydir, "params.txt"), w, h, 3, args.pmod
    )
    kg = KeyGenerator(par)
    pk = kg.public_key()
    serial.save_secret_key(os.path.join(args.keydir, "seckey.npz"), kg.secret.small)
    serial.save_public_key(os.path.join(args.keydir, "pubkey.npz"), pk.data)
    enc = Encryptor(par, pk)

    # [nb, 3, 64] pixel values in the reference's stream order
    blocks = np.stack(
        [images.split_blocks(img[..., c].astype(np.float64)) for c in range(3)],
        axis=1,
    )
    nb = blocks.shape[0]
    ntt_form = bool(getattr(args, "ntt_form", False))
    writer = serial.CtWriter(
        args.coutfile, 2, par.L, par.n,
        meta={"w": w, "h": h, "layout": "rgb-blocks", "ntt": ntt_form},
    )
    t = OpTimer("Encryption")
    chunk = max(args.chunk_blocks, 1)
    try:
        for lo in range(0, nb, chunk):
            hi = min(lo + chunk, nb)
            coeffs = encoder.encode_batch(blocks[lo:hi].reshape(-1))
            with t.span((hi - lo) * 192):
                cts = enc.encrypt_batch(coeffs)
                if ntt_form:
                    cts = nttmod.np_ntt(cts, par.tables_q)
            writer.append(cts)
    finally:
        writer.close()
    t.emit()
    if args.verbose:
        print(f"encrypted {nb} blocks ({nb*192} ciphertexts) -> {args.coutfile}",
              file=sys.stderr)


def recieve_arrays(args, keep_plain: bool = False):
    """Decrypt and decode the server's stream ``args.cinfile``.

    Returns ``(vals, plain)``: the decoded DCT values float64 [nb, 3, 64]
    and, with keep_plain, the decrypted plaintext coefficients int64
    [nb, 3, 64, n] (else None)."""
    w, h, _c, pmod = serial.read_params_txt(os.path.join(args.keydir, "params.txt"))
    reader = serial.CtReader(args.cinfile)
    adopt_stream_params(args, reader, pmod)
    par = make_params(args)
    encoder = make_encoder(args)
    sk = SecretKey(
        small=serial.load_secret_key(os.path.join(args.keydir, "seckey.npz")),
        params=par,
    )
    dec = Decryptor(par, sk)
    in_ntt = bool(reader.meta.get("ntt", False))
    nb = (w // 8) * (h // 8)
    t = OpTimer("Decryption")
    vals = np.zeros(nb * 192, dtype=np.float64)
    plain = np.zeros((nb * 192, par.n), dtype=np.int64) if keep_plain else None
    chunk = max(args.chunk_blocks, 1) * 192
    done = 0
    try:
        while True:
            cts = reader.read(chunk)
            if cts is None:
                break
            with t.span(cts.shape[0]):
                coeffs = dec.decrypt_batch(cts, ntt_form=in_ntt)
            k = coeffs.shape[0]
            vals[done:done + k] = encoder.decode_batch(coeffs)
            if keep_plain:
                plain[done:done + k] = coeffs
            done += k
    finally:
        reader.close()
    if done != nb * 192:
        raise ValueError(f"stream holds {done} ciphertexts, expected {nb * 192}")
    t.emit()
    vals = vals.reshape(nb, 3, 64)
    return vals, (plain.reshape(nb, 3, 64, par.n) if keep_plain else None)


def result_jpeg(vals: np.ndarray, w: int, h: int) -> bytes:
    """The JFIF bytes of the decoded DCT values [nb, 3, 64]: rounded as the
    reference does, v<0 ? ceil(v-.5) : floor(v+.5) (client_jpeg.cpp:278),
    entropy-coded with all-ones quantization tables."""
    out_blocks = np.where(
        vals < 0, np.ceil(vals - 0.5), np.floor(vals + 0.5)
    ).astype(np.int64)
    buf = io.BytesIO()
    jpeg_codec.encode_coeff_blocks(buf, out_blocks, w, h, quality=0)
    return buf.getvalue()


def run_recieve(args, orig: np.ndarray | None = None):
    """Decrypt the server's stream into the JFIF file ``args.outfile`` and
    print the RMS against the jo_jpeg plaintext baseline (fhe_image.h:508-521)
    of ``orig``, uint8 [H, W, 3] (default: the image file ``args.file``).
    Both JFIF files are decoded by ``codec.jpeg_decode``, so no PIL is needed
    when ``orig`` is given."""
    w, h, _c, _pmod = serial.read_params_txt(os.path.join(args.keydir, "params.txt"))
    vals, _ = recieve_arrays(args)
    ours = result_jpeg(vals, w, h)
    with open(args.outfile, "wb") as f:
        f.write(ours)
    if orig is None:
        orig = images.load_rgb(args.file)
    jo = jpeg_codec.jo_jpeg_encode(orig[:h, :w], quality=0)  # crop like --send did
    with open(os.path.join(os.path.dirname(args.outfile) or ".", "jo_image.jpg"), "wb") as f:
        f.write(jo)
    rms = images.rms_error(decode_baseline(ours), decode_baseline(jo))
    print(f"RMSError,{rms:.6g},")


def parser():
    p = base_parser("Client-side FHE JPEG (fhetpu_torch)")
    p.add_argument("--ntt-form", action="store_true",
                   help="stream ciphertexts in the NTT evaluation domain "
                        "(the server op then skips its NTTs)")
    return p


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
