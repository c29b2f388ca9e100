"""fhetpu_torch's own copies of fhetpu's JAX-free modules against the
originals: prime chains, fractional encoder, golden oracle, block
utilities, JPEG codec bytes (the client's and the jpge-equivalent
encoder's), the native host NTT, the resize client's OpenCV ground truth,
the BEHZ tables, the noise estimates, the ring-degree chooser, the
plaintext reference DCT and the text image format.  The port imports none
of the originals (tests/test_torch_cli.py::test_package_imports_without_jax),
so each copy is held equal to its original here.  Every comparison is
exact; inputs come from np.random.default_rng."""

import ctypes
import io
import os

import numpy as np
import pytest

from fhetpu import native as f_native
from fhetpu.bfv import chooser as f_chooser
from fhetpu.bfv import encoder as f_encoder
from fhetpu.bfv import golden as f_golden
from fhetpu.bfv import noise as f_noise
from fhetpu.bfv import rns as f_rns
from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.codec import dct_ref as f_dct_ref
from fhetpu.codec import jpeg as f_jpeg
from fhetpu.core import ntt as f_ntt
from fhetpu.core import primes as f_primes
from fhetpu.io import images as f_images
from fhetpu.io import textimage as f_textimage
from fhetpu.pipelines import cv_resize as f_cv_resize

import fhetpu_torch
from fhetpu_torch import native
from fhetpu_torch.bfv import chooser, encoder, golden, noise, rns
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.codec import dct_ref, jpeg
from fhetpu_torch.core import ntt, primes
from fhetpu_torch.io import images, textimage
from fhetpu_torch.pipelines import cv_resize
from fhetpu_torch.pipelines import jpeg_encode as pipe

N, T = 2048, 1 << 14
DEGREES = (2048, 4096, 8192, 16384)


def _primes(rng):
    for n in DEGREES:
        assert primes.default_coeff_modulus_128(n) == f_primes.default_coeff_modulus_128(n)
        assert primes.native_coeff_modulus_128(n) == f_primes.native_coeff_modulus_128(n)
        assert primes.default_aux_modulus(n) == f_primes.default_aux_modulus(n)
    for bits in (27, 29, 30):
        assert primes.gen_ntt_primes(bits, 3) == f_primes.gen_ntt_primes(bits, 3)
    for v in rng.integers(0, 1 << 40, size=200).tolist() + list(range(1000)):
        assert primes.is_prime(v) == f_primes.is_prime(v), v


def _encoder(rng):
    ours, ref = encoder.FractionalEncoder(T, N), f_encoder.FractionalEncoder(T, N)
    vals = rng.uniform(-300.0, 300.0, size=(5, 7))
    got = ours.encode_batch(vals)
    assert np.array_equal(got, ref.encode_batch(vals))
    coeffs = rng.integers(0, T, size=(6, N), dtype=np.int64)
    assert np.array_equal(ours.decode_batch(coeffs), ref.decode_batch(coeffs))
    for v in (0.0, -0.168736, 128.0, float(vals[0, 0])):
        assert ours.encode(v).coeffs.tolist() == ref.encode(v).coeffs.tolist()
        assert ours.decode(ours.encode(v)) == ref.decode(ref.encode(v))


def _golden(rng):
    """Both oracles through the JPEG network: YCC, DCT, quantize."""
    enc = encoder.FractionalEncoder(T, N)
    img = rng.integers(0, 256, size=(8, 8, 3)).astype(np.float64)
    coeffs = enc.encode_batch(np.stack([images.split_blocks(img[..., c]) for c in range(3)], 1))
    quant = jpeg.build_quant_tables(50)[0][jpeg.ZIGZAG].astype(np.float64)
    outs = []
    for gev in (golden.GoldenEvaluator(enc), f_golden.GoldenEvaluator(enc)):
        ycc = pipe.rgb_to_ycc(gev, coeffs[:, 0], coeffs[:, 1], coeffs[:, 2])
        outs.append([pipe.quantize(gev, pipe.dct8x8(gev, [ch[:, k] for k in range(64)]), quant)
                     for ch in ycc])
    assert np.array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
    a, b = coeffs[0, 0, :2], coeffs[0, 1, :2]
    assert np.array_equal(golden.mult(a, b, T), f_golden.mult(a, b, T))


def _images(rng):
    chan = rng.uniform(0, 255, size=(16, 24))
    assert np.array_equal(images.split_blocks(chan), f_images.split_blocks(chan))
    a, b = (rng.integers(0, 256, size=(16, 24, 3), dtype=np.uint8) for _ in range(2))
    assert images.rms_error(a, b) == f_images.rms_error(a, b)


def _jpeg(rng):
    assert np.array_equal(jpeg.ZIGZAG, f_jpeg.ZIGZAG)
    for q in (0, 50):
        for got, want in zip(jpeg.build_quant_tables(q), f_jpeg.build_quant_tables(q)):
            assert np.array_equal(got, want)
    blocks = rng.integers(-500, 500, size=(2, 3, 64))
    ours, ref = io.BytesIO(), io.BytesIO()
    jpeg.encode_coeff_blocks(ours, blocks, 16, 8, quality=0)
    f_jpeg.encode_coeff_blocks(ref, blocks, 16, 8, quality=0)
    assert ours.getvalue() == ref.getvalue()
    img = rng.integers(0, 256, size=(8, 16, 3), dtype=np.uint8)
    assert jpeg.jo_jpeg_encode(img, quality=0) == f_jpeg.jo_jpeg_encode(img, quality=0)


def _jpge(rng):
    """The jpge-equivalent encoder, byte for byte, in its four subsampling
    modes at two qualities, with and without chroma discrimination, on
    RGB sizes that need edge replication and on grayscale."""
    assert (jpeg.Y_ONLY, jpeg.H1V1, jpeg.H2V1, jpeg.H2V2) == \
        (f_jpeg.Y_ONLY, f_jpeg.H1V1, f_jpeg.H2V1, f_jpeg.H2V2)
    rgb = rng.integers(0, 256, size=(13, 21, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, size=(10, 9), dtype=np.uint8)
    for quality in (25, 90):
        for discrim in (False, True):
            tabs = jpeg._ijg_quant_tables(quality, discrim)
            for got, want in zip(tabs, f_jpeg._ijg_quant_tables(quality, discrim)):
                assert np.array_equal(got, want)
            assert np.array_equal(jpeg._fdtbl(tabs[1]), f_jpeg._fdtbl(tabs[1]))
            for mode in (jpeg.Y_ONLY, jpeg.H1V1, jpeg.H2V1, jpeg.H2V2):
                kw = dict(quality=quality, subsampling=mode, no_chroma_discrim=discrim)
                assert jpeg.jpge_encode(rgb, **kw) == f_jpeg.jpge_encode(rgb, **kw), kw
            kw = dict(quality=quality, subsampling=jpeg.H2V2, no_chroma_discrim=discrim)
            assert jpeg.jpge_encode(gray, **kw) == f_jpeg.jpge_encode(gray, **kw)


def _dct_ref(rng):
    """The plaintext double AAN DCT, one block and a batch in both shapes."""
    block = rng.uniform(-128, 128, size=64)
    assert np.array_equal(dct_ref.dct(block), f_dct_ref.dct(block))
    for shape in ((5, 64), (5, 8, 8)):
        blocks = rng.uniform(-128, 128, size=shape)
        assert np.array_equal(dct_ref.dct_blocks(blocks), f_dct_ref.dct_blocks(blocks))


def _textimage(rng):
    """The text image format: what one package writes, the other reads the
    same, and the files are byte-equal; image_to_gray (PIL) agrees."""
    import tempfile

    gray = rng.uniform(0, 255, size=(6, 11))
    with tempfile.TemporaryDirectory() as d:
        ours, ref = os.path.join(d, "ours.txt"), os.path.join(d, "ref.txt")
        textimage.write_text_image(ours, gray)
        f_textimage.write_text_image(ref, gray)
        with open(ours, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
        got, want = textimage.read_text_image(ref), f_textimage.read_text_image(ours)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:] == (11, 6)
        assert np.array_equal(got[0], gray)
    rgb = rng.integers(0, 256, size=(12, 16, 3), dtype=np.uint8)
    for size in (None, (8, 6)):
        assert np.array_equal(textimage.image_to_gray(rgb, size),
                              f_textimage.image_to_gray(rgb, size))


def _native_transform(lib, threads, x, tables, forward):
    u32p = ctypes.POINTER(ctypes.c_uint32)

    def ptr(a):
        return np.ascontiguousarray(a).ctypes.data_as(u32p)

    L, n = len(tables.primes), tables.n
    out = np.ascontiguousarray(x.copy())
    p = np.ascontiguousarray(tables.p.reshape(-1))
    if forward:
        lib.fastntt_forward(ptr(out), out.shape[0], L, n, ptr(tables.psi_br),
                            ptr(tables.psi_br_shoup), ptr(p), threads)
    else:
        lib.fastntt_inverse(ptr(out), out.shape[0], L, n, ptr(tables.ipsi_br),
                            ptr(tables.ipsi_br_shoup), ptr(p),
                            ptr(tables.n_inv.reshape(-1)), ptr(tables.n_inv_shoup.reshape(-1)),
                            threads)
    return out


def _native(rng):
    """The port's own fastntt build, forward and inverse, against fhetpu's,
    and the port's host NTT runs on it."""
    lib = native.lib()
    assert lib is not None
    assert os.path.dirname(native._SO) == os.path.join(
        os.path.dirname(fhetpu_torch.__file__), "build")
    ours, ref = BfvParams.create(n=N, t=T).tables_q, FBfvParams.create(n=N, t=T).tables_q
    x = np.stack([rng.integers(0, p, size=(3, N), dtype=np.uint64) for p in ours.primes],
                 axis=-2).astype(np.uint32)
    fx = _native_transform(lib, 2, x, ours, True)
    assert np.array_equal(fx, _native_transform(f_native.lib(), 2, x, ref, True))
    assert np.array_equal(fx, f_ntt.np_ntt(x, ref))
    assert np.array_equal(ntt._native_ntt(x, ours, forward=True), fx)
    ix = _native_transform(lib, 2, fx, ours, False)
    assert np.array_equal(ix, _native_transform(f_native.lib(), 2, fx, ref, False))
    assert np.array_equal(ix, x)


def _cv_resize(rng):
    """The RMS ground truth: cv2 where importable, the fixed-point model
    and the float model, on odd sizes both ways."""
    img = rng.integers(0, 256, size=(9, 13, 3), dtype=np.uint8)
    for bicubic in (False, True):
        for w2, h2 in ((5, 4), (17, 20)):
            for name in ("cv_ground_truth", "cv_resize_fixedpoint", "cv_resize"):
                got = getattr(cv_resize, name)(img, w2, h2, bicubic)
                assert np.array_equal(got, getattr(f_cv_resize, name)(img, w2, h2, bicubic)), name


def _behz(rng):
    """Every BEHZ table (tests/test_torch_rns.py checks n=2048 and 8192)."""
    for n in (4096, 16384):
        ours, ref = rns.BehzConsts(BfvParams.create(n=n)), f_rns.BehzConsts(FBfvParams.create(n=n))
        assert sorted(vars(ours)) == sorted(vars(ref))
        for name, want in vars(ref).items():
            got = getattr(ours, name)
            assert type(got) is type(want) and np.array_equal(got, want), name


def _noise(rng):
    """The analytic estimates the servers gate on and the chooser reads."""
    for n, t in ((2048, 1 << 14), (4096, 64), (8192, 1 << 14)):
        par, fpar = BfvParams.create(n=n, t=t), FBfvParams.create(n=n, t=t)
        enc = encoder.FractionalEncoder(t, n)
        for mean in (False, True):
            a, fa = noise.fresh(par, mean), f_noise.fresh(fpar, mean)
            assert noise.multiply(a, a, 3, 2, mean).log2_noise == \
                f_noise.multiply(fa, fa, 3, 2, mean).log2_noise
            for dbc in (0, 16, 30):
                assert noise.relinearize(a, dbc).log2_noise == f_noise.relinearize(fa, dbc).log2_noise
            assert noise.estimate_jpeg_pipeline(par, enc, mean).log2_noise == \
                f_noise.estimate_jpeg_pipeline(fpar, enc, mean).log2_noise
            for bicubic in (False, True):
                for plain in (False, True):
                    for dbc in (None, 30):
                        kw = dict(plain_fracts=plain, mean=mean, relin_dbc=dbc)
                        got = noise.estimate_resize_pipeline(par, enc, bicubic, **kw)
                        want = f_noise.estimate_resize_pipeline(fpar, enc, bicubic, **kw)
                        assert got.log2_noise == want.log2_noise, (n, t, bicubic, kw)


def _chooser(rng):
    """The ring degrees the clients pick (n=4096 bilinear, 8192 bicubic,
    2048 with plain fracts at t=2^14)."""
    for t in (1 << 14, 64):
        assert chooser.jpeg_parameters(t=t).n == f_chooser.jpeg_parameters(t=t).n
        for bicubic in (False, True):
            for plain in (False, True):
                for dbc in (None, 30):
                    kw = dict(t=t, plain_fracts=plain, relin_dbc=dbc)
                    assert chooser.resize_parameters(bicubic, **kw).n == \
                        f_chooser.resize_parameters(bicubic, **kw).n
    assert [chooser.resize_parameters(b).n for b in (False, True)] == [4096, 8192]


@pytest.mark.parametrize("case", [_primes, _encoder, _golden, _images, _jpeg, _native,
                                  _cv_resize, _behz, _noise, _chooser, _jpge, _dct_ref,
                                  _textimage],
                         ids=["primes", "encoder", "golden", "images", "jpeg", "native",
                              "cv_resize", "behz", "noise", "chooser", "jpge", "dct_ref",
                              "textimage"])
def test_copy_equals_original(case):
    case(np.random.default_rng(31))
