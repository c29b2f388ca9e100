"""fhetpu_torch's encrypted resize against fhetpu's and against the
plaintext golden network, on the CPU.

* axis_plan and fract_polys equal fhetpu's;
* one bilinear encrypted-fract tile (4x4 -> 3x3, n=2048) equals fhetpu's
  jitted resize_tile residue for residue (tolerance 0), with the same
  input and fract ciphertexts: the comparison of the slice as a whole;
* bilinear with encrypted fracts at n=4096 and t=2^14, bicubic with
  encrypted fracts, unrelinearized and relinearized, at n=4096 and t=64
  (where the depth-4 chain has noise budget, like fhetpu's own bicubic
  test), and the plain-fract path at t=2^14 decrypt exactly to the port's
  golden network and decode to within 1e-5 of resize_float.

fhetpu's bicubic tile is never jitted here: it takes minutes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhetpu.bfv.crypto import Encryptor as FEncryptor
from fhetpu.bfv.crypto import PublicKey as FPublicKey
from fhetpu.bfv.encoder import FractionalEncoder as FFractionalEncoder
from fhetpu.bfv.evaluator import Evaluator as FEvaluator
from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.pipelines import resize as frz

from fhetpu_torch.bfv import crypto, golden
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import DeviceRelinKeys, Evaluator
from fhetpu_torch.bfv.golden import GoldenEvaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.pipelines import resize as rz

torch.set_num_threads(2)


class GoldenFracts:
    """Scalar fract bundle for the golden network (one output pixel);
    1-t, t^2, t^3 are polynomial compositions, like the pipeline's."""

    def __init__(self, gev, f, mode):
        self.t = gev.encode(float(f))
        self.one_minus_t = golden.add(gev.encode(1.0), golden.neg(self.t, gev.t), gev.t)
        if mode == rz.BICUBIC:
            self.t2 = golden.mult(self.t, self.t, gev.t)
            self.t3 = golden.mult(self.t2, self.t, gev.t)


def golden_resize(encoder, coeffs, h2, w2, mode, rows=None):
    """The golden mod-t network per output pixel: coeffs [H, W, ch, n] ->
    [len(rows), W', ch, n] for the output rows ``rows`` (default all)."""
    gev = GoldenEvaluator(encoder)
    rp = rz.axis_plan(coeffs.shape[0], h2, mode)
    cp = rz.axis_plan(coeffs.shape[1], w2, mode)
    taps = 2 if mode == rz.BILINEAR else 4
    rows = range(h2) if rows is None else rows
    out = np.zeros((len(rows), w2) + coeffs.shape[2:], dtype=np.int64)
    for i, y in enumerate(rows):
        fy = GoldenFracts(gev, rp.fract[y], mode)
        for x in range(w2):
            fx = GoldenFracts(gev, cp.fract[x], mode)
            cols = []
            for r in range(taps):
                px = [coeffs[rp.idx[y, r], cp.idx[x, k]] for k in range(taps)]  # [ch, n] each
                if mode == rz.BILINEAR:
                    cols.append(rz.linear_interp(gev, px[0], px[1], fx, True))
                else:
                    cols.append(rz.cubic_interp(gev, *px, fx, True))
            if mode == rz.BILINEAR:
                out[i, x] = rz.linear_interp(gev, cols[0], cols[1], fy, True)
            else:
                out[i, x] = rz.cubic_interp(gev, *cols, fy, True)
    return out


def _setup(n, t, hw, seed, ch=3):
    par = BfvParams.create(n=n, t=t)
    kg = crypto.KeyGenerator(par, seed=seed)
    enc = crypto.Encryptor(par, kg.public_key(), seed=seed + 1)
    encoder = FractionalEncoder(t, n)
    img = np.random.default_rng(seed).integers(0, 256, size=(hw, hw, ch), dtype=np.uint8)
    coeffs = encoder.encode_batch(img.astype(np.float64))  # [H, W, ch, n]
    cts = enc.encrypt_batch(coeffs.reshape(-1, n)).reshape(hw, hw, ch, 2, par.L, n)
    return par, kg, enc, encoder, img, coeffs, cts


@pytest.mark.parametrize("src,dst", [(48, 17), (6, 3), (4, 3), (17, 48)])
def test_axis_plan_and_fract_polys_equal_fhetpu(src, dst):
    """The sampling plan and the fract polynomials (t, 1-t, t^2, t^3) are
    fhetpu's."""
    encoder, f_encoder = FractionalEncoder(1 << 14, 2048), FFractionalEncoder(1 << 14, 2048)
    for mode in (rz.BILINEAR, rz.BICUBIC):
        ours, ref = rz.axis_plan(src, dst, mode), frz.axis_plan(src, dst, mode)
        assert np.array_equal(ours.idx, ref.idx) and np.array_equal(ours.fract, ref.fract)
        fr = ours.fract[:3]
        for got, want in zip(rz.fract_polys(encoder, fr, mode),
                             frz.fract_polys(f_encoder, fr, mode)):
            assert len(got) == len(want)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def bilinear_tile():
    """One bilinear encrypted-fract tile, 4x4 -> 3x3 at n=2048, through
    both packages with the same input and fract ciphertexts (fhetpu's under
    jax.jit, the file's slowest step: once per module)."""
    n, t = 2048, 1 << 14
    par, kg, _, encoder, _, _, cts = _setup(n, t, 4, seed=61)
    fpar = FBfvParams.create(n=n, t=t)
    mode = rz.BILINEAR
    rp, cp = rz.axis_plan(4, 3, mode), rz.axis_plan(4, 3, mode)
    ev = Evaluator(par, encoder, device="cpu")
    yops, xops = rz.make_fract_bundles(ev, rp, cp, mode,
                                       encryptor=crypto.Encryptor(par, kg.public_key(), seed=9))
    got = rz.resize_tile(ev, torch.from_numpy(cts), rp, cp, yops, xops, mode, False)
    fev = FEvaluator(fpar, FFractionalEncoder(t, n))
    fenc = FEncryptor(fpar, FPublicKey(kg.public_key().data, fpar), seed=9)
    fy, fx = frz.make_fract_bundles(fev, rp, cp, mode, encryptor=fenc)
    want = jax.jit(lambda c: frz.resize_tile(fev, c, rp, cp, fy, fx, mode, False))(
        jnp.asarray(cts))
    return par, got, np.asarray(want)


def test_bilinear_encrypted_tile_equals_fhetpu(bilinear_tile):
    """The port's tile gives fhetpu's residues, size 4 (unrelinearized)."""
    par, got, want = bilinear_tile
    assert got.dtype == torch.uint32 and tuple(got.shape) == (3, 3, 3, 4, par.L, par.n)
    assert np.array_equal(got.numpy(), want)


def test_bilinear_encrypted_decrypts_to_golden_at_4096():
    """n=2048 leaves the depth-2 bilinear chain no noise budget (the
    client's chooser picks n=4096 for it), so decryption is checked at
    n=4096, 5x5 -> 2x2, like fhetpu's own test: the unrelinearized tile
    decrypts to the golden network and decodes to within 1e-5 of the float
    sampler, which equals fhetpu's."""
    par, kg, enc, encoder, img, coeffs, cts = _setup(4096, 1 << 14, 5, seed=91)
    ev = Evaluator(par, encoder, device="cpu")
    mode = rz.BILINEAR
    rp, cp = rz.axis_plan(5, 2, mode), rz.axis_plan(5, 2, mode)
    yops, xops = rz.make_fract_bundles(ev, rp, cp, mode, encryptor=enc)
    out = rz.resize_tile(ev, torch.from_numpy(cts), rp, cp, yops, xops, mode, False)
    dec = crypto.Decryptor(par, kg.secret)
    plains = dec.decrypt_batch(out.numpy().reshape(-1, 4, par.L, par.n)).reshape(2, 2, 3, par.n)
    assert np.array_equal(plains, golden_resize(encoder, coeffs, 2, 2, mode))
    ref = rz.resize_float(img, 2, 2, mode)
    assert np.allclose(encoder.decode_batch(plains), ref, rtol=0, atol=1e-5)
    assert np.array_equal(ref, frz.resize_float(img, 2, 2, mode))


@pytest.fixture(scope="module")
def small_t():
    """n=4096, t=64, a one-channel 5x5 image: the depth-4 bicubic chain
    keeps noise budget here (fhetpu's tests/test_resize.py uses the same t);
    one channel keeps the CPU's plain NTTs to seconds (the tile code does
    not depend on the channel count)."""
    par, kg, enc, encoder, img, coeffs, cts = _setup(4096, 64, 5, seed=71, ch=1)
    return par, kg, enc, encoder, img, coeffs, cts, Evaluator(par, encoder, device="cpu")


@pytest.mark.parametrize("relin", [False, True], ids=["unrelinearized", "relin"])
def test_bicubic_encrypted_decrypts_to_golden(small_t, relin):
    """Bicubic with encrypted fracts, 5x5 -> 2x2: size 8 unrelinearized,
    size 2 with relinearization after every ct x ct (dbc 30); both decrypt
    exactly to the golden network and decode to within 1e-5 of
    resize_float."""
    par, kg, enc, encoder, img, coeffs, cts, ev = small_t
    mode = rz.BICUBIC
    rp, cp = rz.axis_plan(5, 2, mode), rz.axis_plan(5, 2, mode)
    rk = DeviceRelinKeys(kg.relin_keys(max_power=2, digit_bits=30)) if relin else None
    yops, xops = rz.make_fract_bundles(ev, rp, cp, mode, encryptor=enc, relin=rk)
    out = rz.resize_tile(ev, torch.from_numpy(cts), rp, cp, yops, xops, mode, False, rk)
    size = 2 if relin else 8
    assert tuple(out.shape) == (2, 2, 1, size, par.L, par.n)
    dec = crypto.Decryptor(par, kg.secret)
    plains = dec.decrypt_batch(out.numpy().reshape(-1, size, par.L, par.n)).reshape(2, 2, 1, par.n)
    assert np.array_equal(plains, golden_resize(encoder, coeffs, 2, 2, mode))
    ref = rz.resize_float(img, 2, 2, mode)
    assert np.allclose(encoder.decode_batch(plains), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", [rz.BILINEAR, rz.BICUBIC], ids=["bilinear", "bicubic"])
def test_plain_fracts_decrypt_to_golden_and_float(mode):
    """The plain-fract path at n=4096, t=2^14, 5x5 -> 2x2: size 2,
    decrypts exactly to the golden network, and its decoded values are
    within 1e-5 of resize_float."""
    par, kg, _, encoder, img, coeffs, cts = _setup(4096, 1 << 14, 5, seed=81)
    ev = Evaluator(par, encoder, device="cpu")
    rp, cp = rz.axis_plan(5, 2, mode), rz.axis_plan(5, 2, mode)
    yops, xops = rz.make_fract_bundles(ev, rp, cp, mode)
    out = rz.resize_tile(ev, torch.from_numpy(cts), rp, cp, yops, xops, mode, True)
    assert tuple(out.shape) == (2, 2, 3, 2, par.L, par.n)
    dec = crypto.Decryptor(par, kg.secret)
    plains = dec.decrypt_batch(out.numpy().reshape(-1, 2, par.L, par.n)).reshape(2, 2, 3, par.n)
    assert np.array_equal(plains, golden_resize(encoder, coeffs, 2, 2, mode))
    ref = rz.resize_float(img, 2, 2, mode)
    assert np.allclose(encoder.decode_batch(plains), ref, rtol=0, atol=1e-5)
    assert np.array_equal(rz.clamp_u8(ref), frz.clamp_u8(frz.resize_float(img, 2, 2, mode)))
