"""The benchmark's plain reference of the bicubic resize
(``perfbench/reference/resize_cubic.py``) against the port, on the CPU:
its axis plan is ``axis_plan(..., BICUBIC)``'s, its polynomial product is
the golden network's, and the port's unrelinearized bicubic tile with
encrypted fracts decrypts to it coefficient for coefficient (n=4096, t=64,
a one-channel 5x5 image to 2x2: the size at which the depth-4 chain keeps
noise budget on the CPU's plain NTTs)."""

import numpy as np
import torch

from fhetpu_torch.bfv import crypto
from fhetpu_torch.bfv import golden as g
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.pipelines import resize as rz
from perfbench.reference import resize_cubic
from perfbench.reference.ring import Encoder

torch.set_num_threads(2)


def test_the_reference_axis_plan_is_the_programs():
    for src, dst in ((48, 17), (5, 2), (17, 48)):
        taps, offs = resize_cubic.axis_plan(src, dst)
        plan = rz.axis_plan(src, dst, rz.BICUBIC)
        assert np.array_equal(taps, plan.idx) and np.array_equal(offs, plan.fract)


def test_the_reference_product_is_the_golden_one():
    """Dense, sparse and broadcast operands mod t = 2^14 at n = 64."""
    n, t = 64, 1 << 14
    rng = np.random.default_rng(5)
    a = rng.integers(0, t, (3, 1, n))
    b = np.zeros((1, 2, n), dtype=np.int64)
    b[..., [0, 7, n - 1]] = rng.integers(0, t, (1, 2, 3))
    got = resize_cubic.poly_mul(torch.from_numpy(a), torch.from_numpy(b), t).numpy()
    for i in range(3):
        for j in range(2):
            assert np.array_equal(got[i, j], g.mult(a[i, 0], b[0, j], t))
            assert np.array_equal(got[i, j], resize_cubic.poly_mul(
                torch.from_numpy(b[0, j]), torch.from_numpy(a[i, 0]), t).numpy())


def test_the_encrypted_tile_decrypts_to_the_reference():
    n, t, hw = 4096, 64, 5
    par = BfvParams.create(n=n, t=t)
    kg = crypto.KeyGenerator(par, seed=73)
    enc = crypto.Encryptor(par, kg.public_key(), seed=74)
    encoder = FractionalEncoder(t, n)
    img = np.random.default_rng(73).integers(0, 256, size=(hw, hw, 1), dtype=np.uint8)
    coeffs = encoder.encode_batch(img.astype(np.float64))
    cts = enc.encrypt_batch(coeffs.reshape(-1, n)).reshape(hw, hw, 1, 2, par.L, n)
    ev = Evaluator(par, encoder, device="cpu")
    rp = cp = rz.axis_plan(hw, 2, rz.BICUBIC)
    yops, xops = rz.make_fract_bundles(ev, rp, cp, rz.BICUBIC, encryptor=enc)
    out = rz.resize_tile(ev, torch.from_numpy(cts), rp, cp, yops, xops, rz.BICUBIC, False)
    assert tuple(out.shape) == (2, 2, 1, 8, par.L, n)
    got = crypto.Decryptor(par, kg.secret).decrypt_batch(out.numpy().reshape(-1, 8, par.L, n))
    ref = resize_cubic.CubicResizeReference(Encoder(t, n, 100, 100), (hw, hw), (2, 2), "cpu")
    want = ref.plain(img).numpy().reshape(-1, n)
    assert np.array_equal(got, want)
