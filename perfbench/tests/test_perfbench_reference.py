"""The plain reference agrees with fhetpu_torch's plain versions at
n = 2048 (and with a naive product at n = 16), so that a disagreement in a
run points at the program, not at the yardstick."""

import numpy as np
import pytest
import torch
from conftest import SMALL_CHAIN

from perfbench.reference.bfv import SecretKey
from perfbench.reference.jpeg import AAN, YCC, JpegReference
from perfbench.reference.resize import axis_plan
from perfbench.reference.ring import Encoder, Ring

N, PRIMES = SMALL_CHAIN["n"], SMALL_CHAIN["q_primes"]
T = 1 << 14


def _params():
    from fhetpu_torch.bfv.params import BfvParams

    par = BfvParams.create(n=N, t=T)
    assert list(par.q_primes) == PRIMES
    return par


def test_the_ntt_product_is_the_negacyclic_product():
    ring, gen = Ring(PRIMES, 16), torch.Generator().manual_seed(1)
    a, b = (torch.randint(-500, 500, (3, 16), generator=gen) for _ in range(2))
    got = ring.poly_mul(ring.lift(a), ring.lift(b))
    want = torch.zeros(3, 16, dtype=torch.int64)
    for i in range(16):
        for j in range(16):
            sign = 1 if i + j < 16 else -1
            want[:, (i + j) % 16] += sign * a[:, i] * b[:, j]
    assert torch.equal(got, want[:, None, :] % ring.p)


def test_the_ntt_product_agrees_with_the_programs():
    from fhetpu_torch.core import ntt

    par, ring = _params(), Ring(PRIMES, N)
    gen = torch.Generator().manual_seed(2)
    a, b = ((torch.randint(0, 1 << 62, (2, 2, N), generator=gen) % ring.p) for _ in range(2))
    fa, fb = (ntt.ntt(x.to(torch.uint32), par.tables_q).to(torch.int64) for x in (a, b))
    prog = ntt.intt((fa * fb % ring.p).to(torch.uint32), par.tables_q).to(torch.int64)
    assert torch.equal(ring.poly_mul(a, b), prog)


def test_the_encoder_agrees_with_the_programs():
    from fhetpu_torch.bfv.encoder import FractionalEncoder

    ours, prog = Encoder(T, N, 100, 100), FractionalEncoder(T, N)
    _, offs = axis_plan(48, 17)
    for v in list(YCC) + list(AAN) + [128.0, 1.0, 0.0, 255.0, 37.0] + list(offs):
        assert np.array_equal(ours.encode(v), prog.encode(v).coeffs), v


def test_the_sampler_agrees_with_the_programs():
    from fhetpu_torch.pipelines import resize as rz

    for src, dst in ((48, 17), (4, 3), (17, 48)):
        taps, offs = axis_plan(src, dst)
        plan = rz.axis_plan(src, dst, rz.BILINEAR)
        assert np.array_equal(taps, plan.idx) and np.array_equal(offs, plan.fract)


def test_the_jpeg_network_agrees_with_the_programs_plain_op():
    from fhetpu_torch.bfv.evaluator import Evaluator
    from fhetpu_torch.pipelines.jpeg_encode import server_compute_fn

    ev = Evaluator(_params(), device="cpu")
    ring = Ring(PRIMES, N)
    gen = torch.Generator().manual_seed(3)
    x = (torch.randint(0, 1 << 62, (1, 3, 64, 2, 2, N), generator=gen) % ring.p)
    got = JpegReference(ring, Encoder(T, N, 100, 100))(x)
    assert torch.equal(got, server_compute_fn(ev)(x.to(torch.uint32)).to(torch.int64))


@pytest.mark.parametrize("size", [2, 3])
def test_decryption_agrees_with_the_programs(size):
    from fhetpu_torch.bfv.crypto import Decryptor
    from fhetpu_torch.bfv.crypto import SecretKey as ProgramKey

    par, ring = _params(), Ring(PRIMES, N)
    gen = torch.Generator().manual_seed(4)
    sk = SecretKey(ring, T, gen)
    m = np.random.default_rng(5).integers(0, T, (4, N))
    ct = sk.encrypt(m, gen)
    if size == 3:  # a third component decrypted against s^2
        ct = torch.cat([ct, (torch.randint(0, 1 << 62, (4, 1, 2, N), generator=gen) % ring.p)],
                       dim=1)
    ours, _ = sk.decrypt(ct)
    prog = Decryptor(par, ProgramKey(sk.small.numpy().astype(np.int8), par))
    assert np.array_equal(ours.numpy(), prog.decrypt_batch(ct.to(torch.uint32).numpy()))
    if size == 2:
        assert np.array_equal(ours.numpy(), m)
