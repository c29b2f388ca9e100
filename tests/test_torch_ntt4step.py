"""The four-step NTT (``fhetpu_torch/core/ntt4step.py``, int8 digit-plane
products through ``torch._int_mm``) against the port's NTT and fhetpu's
four-step: forward and inverse equal ``ntt.ntt``/``ntt.intt`` (the NTT
kernels' plain versions on the CPU) and the host ``np_ntt`` at every ring
degree (A*B = 32*64 ... 128*128); the host tables equal fhetpu's
``get_fourstep``; the digit split equals fhetpu's; one transform equals
fhetpu's ``ntt4`` at n = 2048.  Every comparison is exact; inputs come from
np.random.default_rng."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.core import ntt4step as f4

from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.core import ntt, ntt4step

torch.set_num_threads(2)


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


@pytest.mark.parametrize("n", [2048, 4096, 8192, 16384])
def test_ntt4_equals_ntt(n):
    """ntt4 forward equals ntt.ntt and np_ntt, ntt4 inverse equals ntt.intt
    and undoes the forward, on a [2, 3] batch over the q base; the
    factorisation is fhetpu's."""
    tables = BfvParams.create(n=n).tables_q
    ft = ntt4step.get_fourstep(tables.primes, n)
    assert (ft.A, ft.B) == f4._factor(n) and ft.A * ft.B == n
    x = _residues(np.random.default_rng(n), tables.primes, (2, 3), n)
    xt = torch.from_numpy(x)
    fwd = ntt4step.ntt4(xt, tables, True)
    assert fwd.dtype == torch.uint32 and fwd.shape == xt.shape
    assert torch.equal(fwd, ntt.ntt(xt, tables))
    assert np.array_equal(fwd.numpy(), ntt.np_ntt(x, tables))
    inv = ntt4step.ntt4(fwd, tables, False)
    assert torch.equal(inv, ntt.intt(fwd, tables)) and torch.equal(inv, xt)


def test_fourstep_tables_equal_fhetpu():
    """At n = 2048 and 4096, every constant of FourStepTables (digit planes
    of M1, M2 and their inverses, twiddles and their Shoup companions)
    equals fhetpu's; the class weights are 2^(8s) mod p."""
    for n in (2048, 4096):
        ours = ntt4step.get_fourstep(BfvParams.create(n=n).q_primes, n)
        ref = f4.get_fourstep(tuple(FBfvParams.create(n=n).q_primes), n)
        assert (ours.n, ours.A, ours.B) == (ref.n, ref.A, ref.B)
        for name in ("m1_dig", "m2_dig", "m1i_dig", "m2i_dig", "tw", "tw_shoup", "twi",
                     "twi_shoup"):
            got, want = getattr(ours, name), getattr(ref, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), (n, name)
        for s in range(ntt4step.N_CLASSES):
            assert ours.class_weights[s].tolist() == [(1 << (8 * s)) % p for p in ours.primes]


def test_digits_equal_fhetpu():
    """digits_balanced splits residues into fhetpu's int8 planes, which
    recompose to the value; the host split agrees."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(0, 1 << 30, size=500, dtype=np.uint64),
                        [0, 127, 128, 255, 256, 32767, 32768, (1 << 30) - 1]]).astype(np.uint32)
    got = ntt4step.digits_balanced(torch.from_numpy(x)).numpy()
    want = np.asarray(f4._digits_balanced_jnp(jnp.asarray(x)))
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert np.array_equal(got, ntt4step._digits_balanced_np(x))
    back = sum(got[j].astype(np.int64) << (8 * j) for j in range(ntt4step.NDIG))
    assert np.array_equal(back, x.astype(np.int64))


def test_ntt4_equals_fhetpu_ntt4():
    """One batch at n = 2048 through fhetpu's ntt4 (int8 dot_general and
    its 96-bit recombination) and the port's, forward and inverse: equal."""
    par, fpar = BfvParams.create(n=2048), FBfvParams.create(n=2048)
    x = _residues(np.random.default_rng(9), par.q_primes, (3,), 2048)
    for forward in (True, False):
        want = np.asarray(f4.ntt4(jnp.asarray(x), fpar.tables_q, forward))
        got = ntt4step.ntt4(torch.from_numpy(x), par.tables_q, forward)
        assert np.array_equal(got.numpy(), want), forward
