"""fhetpu_torch's BEHZ ct x ct multiply and relinearization against
fhetpu's, residue for residue (tolerance 0), at n=2048 on the CPU.

Both packages get the same ciphertexts and keys from the same seeded
KeyGenerator and Encryptor.  fhetpu's side runs under jax.jit (an eager
fhetpu multiply compiles every op on its first call, over a minute here):
its Evaluator's multiply and relinearize are jitted in place, so
multiply_many, exponentiate and square run fhetpu's own code over jitted
primitives, each shape compiled once per test run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhetpu.bfv import crypto as f_crypto
from fhetpu.bfv import rns as f_rns
from fhetpu.bfv.evaluator import Ct as FCt
from fhetpu.bfv.evaluator import DeviceRelinKeys as FDeviceRelinKeys
from fhetpu.bfv.evaluator import Evaluator as FEvaluator
from fhetpu.bfv.params import BfvParams as FBfvParams

from fhetpu_torch.bfv import crypto, golden, rns
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Ct, DeviceRelinKeys, Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.core import modops

torch.set_num_threads(2)

N, T = 2048, 1 << 14


class RnsContext:
    """Both packages' evaluators at n=2048 and five fresh ciphertexts, with
    relinearization keys of their secret made on demand."""

    def __init__(self):
        self.par, self.fpar = BfvParams.create(n=N, t=T), FBfvParams.create(n=N, t=T)
        kg = crypto.KeyGenerator(self.par, seed=41)
        enc = crypto.Encryptor(self.par, kg.public_key(), seed=42)
        encoder = FractionalEncoder(T, N)
        self.ev = Evaluator(self.par, encoder, device="cpu")
        self.fev = FEvaluator(self.fpar)
        self.fev.multiply = jax.jit(self.fev.multiply)
        self.fev.relinearize = jax.jit(self.fev.relinearize, static_argnums=1)
        self.plains = [encoder.encode(v).coeffs for v in (1.5, -2.25, 3.0, 0.625, -1.0)]
        self.cts = enc.encrypt_batch(np.stack(self.plains))  # [5, 2, L, n]
        self.dec = crypto.Decryptor(self.par, kg.secret)
        self._relin = {}

    def relin(self, dbc):
        """Keys of the ciphertexts' secret, the same for both packages: a
        fresh generator of the same seed each, drawing its public key first
        as the ciphertexts' generator did."""
        if dbc not in self._relin:
            keys = []
            for gen in (crypto.KeyGenerator(self.par, seed=41),
                        f_crypto.KeyGenerator(self.fpar, seed=41)):
                gen.public_key()
                keys.append(gen.relin_keys(max_power=2, digit_bits=dbc))
            rk, frk = keys
            self._relin[dbc] = (DeviceRelinKeys(rk), FDeviceRelinKeys(frk), rk, frk)
        return self._relin[dbc]


@pytest.fixture(scope="module")
def ctx():
    return RnsContext()


def _port(ct: Ct) -> np.ndarray:
    return modops.to_u32(ct.data).numpy()


def _fhetpu(ct: FCt) -> np.ndarray:
    return np.asarray(ct.data)


def _decrypts_to(ctx, data: np.ndarray, want: np.ndarray):
    got = ctx.dec.decrypt_batch(data.reshape((-1,) + data.shape[-3:]))
    assert np.array_equal(got.reshape(want.shape), want)


def test_behz_consts_equal_fhetpu(ctx):
    """Every table of BehzConsts equals fhetpu's, at n=2048 and 8192."""
    for n in (N, 8192):
        ours = rns.BehzConsts(BfvParams.create(n=n, t=T))
        ref = f_rns.BehzConsts(FBfvParams.create(n=n, t=T))
        assert set(vars(ours)) == set(vars(ref))
        for name, value in vars(ref).items():
            got = getattr(ours, name)
            assert np.array_equal(np.asarray(got), np.asarray(value)), name
            assert np.asarray(got).dtype == np.asarray(value).dtype, name


@pytest.mark.parametrize("k1,k2", [(2, 2), (3, 2), (5, 4)])
def test_multiply_equals_fhetpu(ctx, k1, k2):
    """rns.multiply and Evaluator.multiply give fhetpu's residues for
    ciphertexts of sizes k1 x k2 (batch 2), and the product decrypts to
    the golden product of the two plaintexts."""
    rng = np.random.default_rng(k1 * 10 + k2)
    q = np.asarray(ctx.par.q_primes, dtype=np.uint64).reshape(-1, 1)
    # sizes above 2 as random residues: the residue-level equality does not
    # need decryptable inputs
    a = (rng.integers(0, 1 << 62, size=(2, k1, ctx.par.L, N), dtype=np.uint64) % q).astype(np.uint32)
    b = (rng.integers(0, 1 << 62, size=(2, k2, ctx.par.L, N), dtype=np.uint64) % q).astype(np.uint32)
    a[:, :2], b[:, :2] = ctx.cts[:2], ctx.cts[2:4]
    want = _fhetpu(ctx.fev.multiply(FCt(jnp.asarray(a)), FCt(jnp.asarray(b))))
    got = rns.multiply(torch.from_numpy(a), torch.from_numpy(b), ctx.ev.rns_tool)
    assert got.dtype == torch.int64 and got.shape == (2, k1 + k2 - 1, ctx.par.L, N)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    ev_got = ctx.ev.multiply(Ct(torch.from_numpy(a)), Ct(torch.from_numpy(b)))
    assert np.array_equal(_port(ev_got), want)
    if k1 == k2 == 2:
        fresh = ctx.ev.multiply(Ct(torch.from_numpy(ctx.cts[:2])),
                                Ct(torch.from_numpy(ctx.cts[2:4])))
        _decrypts_to(ctx, _port(fresh), np.stack(
            [golden.mult(ctx.plains[i], ctx.plains[i + 2], T) for i in range(2)]))


def test_square_and_ntt_form_inputs_equal_fhetpu(ctx):
    """square, and multiply of NTT-form operands (which go back to
    coefficient form first), give fhetpu's residues and decrypt to the
    golden square."""
    ev = ctx.ev
    a = ctx.cts[:2]
    want = _fhetpu(ctx.fev.square(FCt(jnp.asarray(a))))
    got = ev.square(Ct(torch.from_numpy(a)))
    assert np.array_equal(_port(got), want)
    a_ntt = ev.transform_to_ntt(Ct(torch.from_numpy(a)))
    assert np.array_equal(_port(ev.multiply(a_ntt, a_ntt)), want)
    _decrypts_to(ctx, want, np.stack([golden.mult(p, p, T) for p in ctx.plains[:2]]))


@pytest.mark.parametrize("dbc", [0, 30, 16])
def test_relinearize_equals_fhetpu(ctx, dbc):
    """relinearize of a size-3 product at dbc 0, 30 and 16 (two digits per
    limb) gives fhetpu's residues with the same keys, decrypts to the
    golden product; a size-2 input comes back unchanged."""
    rk, frk, host_rk, host_frk = ctx.relin(dbc)
    assert rk.n_subdigits == host_rk.n_subdigits == host_frk.n_subdigits == (2 if dbc == 16 else 1)
    for k in host_frk.keys:
        assert np.array_equal(host_rk.keys[k], host_frk.keys[k])
    prod = ctx.ev.multiply(Ct(torch.from_numpy(ctx.cts[:2])), Ct(torch.from_numpy(ctx.cts[2:4])))
    want = _fhetpu(ctx.fev.relinearize(FCt(jnp.asarray(_port(prod))), frk))
    got = ctx.ev.relinearize(prod, rk)
    assert got.size == 2 and np.array_equal(_port(got), want)
    _decrypts_to(ctx, want, np.stack(
        [golden.mult(ctx.plains[i], ctx.plains[i + 2], T) for i in range(2)]))
    fresh = Ct(torch.from_numpy(ctx.cts[:1]))
    assert ctx.ev.relinearize(fresh, rk) is fresh


def test_multiply_many_and_exponentiate_equal_fhetpu(ctx):
    """multiply_many (unrelinearized and relinearized), add_many and
    exponentiate (relinearized cube, plain square) give fhetpu's residues
    (depth 2 leaves n=2048 no noise budget to decrypt them: see the next
    test)."""
    rk, frk, _, _ = ctx.relin(30)
    # batches of two, the shapes the tests above compiled
    pairs = [ctx.cts[0:2], ctx.cts[2:4], ctx.cts[[4, 0]]]
    cts = [Ct(torch.from_numpy(c)) for c in pairs]
    fcts = [FCt(jnp.asarray(c)) for c in pairs]
    ev, fev = ctx.ev, ctx.fev
    triple = _port(ev.multiply_many(cts))
    assert triple.shape[-3] == 4
    assert np.array_equal(triple, _fhetpu(fev.multiply_many(fcts)))
    assert np.array_equal(_port(ev.multiply_many(cts, rk)), _fhetpu(fev.multiply_many(fcts, frk)))
    assert np.array_equal(_port(ev.add_many(cts)), _fhetpu(fev.add_many(fcts)))
    cube = ev.exponentiate(cts[0], 3, rk)
    assert cube.size == 2
    assert np.array_equal(_port(cube), _fhetpu(fev.exponentiate(fcts[0], 3, frk)))
    assert np.array_equal(_port(ev.exponentiate(cts[0], 2)), _fhetpu(fev.exponentiate(fcts[0], 2)))
    assert ev.exponentiate(cts[0], 1) is cts[0]
    with pytest.raises(ValueError):
        ev.exponentiate(cts[0], 0)


def test_mulmod_exact_at_the_largest_operands():
    """modops.mulmod equals a*b % p for operands at p - 1 and at 2^30 - 1
    (the BEHZ steps feed residues of one base to the primes of another),
    on every q and Bsk prime at n=4096 and 8192."""
    primes = sorted({int(p) for n in (4096, 8192) for p in BfvParams.create(n=n).bsk_primes
                     + BfvParams.create(n=n).q_primes})
    p = torch.tensor(primes, dtype=torch.int64).reshape(-1, 1)
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, 1 << 30, size=(len(primes), 64), dtype=np.int64))
    a[:, 0], a[:, 1] = (1 << 30) - 1, p[:, 0] - 1
    b = torch.from_numpy(rng.integers(0, 1 << 62, size=(len(primes), 64), dtype=np.int64)) % p
    b[:, 0], b[:, 2] = p[:, 0] - 1, p[:, 0] - 1
    got = modops.mulmod(a, b, p)
    want = [[int(x) * int(y) % q for x, y in zip(ra, rb)]
            for ra, rb, q in zip(a.tolist(), b.tolist(), primes)]
    assert got.tolist() == want


def test_chains_decrypt_to_golden_at_4096():
    """At n=4096 (fhetpu's own ct x ct test size) the depth-2 chains
    decrypt to the golden products: the unrelinearized triple product
    (size 4), the relinearized one and the relinearized cube (size 2)."""
    n = 4096
    par = BfvParams.create(n=n, t=T)
    kg = crypto.KeyGenerator(par, seed=51)
    enc = crypto.Encryptor(par, kg.public_key(), seed=52)
    rk = DeviceRelinKeys(kg.relin_keys(max_power=2, digit_bits=30))
    encoder = FractionalEncoder(T, n)
    ev = Evaluator(par, encoder, device="cpu")
    dec = crypto.Decryptor(par, kg.secret)
    plains = [encoder.encode(v) for v in (1.5, -2.0, 3.0)]
    p = [pl.coeffs for pl in plains]
    cts = [Ct(torch.from_numpy(enc.encrypt(pl)[None])) for pl in plains]
    triple = golden.mult(golden.mult(p[0], p[1], T), p[2], T)
    for ct, size in ((ev.multiply_many(cts), 4), (ev.multiply_many(cts, rk), 2)):
        assert ct.size == size
        assert np.array_equal(dec.decrypt_batch(_port(ct))[0], triple)
    cube = ev.exponentiate(cts[0], 3, rk)
    want = golden.mult(golden.mult(p[0], p[0], T), p[0], T)
    assert np.array_equal(dec.decrypt_batch(_port(cube))[0], want)
    assert abs(encoder.decode_batch(want[None])[0] - 1.5 ** 3) < 1e-6
