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
from fhetpu_torch.core import behz_kernel, modops

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


_M32 = np.uint64(0xFFFFFFFF)


def _fold(r, p):
    return np.minimum(r, (r - p) & _M32)


def _lazy_mul(x, pair, p):
    w, ws = pair
    return (x * w - ((x * ws) >> np.uint64(32)) * p) & _M32


def _lazy_sub(a, b, p):
    return _fold(_fold((a + 2 * p - b) & _M32, 2 * p), p)


def _emulate_floor_convert(words, L, xq, xb):
    """csrc/behz_floor_convert.cu's arithmetic, word for word, on uint64
    arrays holding 32-bit values: reads the packed table at the kernel's
    offsets (Layout), so the packing is checked with the algebra."""
    K, nb = L + 2, L + 1
    words = words.astype(np.uint64)
    qp, bp = words[:L], words[L:L + K]
    pr = words[L + K:].reshape(-1, 2)
    kA, kU = 0, L
    kV = kU + K
    kG = kV + L * K
    kE = kG + nb
    kBQ = kE + nb * L
    kNBQ = kBQ + L
    assert len(pr) == kNBQ + L
    msk = bp[K - 1]
    zq = [_fold(_lazy_mul(xq[:, i], pr[kA + i], qp[i]), qp[i]) for i in range(L)]
    zb = []
    for k in range(K):
        f = np.zeros_like(xq[:, 0])
        for i in range(L):
            f = _fold(f + _lazy_mul(zq[i], pr[kV + i * K + k], bp[k]), 2 * bp[k])
        zb.append(_lazy_sub(_lazy_mul(xb[:, k], pr[kU + k], bp[k]), f, bp[k]))
    acc = np.zeros_like(xq[:, 0])
    for j in range(nb):
        acc = _fold(acc + _lazy_mul(zb[j], pr[kG + j], msk), 2 * msk)
    alpha = _lazy_sub(acc, zb[K - 1], msk)
    neg = alpha >= (msk >> np.uint64(1))
    am = np.where(neg, msk - alpha, alpha)
    out = []
    for i in range(L):
        w = np.where(neg, pr[kBQ + i][0], pr[kNBQ + i][0])
        ws = np.where(neg, pr[kBQ + i][1], pr[kNBQ + i][1])
        y = _lazy_mul(am, (w, ws), qp[i])
        for j in range(nb):
            y = _fold(y + _lazy_mul(zb[j], pr[kE + j * L + i], qp[i]), 2 * qp[i])
        out.append(_fold(y, qp[i]))
    return np.stack(out, axis=1), alpha


CHAINS = [(n, False) for n in (2048, 4096, 8192, 16384)] + [(n, True) for n in (2048, 4096, 8192, 16384)]


def _check_packed(bc, words, parts):
    """The packed words: the q and Bsk primes, then every constant below its
    modulus beside its exact Shoup companion, in ``parts``' order."""
    assert words.dtype == np.uint32
    assert words[:bc.L + bc.K].tolist() == [int(p) for p in np.r_[bc.qp.ravel(), bc.bskp.ravel()]]
    pairs = words[bc.L + bc.K:].reshape(-1, 2).astype(object)
    at = 0
    for name, w, p in parts:
        assert w.shape == p.shape and (w >= 0).all() and (w < p).all(), name
        for (wi, si), x, q in zip(pairs[at:at + w.size], w.reshape(-1), p.reshape(-1)):
            assert wi == x and si == (int(x) << 32) // int(q), name
        at += w.size
    assert at == len(pairs)


@pytest.mark.parametrize("n,native", CHAINS, ids=[f"{'native' if v else 'seal'}-{n}" for n, v in CHAINS])
def test_floor_convert_kernel_tables(n, native):
    """The BEHZ floor-convert kernel's host table for the chooser's chains:
    every constant below its prime with its exact Shoup companion, (L, K)
    within the kernel's limits, the packed words at the kernel's size; and
    the kernel's arithmetic, emulated on the packed words, gives
    convert_bsk_to_q(scale_floor_to_bsk(t x_q, t x_bsk)) on random
    residues, on 0 and p - 1 in every base, and at both sides of alpha's
    centring."""
    par = (BfvParams.create_native if native else BfvParams.create)(n=n, t=T)
    bc = rns.get_behz(par)
    assert par.L in behz_kernel.KERNEL_L and bc.K == par.L + 2
    behz_kernel.check_limits(bc.L, bc.K, tuple(par.q_primes) + par.bsk_primes)
    parts = behz_kernel.table_parts(bc)
    words = behz_kernel.pack_table(bc, parts)
    _check_packed(bc, words, parts)
    # inputs: random, all 0, all p - 1, and a random row of each
    rng = np.random.default_rng(n + native)
    qp = np.asarray(par.q_primes, dtype=np.uint64).reshape(1, -1, 1)
    bp = np.asarray(par.bsk_primes, dtype=np.uint64).reshape(1, -1, 1)
    m, cols = 4, 256
    xq = rng.integers(0, 1 << 62, size=(m, par.L, cols), dtype=np.uint64) % qp
    xb = rng.integers(0, 1 << 62, size=(m, bc.K, cols), dtype=np.uint64) % bp
    xq[1], xb[1] = 0, 0
    xq[2], xb[2] = (qp - 1)[0], (bp - 1)[0]
    tool = rns.RnsTool(par, "cpu")
    tq, tb = torch.from_numpy(xq.astype(np.int64)), torch.from_numpy(xb.astype(np.int64))
    tx_q = modops.mulmod(tq, tool.t_mod_q, tool.qp)
    want = tool.convert_bsk_to_q(tool.scale_floor_to_bsk(tx_q, modops.mulmod(tb, tool.t_mod_bsk, tool.bp)))
    got, alpha = _emulate_floor_convert(words, par.L, xq, xb)
    assert np.array_equal(got.astype(np.int64), want.numpy())
    half = par.m_sk // 2
    assert (alpha < half).any() and (alpha >= half).any()


_MT = np.uint64(1 << 16)


def _emulate_extend(words, L, x):
    """csrc/behz_extend.cu's arithmetic, word for word, on uint64 arrays
    holding 32-bit values: reads the packed table at the kernel's offsets
    (ExtendLayout).  Returns the Bsk residues and r before its centring."""
    K = L + 2
    words = words.astype(np.uint64)
    qp, bp = words[:L], words[L:L + K]
    pr = words[L + K:].reshape(-1, 2)
    kA, kV = 0, L
    kQM = kV + L * K
    kNQM = kQM + K
    kR = kNQM + K
    assert len(pr) == kR + L
    z = [_fold(_lazy_mul(x[:, i], pr[kA + i], qp[i]), qp[i]) for i in range(L)]
    r = np.zeros_like(x[:, 0])
    for i in range(L):
        r = (r + z[i] * pr[kR + i][0]) & _M32
    r &= _MT - np.uint64(1)
    neg = r >= _MT // np.uint64(2)
    ra = np.where(neg, _MT - r, r)
    out = []
    for k in range(K):
        w = np.where(neg, pr[kNQM + k][0], pr[kQM + k][0])
        ws = np.where(neg, pr[kNQM + k][1], pr[kQM + k][1])
        acc = _lazy_mul(ra, (w, ws), bp[k])
        for i in range(L):
            acc = _fold(acc + _lazy_mul(z[i], pr[kV + i * K + k], bp[k]), 2 * bp[k])
        out.append(_fold(acc, bp[k]))
    return np.stack(out, axis=1), r


def _with_r(bc, x, targets):
    """x with its first q residue chosen so that the extension's r (before
    centring) is ``targets`` ([m], the same at every coefficient)."""
    L, mt = bc.L, bc.m_tilde
    qp, qhat_inv = [int(p) for p in bc.qp.ravel()], [int(v) for v in bc.qhat_inv_mod_q.ravel()]
    a = [int(m) * h % p for m, h, p in zip(bc.m_tilde_mod_q.ravel(), qhat_inv, qp)]
    rw = [int(v) * bc.neg_q_inv_mod_mtilde % mt for v in bc.q_over_pi_mod_mtilde]
    z = [x[:, i].astype(object) * a[i] % qp[i] for i in range(L)]
    rest = sum(z[i] * rw[i] for i in range(1, L))
    z0 = (np.asarray(targets, dtype=object)[:, None] - rest) * pow(rw[0], -1, mt) % mt
    x = x.copy()
    x[:, 0] = (z0 * pow(a[0], -1, qp[0]) % qp[0]).astype(np.uint64)
    return x


@pytest.mark.parametrize("n,native", CHAINS, ids=[f"{'native' if v else 'seal'}-{n}" for n, v in CHAINS])
def test_extend_kernel_tables(n, native):
    """The BEHZ extension kernel's host table for the chooser's chains:
    every folded constant below its modulus with its exact Shoup companion,
    the packed words at the kernel's size; and the kernel's arithmetic,
    emulated on the packed words, gives extend_q_to_bsk exactly on random
    residues, on 0 and p - 1, and with r at 0, m~/2 - 1, m~/2 and m~ - 1 (the
    first q residue chosen), so on both sides of its centring."""
    par = (BfvParams.create_native if native else BfvParams.create)(n=n, t=T)
    bc = rns.get_behz(par)
    behz_kernel.check_limits(bc.L, bc.K, tuple(par.q_primes) + par.bsk_primes)
    parts = behz_kernel.extend_parts(bc)
    words = behz_kernel.pack_table(bc, parts)
    _check_packed(bc, words, parts)
    rng = np.random.default_rng(n + 2 * native)
    qp = np.asarray(par.q_primes, dtype=np.uint64).reshape(1, -1, 1)
    m, cols = 7, 256
    x = rng.integers(0, 1 << 62, size=(m, par.L, cols), dtype=np.uint64) % qp
    x[1] = 0
    x[2] = (qp - 1)[0]
    x[3:] = _with_r(bc, x[3:], [0, bc.m_tilde // 2 - 1, bc.m_tilde // 2, bc.m_tilde - 1])
    want = rns.RnsTool(par, "cpu").extend_q_to_bsk(torch.from_numpy(x.astype(np.int64)))
    got, r = _emulate_extend(words, par.L, x)
    assert np.array_equal(got.astype(np.int64), want.numpy())
    assert (r[3:].T == np.array([0, 2**15 - 1, 2**15, 2**16 - 1], dtype=np.uint64)).all()
    half = np.uint64(bc.m_tilde // 2)
    assert (r[0] < half).any() and (r[0] >= half).any()


def _mulhi64(x, m):
    """The high 64 bits of x * m for uint64 arrays (CUDA's __umul64hi), from
    32-bit limbs."""
    s = np.uint64(32)
    xl, xh, ml, mh = x & _M32, x >> s, m & _M32, m >> s
    ll, lh, hl, hh = xl * ml, xl * mh, xh * ml, xh * mh
    mid = (ll >> s) + (lh & _M32) + (hl & _M32)
    return hh + (lh >> s) + (hl >> s) + (mid >> s)


def _emulate_tensor(words, L, a_q, a_b, b_q, b_b, square=False):
    """csrc/behz_tensor.cu's indexing and arithmetic on uint64 arrays: each
    output batch entry found in the operands through tensor_plan's merged
    axes and strides, then per prime row uint64 sums of exact products,
    reduced once by Barrett on the packed words (tensor_words) in 32-bit
    words, and folded."""
    K, R = L + 2, 2 * L + 2
    w = words.astype(np.uint64)
    primes, mus = w[:R], w[R::2] | (w[R + 1::2] << np.uint64(32))
    assert len(w) == 3 * R
    k1, k2, n = a_q.shape[-3], b_q.shape[-3], a_q.shape[-1]
    bshape, sizes, sa, sb = behz_kernel.tensor_plan(a_q.shape[:-3], b_q.shape[:-3])
    kout, B = k1 + k2 - 1, int(np.prod(bshape))
    a = [x.reshape(-1, k1, x.shape[-2], n) for x in (a_q, a_b)]
    b = [x.reshape(-1, k2, x.shape[-2], n) for x in (b_q, b_b)]
    out = [np.zeros((B, kout, L, n), np.uint64), np.zeros((B, kout, K, n), np.uint64)]
    for bi in range(B):
        left, ea, eb = bi, 0, 0
        for size, xa, xb in zip(sizes, sa, sb):
            i, left = left % size, left // size
            ea, eb = ea + i * xa, eb + i * xb
        for row in range(R):
            base, rr = (0, row) if row < L else (1, row - L)
            x = a[base][ea, :, rr]
            y = x if square else b[base][eb, :, rr]
            p, m = primes[row], mus[row]
            for r in range(kout):
                acc = np.zeros(n, np.uint64)
                for i in range(max(0, r - k2 + 1), min(k1, r + 1)):
                    acc += x[i] * y[r - i]
                out[base][bi, r, rr] = _fold((acc - _mulhi64(acc, m) * p) & _M32, p)
    return (out[0].reshape(bshape + (kout, L, n)), out[1].reshape(bshape + (kout, K, n)))


@pytest.mark.parametrize("L", [4, 8])
@pytest.mark.parametrize("k1,k2", [(2, 2), (3, 2), (2, 3), (5, 4)])
def test_tensor_kernel_arithmetic(L, k1, k2):
    """The BEHZ tensor kernel's arithmetic and indexing, emulated on its
    packed table, equal the torch loop (rns.tensor_product) on both bases:
    operands of batch [3, 1, 2] and [4, 1] broadcast to [3, 4, 2] (three
    unmerged axes, one operand of lower rank), one batch entry of each
    operand and one coefficient column all at p - 1; and the square of the
    first operand, read once."""
    par = BfvParams.create(n={4: 4096, 8: 8192}[L], t=T)
    bc = rns.get_behz(par)
    assert bc.L == L
    behz_kernel.check_limits(L, bc.K, tuple(par.q_primes) + par.bsk_primes, min(k1, k2))
    words = behz_kernel.tensor_words(bc)
    tool = rns.RnsTool(par, "cpu")
    rng = np.random.default_rng(100 * L + 10 * k1 + k2)
    cols = 32

    def operand(batch, k):
        xs = []
        for primes in (par.q_primes, par.bsk_primes):
            p = np.asarray(primes, dtype=np.uint64).reshape(-1, 1)
            x = rng.integers(0, 1 << 62, size=batch + (k, len(primes), cols), dtype=np.uint64) % p
            x.reshape((-1,) + x.shape[-3:])[0] = p - np.uint64(1)
            x[..., 3] = (p - np.uint64(1))[:, 0]
            xs.append(x)
        return xs

    a, b = operand((3, 1, 2), k1), operand((4, 1), k2)
    t = [torch.from_numpy(x.astype(np.int64)) for x in a + b]
    for got, want in ((_emulate_tensor(words, L, *a, *b),
                       rns.tensor_product(*t, tool)),
                      (_emulate_tensor(words, L, *a, *a, square=True),
                       rns.tensor_product(t[0], t[1], t[0], t[1], tool))):
        for g, w in zip(got, want):
            assert g.shape == tuple(w.shape)
            assert np.array_equal(g.astype(np.int64), w.numpy())


def test_tensor_kernel_limits_and_plan():
    """check_limits refuses a base the BEHZ kernels cannot take and sizes
    whose tensor sums could pass 2^64: at most 16 products of residues below
    2^30 fit in 64 bits, 17 of the largest do not.  tensor_words holds each
    prime beside floor(2^64 / p); tensor_plan merges the resize's broadcast
    batch axes as the kernel reads them."""
    par = BfvParams.create(n=8192, t=T)
    primes = tuple(par.q_primes) + par.bsk_primes
    behz_kernel.check_limits(8, 10, primes, 16)
    top = (1 << 30) - 35
    assert 16 * (top - 1) ** 2 < 1 << 64 <= 17 * (top - 1) ** 2
    behz_kernel.check_limits(8, 10, primes + (top,), 16)
    with pytest.raises(ValueError, match="overflow"):
        behz_kernel.check_limits(8, 10, primes + (top,), 17)
    with pytest.raises(ValueError, match="2\\^30"):
        behz_kernel.check_limits(8, 10, primes + (1 << 30,), 1)
    with pytest.raises(ValueError, match="L in"):
        behz_kernel.check_limits(8, 11, primes, 2)
    words = behz_kernel.tensor_words(rns.get_behz(par)).astype(object)
    R = len(primes)
    assert words[:R].tolist() == list(primes)
    assert [lo | hi << 32 for lo, hi in words[R:].reshape(-1, 2)] == [(1 << 64) // p
                                                                       for p in primes]
    plan = behz_kernel.tensor_plan
    assert plan((1, 17, 1), (17, 17, 3)) == ((17, 17, 3), [3, 17, 17], [0, 1, 0], [1, 3, 51])
    assert plan((17, 17, 3), (17, 1, 1)) == ((17, 17, 3), [51, 17], [1, 51], [0, 1])
    assert plan((4, 17, 3), (4, 17, 3)) == ((4, 17, 3), [204], [1], [1])
    assert plan((), (2,)) == ((2,), [2], [0], [1])
    assert plan((), ()) == ((), [], [], [])
