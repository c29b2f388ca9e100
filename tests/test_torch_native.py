"""The native chain of <= 28-bit primes (``BfvParams.create_native``)
against fhetpu's: the same primes and auxiliary base at every ring degree;
an encrypt -> add -> decrypt round trip at n = 8192; the lazy fused
kernel's plain version at m = 2 on native primes against fhetpu's lazy
kernel (interpret mode) and the strict plain version, and on a lane slice
of the n = 16384 native chain, where the SEAL chain refuses the lazy
kernel; and the headline's native28 block at a cut size (nb = 1, one call
in place of the timed chain).  Every comparison is exact; inputs come from
np.random.default_rng.  fhetpu's XLA server graph is never jitted here."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhetpu.bfv.encoder import FractionalEncoder as FFractionalEncoder
from fhetpu.bfv.evaluator import Evaluator as FEvaluator
from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.core import pallas_server

from fhetpu_torch.bench import headline
from fhetpu_torch.bfv import crypto
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Ct, Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.core import server_kernel

torch.set_num_threads(2)

T = 1 << 14
DEGREES = (2048, 4096, 8192, 16384)


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


def test_create_native_equals_fhetpu():
    """q, the BEHZ base and m_sk equal fhetpu's at every ring degree, with
    the SEAL chain's total bits; the lazy kernel gets m = 2 everywhere,
    where the SEAL chain gives 1 at n = 8192 and 0 at 16384."""
    for n in DEGREES:
        par, fpar, seal = BfvParams.create_native(n, T), FBfvParams.create_native(n, T), \
            BfvParams.create(n, T)
        assert (par.q_primes, par.b_primes, par.m_sk, par.dbc, par.sigma) == \
            (fpar.q_primes, fpar.b_primes, fpar.m_sk, fpar.dbc, fpar.sigma)
        assert len(par.b_primes) == par.L + 1
        assert all(p.bit_length() <= 28 for p in par.q_primes)
        assert sum(p.bit_length() for p in par.q_primes) == \
            sum(p.bit_length() for p in seal.q_primes)
        ours = server_kernel.lazy_bound_multiple(SimpleNamespace(params=par))
        theirs = pallas_server.lazy_bound_multiple(SimpleNamespace(params=fpar))
        assert ours == theirs == 2
    assert [BfvParams.create_native(16384, T).L, BfvParams.create(16384, T).L] == [16, 15]


def test_native_8192_roundtrip():
    """tests/test_bfv.py's native-chain round trip on the port: encrypt,
    add in the NTT domain, decrypt exactly; budget above 100 bits."""
    par, ref = BfvParams.create_native(n=8192, t=T), BfvParams.create(n=8192, t=T)
    assert sum(p.bit_length() for p in par.q_primes) == sum(p.bit_length() for p in ref.q_primes)
    assert par.L in (ref.L, ref.L + 1)
    kg = crypto.KeyGenerator(par, seed=21)
    enc = crypto.Encryptor(par, kg.public_key(), seed=22)
    dec = crypto.Decryptor(par, kg.secret)
    encoder = FractionalEncoder(T, par.n)
    ev = Evaluator(par, encoder, device="cpu")
    ca, cb = (ev.transform_to_ntt(Ct(torch.from_numpy(enc.encrypt(encoder.encode(v)))))
              for v in (12.25, -3.5))
    s = ev.transform_from_ntt(ev.add(ca, cb)).data.numpy()
    assert abs(encoder.decode(dec.decrypt(s)) - 8.75) < 1e-9
    assert dec.invariant_noise_budget(s) > 100


def test_lazy_m2_on_native_primes_equals_fhetpu_interpret():
    """At n = 2048 on the two largest primes of the n = 16384 native chain
    (28 bits: the least headroom the chain has), the lazy plain version at
    m = 2 equals fhetpu's lazy kernel in interpret mode and the strict
    plain version, on random inputs and on every input at p - 1."""
    n = 2048
    q = BfvParams.create_native(16384, T).q_primes[:2]
    assert all(p.bit_length() == 28 for p in q)
    base, fbase = BfvParams.create(n, T), FBfvParams.create(n, T)
    par = BfvParams(n=n, t=T, q_primes=q, b_primes=base.b_primes, m_sk=base.m_sk)
    fpar = FBfvParams(n=n, t=T, q_primes=q, b_primes=fbase.b_primes, m_sk=fbase.m_sk)
    ev = Evaluator(par, FractionalEncoder(T, n), device="cpu")
    fev = FEvaluator(fpar, FFractionalEncoder(T, n))
    assert server_kernel.lazy_bound_multiple(ev) == 2
    x = _residues(np.random.default_rng(61), q, (1, 3, 64, 2), n)
    top = np.broadcast_to(np.array(q, dtype=np.uint32).reshape(2, 1) - 1, (1, 3, 64, 2, 2, n))
    x = np.concatenate([x, top])
    want = np.asarray(pallas_server.server_ycc_dct_fused(fev, jnp.asarray(x), interpret=True,
                                                         lazy=True))
    state = ev.server_state()
    got = server_kernel.server_ycc_dct_lazy_plain(torch.from_numpy(x), state, 2)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(server_kernel.server_ycc_dct_plain(torch.from_numpy(x), state).numpy(),
                          want)


def test_lazy_m2_on_a_lane_slice_of_native_16384():
    """The n = 16384 native chain (L = 16, where the SEAL chain has no
    headroom): 256 lanes of each of three limbs (the largest, a middle and
    the smallest prime), random and at p - 1, through the lazy plain
    version at m = 2 (every intermediate checked below 2^32) and the strict
    one: equal."""
    n = 16384
    ev = Evaluator(BfvParams.create_native(n, T), FractionalEncoder(T, n), device="cpu")
    state = ev.server_state()
    lanes = torch.cat([torch.arange(li * n + 1000, li * n + 1256) for li in (0, 7, 15)])
    sliced = SimpleNamespace(consts=state.consts[:, lanes],
                             consts_shoup=state.consts_shoup[:, lanes])
    p = state.consts[server_kernel._P_ROW, lanes].to(torch.int64)
    gen = torch.Generator().manual_seed(62)
    rand = torch.randint(0, 1 << 62, (1, 3, 64, 2, 1, len(lanes)), generator=gen) % p
    x = torch.cat([rand, (p - 1).expand(1, 3, 64, 2, 1, len(lanes))]).to(torch.uint32)
    lazy = server_kernel.server_ycc_dct_lazy_plain(x, sliced, 2)
    assert torch.equal(lazy, server_kernel.server_ycc_dct_plain(x, sliced))


def test_headline_native28_block(monkeypatch):
    """The headline's native28 block at n = 8192, nb = 1 on the CPU (a cut
    of fhetpu's batch; one call of the op stands in for the timed chain):
    the lazy NTT-free op on the native chain (m = 2 against the SEAL
    chain's 1), with fhetpu's fields; none at n = 2048, where the chains
    give the same m."""
    calls = []

    def once(fn, x, label, device):  # one call of the op in place of a chain
        out = fn(x)
        calls.append((label, out.shape == x.shape, out.dtype))
        return 0.5, 1, 0.5

    monkeypatch.setattr(headline, "measure", once)
    monkeypatch.setattr(headline, "REPEATS", 1)
    cpu = torch.device("cpu")
    assert headline.native28_row(2048, 1, 2, cpu) is None
    row = headline.native28_row(8192, 1, 1, cpu)
    assert {"L", "m", "note", "variants", "channel_blocks_per_s", "vs_baseline"} <= set(row)
    assert (row["L"], row["m"], row["nb"]) == (8, 2, 1)
    assert row["bytes_in"] == 3 * 64 * 2 * 8 * 8192 * 4
    assert calls == [("n8192:native28_lazy_nttfree#0", True, torch.uint32)]
    v = row["variants"]["native28_lazy_nttfree"]
    assert v["ms_per_op_samples"] == [500.0] and v["channel_blocks_per_s"] == \
        row["channel_blocks_per_s"] == pytest.approx(3 / 0.5)
    assert row["vs_baseline"] == pytest.approx(
        row["channel_blocks_per_s"] * headline.BASELINE_DCT_MS[8192] / 1000)
