"""fhetpu_torch's server op against fhetpu: plaintext operands, server
constants, keys and ciphertexts, the evaluator's linear ops, the fused
kernel's plain version against fhetpu's fused Pallas kernel in interpret
mode, and the whole server op on a coefficient-form input.  Every
comparison is exact (tolerance 0); inputs come from np.random.default_rng.

fhetpu's XLA server graph is never jitted here (tens of seconds cold): the
reference is fhetpu's interpret-mode fused kernel between host NTTs, which
fhetpu's own tests hold bit-equal to that graph."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhetpu.bfv import crypto as f_crypto
from fhetpu.bfv.encoder import FractionalEncoder
from fhetpu.bfv.evaluator import Ct as FCt
from fhetpu.bfv.evaluator import Evaluator as FEvaluator
from fhetpu.bfv.golden import GoldenEvaluator
from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.core import ntt as f_ntt
from fhetpu.core import pallas_server
from fhetpu.io import images

from fhetpu_torch.bfv import crypto
from fhetpu_torch.bfv.evaluator import Ct, Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.convert import server_arrays, server_state_from_numpy
from fhetpu_torch.core import ntt, ntt_kernel, server_kernel
from fhetpu_torch.pipelines import jpeg_encode as pipe

torch.set_num_threads(2)

N, T = 2048, 1 << 14


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


def _fhetpu_arrays(ev):
    """server_state_from_numpy's arrays built by fhetpu's own functions."""
    par, tq = ev.params, ev.params.tables_q
    consts, consts_shoup = pallas_server.pack_server_constants(ev)
    return {
        "q_primes": np.asarray(par.q_primes, dtype=np.uint64), "n": par.n, "t": par.t,
        "n_number_coeffs": ev.encoder.n_int, "n_fractional_coeffs": ev.encoder.n_frac,
        "base": ev.encoder.base, "consts": consts, "consts_shoup": consts_shoup,
        "psi_br": tq.psi_br, "psi_br_shoup": tq.psi_br_shoup, "ipsi_br": tq.ipsi_br,
        "ipsi_br_shoup": tq.ipsi_br_shoup, "n_inv": tq.n_inv, "n_inv_shoup": tq.n_inv_shoup,
    }


@pytest.fixture(scope="module")
def fused_ref():
    """One coefficient-form input at n=2048, nb=1, its host NTT, and
    fhetpu's interpret-mode fused kernel on it (run once, ~8 s)."""
    fpar = FBfvParams.create(n=N, t=T)
    fev = FEvaluator(fpar, FractionalEncoder(T, N))
    rng = np.random.default_rng(11)
    x_coef = _residues(rng, fpar.q_primes, (1, 3, 64, 2), N)
    x_ntt = f_ntt.np_ntt(x_coef, fpar.tables_q)
    out_ntt = np.asarray(pallas_server.server_ycc_dct_fused(
        fev, jnp.asarray(x_ntt), interpret=True))
    ev = Evaluator(BfvParams.create(n=N, t=T), FractionalEncoder(T, N), device="cpu")
    return fev, ev, x_coef, x_ntt, out_ntt


@pytest.mark.parametrize("n", [2048, 4096])
def test_server_constants_and_operands_equal_fhetpu(n):
    enc = FractionalEncoder(T, n)
    fev = FEvaluator(FBfvParams.create(n=n, t=T), enc)
    ev = Evaluator(BfvParams.create(n=n, t=T), enc, device="cpu")
    for got, want in zip(server_kernel.pack_server_constants(ev),
                         pallas_server.pack_server_constants(fev)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for v in (0.299, -1.847759065, 0.125, 128.0):
        a, b = ev.encode(v), fev.encode(v)
        for f in ("mul_ntt", "mul_ntt_shoup", "add_ntt", "add_coeff"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (v, f)
    ours, ref = server_arrays(ev), _fhetpu_arrays(fev)
    assert ours.keys() == ref.keys()
    for k in ours:
        assert np.array_equal(np.asarray(ours[k]), np.asarray(ref[k])), k


def test_keys_and_ciphertexts_equal_fhetpu():
    rng = np.random.default_rng(5)
    coeffs = rng.integers(0, T, size=(3, N), dtype=np.int64)
    fpar, par = FBfvParams.create(n=N, t=T), BfvParams.create(n=N, t=T)
    fkg, kg = f_crypto.KeyGenerator(fpar, seed=5), crypto.KeyGenerator(par, seed=5)
    assert np.array_equal(kg.secret.small, fkg.secret.small)
    assert np.array_equal(kg.public_key().data, fkg.public_key().data)
    got = crypto.Encryptor(par, kg.public_key(), seed=6).encrypt_batch(coeffs)
    want = f_crypto.Encryptor(fpar, fkg.public_key(), seed=6).encrypt_batch(coeffs)
    assert np.array_equal(got, want)
    assert np.array_equal(crypto.centered_lift_plain(coeffs, par),
                          f_crypto.centered_lift_plain(coeffs, fpar))
    dec = crypto.Decryptor(par, kg.secret)
    fdec = f_crypto.Decryptor(fpar, fkg.secret)
    for ntt_form, cts in ((False, got), (True, f_ntt.np_ntt(got, fpar.tables_q))):
        plain = dec.decrypt_batch(cts, ntt_form=ntt_form)
        assert np.array_equal(plain, fdec.decrypt_batch(cts, ntt_form=ntt_form))
        assert np.array_equal(plain, coeffs)


def test_evaluator_ops_match_fhetpu(fused_ref):
    """Each linear op on random NTT-form and coefficient-form cts, against
    fhetpu's evaluator run eagerly (no jit)."""
    fev, ev, x_coef, x_ntt, _ = fused_ref
    a_np, b_np = x_ntt[0, 0, :4], x_ntt[0, 1, :4]  # [4, 2, L, n]
    a, b = Ct(torch.from_numpy(a_np), True), Ct(torch.from_numpy(b_np), True)
    fa, fb = FCt(jnp.asarray(a_np), True), FCt(jnp.asarray(b_np), True)
    op, fop = ev.encode(-0.168736), fev.encode(-0.168736)
    pairs = [
        (ev.add(a, b), fev.add(fa, fb)),
        (ev.sub(a, b), fev.sub(fa, fb)),
        (ev.negate(a), fev.negate(fa)),
        (ev.add_plain(a, op), fev.add_plain(fa, fop)),
        (ev.sub_plain(a, op), fev.sub_plain(fa, fop)),
        (ev.multiply_plain(a, op), fev.multiply_plain(fa, fop)),
        (ev.lincomb([(a, op), (b, None)]), fev.lincomb([(fa, fop), (fb, None)])),
    ]
    for i, (got, want) in enumerate(pairs):
        assert got.ntt_form == want.ntt_form, i
        assert np.array_equal(got.data.to(torch.int64).numpy(),
                              np.asarray(want.data).astype(np.int64)), i
    # coefficient form: the domain transforms and multiply_plain through the
    # NTT, against fhetpu's host transforms
    tq = fev.params.tables_q
    c = Ct(torch.from_numpy(x_coef[0, 0, :4]), False)
    assert np.array_equal(ev.transform_to_ntt(c).data.numpy(), f_ntt.np_ntt(x_coef[0, 0, :4], tq))
    assert np.array_equal(ev.transform_from_ntt(a).data.numpy(), f_ntt.np_intt(a_np, tq))
    want = f_ntt.np_intt(f_ntt.np_pointwise_mulmod(
        f_ntt.np_ntt(x_coef[0, 0, :4], tq), fop.mul_ntt, tq), tq)
    assert np.array_equal(ev.multiply_plain(c, op).data.numpy(), want)
    # a size-2 ct plus a size-3 ct pads the smaller, as fhetpu does
    big = np.concatenate([a_np, b_np[:, :1]], axis=1)
    got = ev.add(a, Ct(torch.from_numpy(big), True)).data.numpy()
    assert np.array_equal(got, np.asarray(fev.add(fa, FCt(jnp.asarray(big), True)).data))


def test_server_plain_matches_fhetpu_fused_kernel(fused_ref):
    """server_ycc_dct_plain, fed fhetpu's own tables through
    server_state_from_numpy, equals fhetpu's fused kernel (interpret)."""
    fev, _, _, x_ntt, out_ntt = fused_ref
    state = server_state_from_numpy(_fhetpu_arrays(fev), "cpu")
    got = server_kernel.server_ycc_dct_plain(torch.from_numpy(x_ntt), state)
    assert got.dtype == torch.uint32 and tuple(got.shape) == out_ntt.shape
    assert np.array_equal(got.numpy(), out_ntt)
    # and the NTT kernel's plain versions on the same state's tables
    x = torch.from_numpy(x_ntt)
    back = ntt_kernel.intt_plain(x, state.ntt)
    assert np.array_equal(ntt_kernel.ntt_plain(back, state.ntt).numpy(), x_ntt)


def test_strict_kernel_schedule_matches_fhetpu_fused_kernel(fused_ref):
    """The NumPy emulation of the strict CUDA kernel's schedule
    (tests/test_torch_server_schedule.py), on fhetpu's own tables, gives
    fhetpu's fused kernel's bits (interpret mode, the fixture's run)."""
    from test_torch_server_schedule import emulate_strict_kernel

    fev, _, _, x_ntt, out_ntt = fused_ref
    consts, consts_shoup = pallas_server.pack_server_constants(fev)
    assert np.array_equal(emulate_strict_kernel(x_ntt, consts, consts_shoup), out_ntt)


def test_server_op_matches_fhetpu(fused_ref):
    """The whole server op on a coefficient-form input (NTT, fused, INTT on
    the port's own tables) equals fhetpu's np_ntt -> fused -> np_intt; on a
    CPU tensor no kernel launch is counted."""
    fev, ev, x_coef, _, out_ntt = fused_ref
    before = (server_kernel.server_ycc_dct_fused.launches,
              ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches)
    got = pipe.server_compute_fn(ev)(torch.from_numpy(x_coef))
    assert np.array_equal(got.numpy(), f_ntt.np_intt(out_ntt, fev.params.tables_q))
    got_ntt = pipe.server_compute_fn(ev, input_ntt=True, output_ntt=True)(
        torch.from_numpy(f_ntt.np_ntt(x_coef, fev.params.tables_q)))
    assert np.array_equal(got_ntt.numpy(), out_ntt)
    assert before == (server_kernel.server_ycc_dct_fused.launches,
                      ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches)


@pytest.mark.parametrize("input_ntt,output_ntt", [(True, False), (False, True), (True, True)],
                         ids=["ntt-in", "ntt-out", "ntt-both"])
@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quantize"])
def test_server_op_domains_agree(fused_ref, quantize, input_ntt, output_ntt):
    """The server op in any mix of stream forms gives the coefficient-form
    op's bits: fed np_ntt(x) where input_ntt is set, its output equals the
    coefficient-form output, put through np_ntt where output_ntt is set;
    with quantize off (the fused kernel's plain version) and on (torch YCC,
    the DCT-only kernel's plain version, torch quantize)."""
    from fhetpu_torch.codec.jpeg import ZIGZAG, build_quant_tables

    _, ev, x_coef, _, _ = fused_ref
    tq = ev.params.tables_q
    kw = dict(apply_quantize=quantize, quant=build_quant_tables(50)[0][ZIGZAG].astype(np.float64))
    want = pipe.server_compute_fn(ev, **kw)(torch.from_numpy(x_coef)).numpy()
    x = ntt.np_ntt(x_coef, tq) if input_ntt else x_coef
    got = pipe.server_compute_fn(ev, input_ntt=input_ntt, output_ntt=output_ntt, **kw)(
        torch.from_numpy(x))
    assert got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), ntt.np_ntt(want, tq) if output_ntt else want)


def test_evaluator_network_equals_fused_plain(fused_ref):
    """rgb_to_ycc + dct8x8 on the evaluator's torch ops (the quantize path's
    network) gives the fused op's residues."""
    _, ev, _, x_ntt, out_ntt = fused_ref
    d = torch.from_numpy(x_ntt)
    y, cb, cr = pipe.rgb_to_ycc(ev, Ct(d[:, 0], True), Ct(d[:, 1], True), Ct(d[:, 2], True))
    for ci, chan in enumerate((y, cb, cr)):
        slots = pipe.dct8x8(ev, [Ct(chan.data[:, k], True) for k in range(64)])
        got = torch.stack([s.data for s in slots], dim=1).numpy()
        assert np.array_equal(got, out_ntt[:, ci].astype(np.int64)), ci


def test_quantize_path_decrypts_to_golden():
    """--quantize runs the evaluator's ops; an encrypted 8x8 block decrypts
    to the golden oracle's quantized DCT exactly."""
    from fhetpu.codec.jpeg import ZIGZAG, build_quant_tables

    par = BfvParams.create(n=N, t=T)
    kg = crypto.KeyGenerator(par, seed=7)
    enc = crypto.Encryptor(par, kg.public_key(), seed=8)
    encoder = FractionalEncoder(T, N)
    ev = Evaluator(par, encoder, device="cpu")
    img = np.random.default_rng(12).integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    blocks = np.stack([images.split_blocks(img[..., c].astype(np.float64))
                       for c in range(3)], axis=1)  # [1, 3, 64]
    coeffs = encoder.encode_batch(blocks)
    cts = enc.encrypt_batch(coeffs.reshape(-1, N)).reshape(1, 3, 64, 2, par.L, N)
    ytab, _ = build_quant_tables(50)
    quant = ytab[ZIGZAG].astype(np.float64)
    out = pipe.server_compute_fn(ev, apply_quantize=True, quant=quant)(torch.from_numpy(cts))
    got = crypto.Decryptor(par, kg.secret).decrypt_batch(
        out.numpy().reshape(-1, 2, par.L, N)).reshape(1, 3, 64, N)
    gev = GoldenEvaluator(encoder)
    ycc = pipe.rgb_to_ycc(gev, coeffs[:, 0], coeffs[:, 1], coeffs[:, 2])
    for ci, chan in enumerate(ycc):
        slots = pipe.quantize(gev, pipe.dct8x8(gev, [chan[:, k] for k in range(64)]), quant)
        assert np.array_equal(got[:, ci], np.stack(slots, axis=1)), ci
