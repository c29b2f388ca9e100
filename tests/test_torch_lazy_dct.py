"""fhetpu_torch's last two kernels against fhetpu's Pallas kernels in
interpret mode: the DCT-only kernel's plain version (``dct8x8_plain``, the
``--quantize`` path's DCT) against ``dct8x8_pallas``, and the lazy fused
kernel's plain version against ``_make_lazy_kernel(m)`` at m = 2 and m = 1;
the headroom rule and its ValueError; the constant rows the DCT kernel
shares with the fused kernel; and the ``--quantize`` server op through the
DCT kernel's wrapper on a CPU tensor.  Every comparison is exact (tolerance
0); inputs come from np.random.default_rng.  fhetpu's XLA server graph is
never jitted here."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhetpu.bfv.encoder import FractionalEncoder as FFractionalEncoder
from fhetpu.bfv.evaluator import Evaluator as FEvaluator
from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.core import pallas_dct, pallas_server
from fhetpu.core.primes import gen_ntt_primes

from fhetpu_torch.bfv import crypto
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Ct, Evaluator
from fhetpu_torch.bfv.golden import GoldenEvaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.codec.jpeg import ZIGZAG, build_quant_tables
from fhetpu_torch.core import dct_kernel, modops, server_kernel
from fhetpu_torch.io import images
from fhetpu_torch.pipelines import jpeg_encode as pipe

torch.set_num_threads(2)

N, T = 2048, 1 << 14


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


def _pair(q_bits=None):
    """fhetpu's and the port's evaluator at n=2048, on the default primes
    or on two q_bits-bit primes (as tests/test_jpeg_pipeline.py builds its
    m=1 case)."""
    fpar, par = FBfvParams.create(n=N, t=T), BfvParams.create(n=N, t=T)
    if q_bits is not None:
        q = tuple(gen_ntt_primes(q_bits, 2))
        fpar = FBfvParams(n=N, t=T, q_primes=q, b_primes=fpar.b_primes, m_sk=fpar.m_sk)
        par = BfvParams(n=N, t=T, q_primes=q, b_primes=par.b_primes, m_sk=par.m_sk)
    return (FEvaluator(fpar, FFractionalEncoder(T, N)),
            Evaluator(par, FractionalEncoder(T, N), device="cpu"))


@pytest.fixture(scope="module")
def default_pair():
    return _pair()


def test_dct_plain_matches_fhetpu_pallas_interpret(default_pair):
    """dct8x8_plain on the port's own tables equals fhetpu's DCT-only Pallas
    kernel (interpret mode); the wrapper runs it on a CPU tensor without
    counting a launch."""
    fev, ev = default_pair
    x = _residues(np.random.default_rng(41), ev.params.q_primes, (1, 3, 64, 2), N)
    want = np.asarray(pallas_dct.dct8x8_pallas(fev, jnp.asarray(x), interpret=True))
    got = dct_kernel.dct8x8_plain(torch.from_numpy(x), ev.server_state())
    assert got.dtype == torch.uint32 and np.array_equal(got.numpy(), want)
    before = dct_kernel.dct8x8_kernel.launches
    assert np.array_equal(dct_kernel.dct8x8_kernel(ev, torch.from_numpy(x)).numpy(), want)
    assert dct_kernel.dct8x8_kernel.launches == before


def test_server_table_rows_equal_pack_dct_constants(default_pair):
    """Rows 0..12 and 22 of the fused kernel's table, which the DCT kernel
    reads, hold the residues of fhetpu's pack_dct_constants and moduli."""
    fev, ev = default_pair
    L = ev.params.L
    consts, shoup = server_kernel.pack_server_constants(ev)
    dmul, dsh = pallas_dct.pack_dct_constants(fev)  # [L, 16, 2n], poly-duplicated
    for ours, ref in ((consts, dmul), (shoup, dsh)):
        rows = ours[:13].reshape(13, L, N).transpose(1, 0, 2)  # [L, 13, n]
        assert np.array_equal(rows, ref[:, :13, :N])
        assert np.array_equal(rows, ref[:, :13, N:])
    p_lane = np.repeat(np.asarray(fev.params.consts.qp).reshape(L), N)
    assert np.array_equal(consts[22], p_lane)


@pytest.mark.parametrize("q_bits,m", [(None, 2), (29, 1)], ids=["default-m2", "29bit-m1"])
def test_lazy_plain_matches_fhetpu_lazy_interpret(q_bits, m, default_pair):
    """server_ycc_dct_lazy_plain equals fhetpu's lazy kernel (interpret
    mode) and the strict plain version; server_compute_fn(fused_lazy=True)
    runs it on a CPU tensor."""
    fev, ev = default_pair if q_bits is None else _pair(q_bits)
    assert server_kernel.lazy_bound_multiple(ev) == pallas_server.lazy_bound_multiple(fev) == m
    x = _residues(np.random.default_rng(42), ev.params.q_primes, (1, 3, 64, 2), N)
    want = np.asarray(pallas_server.server_ycc_dct_fused(
        fev, jnp.asarray(x), interpret=True, lazy=True))
    state = ev.server_state()
    got = server_kernel.server_ycc_dct_lazy_plain(torch.from_numpy(x), state, m)
    assert got.dtype == torch.uint32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(server_kernel.server_ycc_dct_plain(torch.from_numpy(x), state).numpy(),
                          want)
    before = server_kernel.server_ycc_dct_fused.lazy_launches
    op = pipe.server_compute_fn(ev, input_ntt=True, output_ntt=True, fused_lazy=True)
    assert np.array_equal(op(torch.from_numpy(x)).numpy(), want)
    assert server_kernel.server_ycc_dct_fused.lazy_launches == before


@pytest.mark.parametrize("n", [2048, 4096, 8192, 16384])
def test_lazy_bound_multiple_equals_fhetpu(n):
    got = server_kernel.lazy_bound_multiple(SimpleNamespace(params=BfvParams.create(n=n, t=T)))
    want = pallas_server.lazy_bound_multiple(SimpleNamespace(params=FBfvParams.create(n=n, t=T)))
    assert got == want == {2048: 2, 4096: 2, 8192: 1, 16384: 0}[n]


def test_lazy_raises_where_fhetpu_does():
    """30-bit primes leave under 8p of u32 headroom: both packages refuse
    the lazy kernel with ValueError, and so does the port at n=16384's
    default chain."""
    fev, ev = _pair(30)
    x = _residues(np.random.default_rng(43), ev.params.q_primes, (1, 3, 64, 2), N)
    with pytest.raises(ValueError, match="headroom"):
        pallas_server.server_ycc_dct_fused(fev, jnp.asarray(x), interpret=True, lazy=True)
    with pytest.raises(ValueError, match="headroom"):
        server_kernel.server_ycc_dct_fused(ev, torch.from_numpy(x), lazy=True)
    with pytest.raises(ValueError, match="headroom"):
        pipe.server_compute_fn(ev, input_ntt=True, output_ntt=True,
                               fused_lazy=True)(torch.from_numpy(x))
    big = SimpleNamespace(params=BfvParams.create(n=16384, t=T))
    with pytest.raises(ValueError, match="headroom"):
        server_kernel.server_ycc_dct_fused(big, torch.zeros(0, dtype=torch.uint32), lazy=True)


def _quantize_by_torch_ops(ev, cts, quant):
    """The --quantize server op on the evaluator's torch ops alone, the DCT
    included (fhetpu's XLA network): the reference for the DCT kernel's
    path."""
    d = ev.transform_to_ntt(Ct(cts, False)).data
    out = []
    for chan in pipe.rgb_to_ycc(ev, *(Ct(d[:, c], True) for c in range(3))):
        slots = pipe.dct8x8(ev, [Ct(chan.data[:, k], True) for k in range(64)])
        slots = pipe.quantize(ev, slots, quant)
        out.append(torch.stack([modops.to_u32(s.data) for s in slots], dim=1))
    return ev.transform_from_ntt(Ct(torch.stack(out, dim=1), True)).data


def test_quantize_dct_kernel_path_decrypts_to_golden():
    """server_compute_fn(apply_quantize=True) on a CPU tensor goes through
    the DCT kernel's wrapper (its plain version, no launch counted), equals
    the torch-op network, and an encrypted 8x8 block decrypts to the golden
    oracle's quantized DCT exactly."""
    par = BfvParams.create(n=N, t=T)
    kg = crypto.KeyGenerator(par, seed=17)
    enc = crypto.Encryptor(par, kg.public_key(), seed=18)
    encoder = FractionalEncoder(T, N)
    ev = Evaluator(par, encoder, device="cpu")
    img = np.random.default_rng(44).integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    blocks = np.stack([images.split_blocks(img[..., c].astype(np.float64))
                       for c in range(3)], axis=1)  # [1, 3, 64]
    coeffs = encoder.encode_batch(blocks)
    cts = torch.from_numpy(
        enc.encrypt_batch(coeffs.reshape(-1, N)).reshape(1, 3, 64, 2, par.L, N))
    quant = build_quant_tables(50)[0][ZIGZAG].astype(np.float64)
    before = dct_kernel.dct8x8_kernel.launches
    got = pipe.server_compute_fn(ev, apply_quantize=True, quant=quant)(cts)
    ref = _quantize_by_torch_ops(ev, cts, quant)
    assert dct_kernel.dct8x8_kernel.launches == before
    assert got.dtype == torch.uint32 and np.array_equal(got.numpy(), ref.numpy())
    plain = crypto.Decryptor(par, kg.secret).decrypt_batch(
        got.numpy().reshape(-1, 2, par.L, N)).reshape(1, 3, 64, N)
    gev = GoldenEvaluator(encoder)
    ycc = pipe.rgb_to_ycc(gev, coeffs[:, 0], coeffs[:, 1], coeffs[:, 2])
    for ci, chan in enumerate(ycc):
        slots = pipe.quantize(gev, pipe.dct8x8(gev, [chan[:, k] for k in range(64)]), quant)
        assert np.array_equal(plain[:, ci], np.stack(slots, axis=1)), ci
