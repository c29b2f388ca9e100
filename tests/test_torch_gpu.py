"""fhetpu_torch's CUDA kernels on the card, against their plain torch
versions (which the CPU tests hold bit-equal to fhetpu).  Every comparison is
exact; inputs come from np.random.default_rng.  Imports neither JAX nor
anything of fhetpu.

Each test needs a CUDA device and skips without one.  The file imports no
JAX, so it runs on a GPU machine that has none; tests/conftest.py configures
JAX for the CPU suite and is left out there:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.codec.jpeg import ZIGZAG, build_quant_tables
from fhetpu_torch.core import dct_kernel, ntt, ntt_kernel, server_kernel
from fhetpu_torch.pipelines.jpeg_encode import server_compute_fn

pytestmark = pytest.mark.gpu

T = 1 << 14


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


def _launches():
    return (ntt_kernel.ntt_forward.launches, server_kernel.server_ycc_dct_fused.launches,
            ntt_kernel.ntt_inverse.launches)


@pytest.mark.parametrize("n", [2048, 4096])
def test_server_op_on_cuda_equals_plain(cuda, n):
    """The server op on a CUDA tensor launches the forward NTT, fused and
    inverse NTT kernels once each and gives the residues of the plain
    versions on the CPU."""
    par = BfvParams.create(n=n, t=T)
    enc = FractionalEncoder(T, n)
    x = _residues(np.random.default_rng(n), par.q_primes, (2, 3, 64, 2), n)
    want = server_compute_fn(Evaluator(par, enc, device="cpu"))(torch.from_numpy(x))
    before = _launches()
    got = server_compute_fn(Evaluator(par, enc, device=cuda))(torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    assert _launches() == tuple(c + 1 for c in before)
    assert got.dtype == torch.uint32 and np.array_equal(got.cpu().numpy(), want.numpy())


NTT_CASES = [(n, "tables_q", b) for n in (2048, 4096, 8192, 16384) for b in (1, 3, 7)]
NTT_CASES += [(n, "tables_bsk", b) for n in (4096, 16384) for b in (1, 7)]


@pytest.mark.parametrize("n,base,batch", NTT_CASES)
def test_ntt_kernels_equal_host_ntt(cuda, n, base, batch):
    """Forward kernel equals its plain version and the host np_ntt, inverse
    kernel equals its plain version and undoes it, one launch each; at
    n=16384 the ring of two polynomials needs 128 KB of shared memory, and
    the Bsk base there has 17 limbs."""
    tables = getattr(BfvParams.create(n=n, t=T), base)
    dt = ntt_kernel.device_tables(tables, cuda)
    x = _residues(np.random.default_rng(7 + batch), tables.primes, (batch,), n)
    before = (ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches)
    fx = ntt.ntt(torch.from_numpy(x).to(cuda), tables)
    ix = ntt.intt(fx, tables)
    torch.cuda.synchronize()
    assert (ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches) == (
        before[0] + 1, before[1] + 1)
    assert np.array_equal(fx.cpu().numpy(), ntt.np_ntt(x, tables))
    assert torch.equal(fx, ntt_kernel.ntt_plain(torch.from_numpy(x).to(cuda), dt))
    assert torch.equal(ix, ntt_kernel.intt_plain(fx, dt))
    assert np.array_equal(ix.cpu().numpy(), x)


def test_ntt_kernels_take_over_65535_polynomials(cuda):
    """32769 x 2 limbs = 65538 polynomials at n=2048, more than a grid
    dimension's 65535 and many waves of the persistent grid with a ragged
    last one: the first and last polynomials give the plain version's bits
    and the roundtrip is exact."""
    tables = BfvParams.create(n=2048, t=T).tables_q
    dt = ntt_kernel.device_tables(tables, cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    p = torch.tensor(tables.primes, dtype=torch.int64, device=cuda).reshape(-1, 1)
    x = (torch.randint(0, 1 << 62, (32769, len(tables.primes), 2048), generator=gen,
                       device=cuda, dtype=torch.int64) % p).to(torch.uint32)
    fx = ntt_kernel.ntt_forward(x, dt)
    torch.cuda.synchronize()
    for rows in (slice(0, 2), slice(-2, None)):
        assert torch.equal(fx[rows], ntt_kernel.ntt_plain(x[rows], dt))
    assert torch.equal(ntt_kernel.ntt_inverse(fx, dt), x)


def test_ntt_kernels_refuse_what_they_cannot_take(cuda):
    """A prime of 2^30 or more (the lazy butterflies would overflow 32 bits),
    a ring degree without a kernel, and data that is not 16-byte aligned
    raise ValueError before any launch; nothing falls back to the plain
    version."""
    par = BfvParams.create(n=2048, t=T)
    dt = ntt_kernel.device_tables(par.tables_q, cuda)
    x = torch.zeros((1, par.L, par.n), dtype=torch.int64, device=cuda).to(torch.uint32)
    wide = dataclasses.replace(dt, primes=((1 << 31) - (1 << 17) + 1,) * par.L)
    small = ntt_kernel.device_tables(BfvParams.create(n=1024, t=T).tables_q, cuda)
    flat = torch.zeros(1 + par.L * par.n, dtype=torch.int64, device=cuda).to(torch.uint32)
    misaligned = flat[1:].view(1, par.L, par.n)
    before = (ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches)
    for fn in (ntt_kernel.ntt_forward, ntt_kernel.ntt_inverse):
        with pytest.raises(ValueError, match="2\\^30"):
            fn(x, wide)
        with pytest.raises(ValueError, match="takes n"):
            fn(torch.zeros((1, small.L, small.n), dtype=torch.int64,
                           device=cuda).to(torch.uint32), small)
        with pytest.raises(ValueError, match="aligned"):
            fn(misaligned, dt)
    assert (ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches) == before


def test_wrappers_check_inputs_on_cuda(cuda):
    """A wrong dtype, shape or layout raises before any launch."""
    par = BfvParams.create(n=2048, t=T)
    ev = Evaluator(par, device=cuda)
    dt = ntt_kernel.device_tables(par.tables_q, cuda)
    good = torch.zeros((1, par.L, par.n), dtype=torch.int64, device=cuda).to(torch.uint32)
    before = _launches()
    with pytest.raises(TypeError):
        ntt_kernel.ntt_forward(good.to(torch.int64), dt)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_forward(good[..., : par.n // 2], dt)
    with pytest.raises(ValueError):
        ntt_kernel.ntt_inverse(good[0].t().contiguous().t().unsqueeze(0), dt)
    half = torch.zeros((1, 3, 64, 2, par.L, par.n // 2), dtype=torch.int64,
                       device=cuda).to(torch.uint32)
    with pytest.raises(ValueError):
        server_kernel.server_ycc_dct_fused(ev, half)
    assert _launches() == before


@pytest.mark.parametrize("inputs", ["random", "p-1"])
@pytest.mark.parametrize("n", [8192, 16384])
def test_strict_kernel_equals_plain(cuda, n, inputs):
    """The strict fused kernel, one launch, gives the bits of its plain
    version at n=8192 and 16384 (30-bit primes: its intermediates reach 4p,
    near 2^32), on random residues and on every input at p - 1."""
    par = BfvParams.create(n=n, t=T)
    ev = Evaluator(par, device=cuda)
    if inputs == "random":
        x = _residues(np.random.default_rng(n + 2), par.q_primes, (1, 3, 64, 2), n)
    else:
        p = np.asarray(par.q_primes, dtype=np.uint64).reshape(-1, 1)
        x = np.broadcast_to(p - 1, (1, 3, 64, 2, par.L, n)).astype(np.uint32)
    xc = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    before = server_kernel.server_ycc_dct_fused.launches
    got = server_kernel.server_ycc_dct_fused(ev, xc)
    torch.cuda.synchronize()
    assert server_kernel.server_ycc_dct_fused.launches == before + 1
    assert torch.equal(got, server_kernel.server_ycc_dct_plain(xc, ev.server_state(cuda)))


def test_strict_kernel_refuses_primes_from_2_30(cuda):
    """A modulus of 2^30 or more raises ValueError before any launch: the
    strict kernel's intermediates (up to 4p) would overflow 32 bits."""
    par = BfvParams.create(n=2048, t=T)
    st = Evaluator(par, device=cuda).server_state(cuda)
    wide = dataclasses.replace(st, q_primes=((1 << 31) - (1 << 17) + 1,) * par.L)
    x = torch.zeros((1, 3, 64, 2, par.L, par.n), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="2\\^30"):
        server_kernel._launch(x.to(torch.uint32), wide, 0)


@pytest.mark.parametrize("n", [2048, 8192])
def test_lazy_kernel_equals_plain_and_strict(cuda, n):
    """The lazy fused kernel (m = 2 at n=2048, m = 1 at n=8192) gives the
    bits of its plain version on the CPU and of the strict kernel, and is
    counted on its own counter."""
    par = BfvParams.create(n=n, t=T)
    ev = Evaluator(par, device=cuda)
    m = server_kernel.lazy_bound_multiple(ev)
    assert m == {2048: 2, 8192: 1}[n]
    x = _residues(np.random.default_rng(n + 1), par.q_primes, (1, 3, 64, 2), n)
    xc = torch.from_numpy(x).to(cuda)
    before = (server_kernel.server_ycc_dct_fused.lazy_launches,
              server_kernel.server_ycc_dct_fused.launches)
    got = server_kernel.server_ycc_dct_fused(ev, xc, lazy=True)
    torch.cuda.synchronize()
    assert (server_kernel.server_ycc_dct_fused.lazy_launches,
            server_kernel.server_ycc_dct_fused.launches) == (before[0] + 1, before[1])
    want = server_kernel.server_ycc_dct_lazy_plain(torch.from_numpy(x), ev.server_state("cpu"), m)
    assert np.array_equal(got.cpu().numpy(), want.numpy())
    strict = server_kernel.server_ycc_dct_fused(ev, xc)
    assert np.array_equal(got.cpu().numpy(), strict.cpu().numpy())


def test_lazy_kernel_refused_at_16384(cuda):
    """n=16384's 30-bit primes leave no headroom: ValueError, no launch."""
    par = BfvParams.create(n=16384, t=T)
    ev = Evaluator(par, device=cuda)
    x = torch.zeros((1, 3, 64, 2, par.L, par.n), dtype=torch.int64, device=cuda)
    before = server_kernel.server_ycc_dct_fused.lazy_launches
    with pytest.raises(ValueError, match="headroom"):
        server_kernel.server_ycc_dct_fused(ev, x.to(torch.uint32), lazy=True)
    assert server_kernel.server_ycc_dct_fused.lazy_launches == before


@pytest.mark.parametrize("n", [2048, 16384])
def test_dct_kernel_equals_plain(cuda, n):
    """The DCT-only kernel gives the bits of dct8x8_plain on the CPU, for
    three channels and for one."""
    par = BfvParams.create(n=n, t=T)
    ev = Evaluator(par, device=cuda)
    for ch in (3, 1):
        x = _residues(np.random.default_rng(n + ch), par.q_primes, (1, ch, 64, 2), n)
        before = dct_kernel.dct8x8_kernel.launches
        got = dct_kernel.dct8x8_kernel(ev, torch.from_numpy(x).to(cuda))
        torch.cuda.synchronize()
        assert dct_kernel.dct8x8_kernel.launches == before + 1
        want = dct_kernel.dct8x8_plain(torch.from_numpy(x), ev.server_state("cpu"))
        assert np.array_equal(got.cpu().numpy(), want.numpy())


def test_dct_kernel_takes_over_65535_block_channels(cuda):
    """A chunk of 21846 blocks x 3 channels (more than a grid dimension's
    65535) launches; its first and last blocks give the plain version's
    bits.  32 lanes of limb 0 keep the tensor at 1 GiB."""
    par = BfvParams.create(n=2048, t=T)
    st = Evaluator(par, device=cuda).server_state(cuda)
    lanes = 32
    state = SimpleNamespace(consts=st.consts[:, :lanes].contiguous(),
                            consts_shoup=st.consts_shoup[:, :lanes].contiguous())
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randint(0, par.q_primes[0], (21846, 3, 64, 2, 1, lanes), generator=gen,
                      device=cuda, dtype=torch.int64).to(torch.uint32)
    got = dct_kernel._launch(x, state)
    torch.cuda.synchronize()
    cpu_state = SimpleNamespace(consts=state.consts.cpu(), consts_shoup=state.consts_shoup.cpu())
    for blocks in (slice(0, 1), slice(-1, None)):
        want = dct_kernel.dct8x8_plain(x[blocks].cpu(), cpu_state)
        assert np.array_equal(got[blocks].cpu().numpy(), want.numpy())


def test_quantize_op_on_cuda_equals_plain(cuda):
    """server_compute_fn(apply_quantize=True) on a CUDA tensor runs the DCT
    kernel (and the NTT kernels, not the fused one) and gives the residues of
    the same op's plain versions on the CPU, which the CPU tests hold equal
    to the torch-op network."""
    par = BfvParams.create(n=2048, t=T)
    enc = FractionalEncoder(T, 2048)
    quant = build_quant_tables(50)[0][ZIGZAG].astype(np.float64)
    x = _residues(np.random.default_rng(5), par.q_primes, (2, 3, 64, 2), 2048)
    want = server_compute_fn(Evaluator(par, enc, device="cpu"), apply_quantize=True,
                             quant=quant)(torch.from_numpy(x))
    before = (dct_kernel.dct8x8_kernel.launches,) + _launches()
    got = server_compute_fn(Evaluator(par, enc, device=cuda), apply_quantize=True,
                            quant=quant)(torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    after = (dct_kernel.dct8x8_kernel.launches,) + _launches()
    assert after[0] > before[0] and after[1] > before[1] and after[3] > before[3]
    assert after[2] == before[2]
    assert np.array_equal(got.cpu().numpy(), want.numpy())
