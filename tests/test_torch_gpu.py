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

from fhetpu_torch.bfv import crypto, rns
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Ct, DeviceRelinKeys, Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.codec.jpeg import ZIGZAG, build_quant_tables
from fhetpu_torch.core import dct_kernel, ntt, ntt_kernel, server_kernel
from fhetpu_torch.parallel import halo
from fhetpu_torch.parallel.mesh import make_mesh, map_blocks
from fhetpu_torch.pipelines import resize as rz
from fhetpu_torch.pipelines import rle_decode as rd
from fhetpu_torch.pipelines.jpeg_encode import make_server, server_compute_fn

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


def test_ntt_kernels_count_the_polynomials_they_transform(cuda):
    """Each launch adds batch * L to ``polys`` (on q, L = 4; on Bsk, its
    own limbs); an empty batch launches nothing and counts nothing."""
    par = BfvParams.create(n=4096, t=T)
    rng = np.random.default_rng(5)
    before = (ntt_kernel.ntt_forward.polys, ntt_kernel.ntt_inverse.polys)
    want = [0, 0]
    for tables, prefix in ((par.tables_q, (3,)), (par.tables_bsk, (2, 5)),
                           (par.tables_q, (867, 2)), (par.tables_q, (0,))):
        x = torch.from_numpy(_residues(rng, tables.primes, prefix, par.n)).to(cuda)
        ntt.intt(ntt.ntt(x, tables), tables)
        want = [w + int(np.prod(prefix)) * len(tables.primes) for w in want]
    torch.cuda.synchronize()
    assert (ntt_kernel.ntt_forward.polys - before[0],
            ntt_kernel.ntt_inverse.polys - before[1]) == tuple(want)


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


def _ntt_launches():
    return ntt_kernel.ntt_forward.launches, ntt_kernel.ntt_inverse.launches


@pytest.mark.parametrize("n", [4096, 8192])
def test_behz_multiply_and_relinearize_on_cuda_equal_cpu(cuda, n):
    """rns.multiply (sizes 2x2 and 3x2) and relinearize (dbc 0 and 16) on
    CUDA tensors run the NTT kernels on the q and Bsk bases and give the
    residues of the same ops on the CPU, which the CPU tests hold equal to
    fhetpu's."""
    par = BfvParams.create(n=n, t=T)
    kg = crypto.KeyGenerator(par, seed=n)
    enc = crypto.Encryptor(par, kg.public_key(), seed=n + 1)
    rng = np.random.default_rng(n)
    a = enc.encrypt_batch(rng.integers(0, T, size=(2, n)))
    b = _residues(rng, par.q_primes, (2, 3), n)
    cpu, gpu = Evaluator(par, device="cpu"), Evaluator(par, device=cuda)
    for x, y in ((a, a[::-1].copy()), (b, a)):
        before = _ntt_launches()
        got = rns.multiply(torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda),
                           gpu.rns_tool)
        torch.cuda.synchronize()
        assert all(c > p for c, p in zip(_ntt_launches(), before))
        want = rns.multiply(torch.from_numpy(x), torch.from_numpy(y), cpu.rns_tool)
        assert torch.equal(got.cpu(), want)
    prod = cpu.multiply(Ct(torch.from_numpy(a)), Ct(torch.from_numpy(a[::-1].copy())))
    for dbc in (0, 16):
        rk = DeviceRelinKeys(kg.relin_keys(max_power=2, digit_bits=dbc))
        before = _ntt_launches()
        got = gpu.relinearize(Ct(prod.data.to(cuda)), rk)
        torch.cuda.synchronize()
        assert _ntt_launches() == (before[0] + 1, before[1] + 1)
        assert torch.equal(got.data.cpu(), cpu.relinearize(prod, rk).data)


@pytest.mark.parametrize("n,mode,ch,hw", [(4096, rz.BILINEAR, 3, 4), (8192, rz.BICUBIC, 1, 4)],
                         ids=["bilinear-4096", "bicubic-8192"])
def test_resize_tile_on_cuda_equals_cpu(cuda, n, mode, ch, hw):
    """One encrypted-fract resize tile (unrelinearized: size 4 bilinear,
    size 8 bicubic) on the card gives the residues of the same tile on the
    CPU, with the same input and fract ciphertexts."""
    par = BfvParams.create(n=n, t=T)
    kg = crypto.KeyGenerator(par, seed=n + 5)
    encoder = FractionalEncoder(T, n)
    img = np.random.default_rng(n).integers(0, 256, size=(hw, hw, ch)).astype(np.float64)
    cts = crypto.Encryptor(par, kg.public_key(), seed=3).encrypt_batch(
        encoder.encode_batch(img).reshape(-1, n)).reshape(hw, hw, ch, 2, par.L, n)
    rp, cp = rz.axis_plan(hw, 2, mode), rz.axis_plan(hw, 2, mode)
    outs = []
    for dev in ("cpu", cuda):
        ev = Evaluator(par, encoder, device=dev)
        yops, xops = rz.make_fract_bundles(
            ev, rp, cp, mode, encryptor=crypto.Encryptor(par, kg.public_key(), seed=4))
        before = _ntt_launches()
        outs.append(rz.resize_tile(ev, torch.from_numpy(cts).to(dev), rp, cp, yops, xops,
                                   mode, False).cpu())
        launched = tuple(c - p for c, p in zip(_ntt_launches(), before))
    assert all(k > 0 for k in launched)
    assert outs[0].shape == (2, 2, ch, 4 if mode == rz.BILINEAR else 8, par.L, n)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("n,t", [(2048, 1 << 14), (4096, 1 << 24)])
def test_harmonic_expansion_on_cuda_equals_cpu(cuda, n, t):
    """The harmonic weight tables (uint32, lifted on the card from 16- or
    32-bit coefficients) and both expansions at order 64, degree 12 over 96
    positions give the residues of the same calls on the CPU; the tables'
    build launches the forward NTT kernel once."""
    par = BfvParams.create(n=n, t=t)
    encoder = FractionalEncoder(t, n)
    kg = crypto.KeyGenerator(par, seed=n + 7)
    rng = np.random.default_rng(n)
    harm = rng.uniform(-300.0, 300.0, size=25)
    cts = crypto.Encryptor(par, kg.public_key(), seed=1).encrypt_batch(
        encoder.encode_batch(harm))
    pos = np.arange(96)
    outs = {}
    for dev in ("cpu", cuda):
        ev = Evaluator(par, encoder, device=dev)
        before = _ntt_launches()
        tabs = rd.harmonic_weight_tables(ev, pos, 64, 12)
        built = tuple(c - p for c, p in zip(_ntt_launches(), before))
        batched = rd.expand_harmonics_batched(ev, Ct(torch.from_numpy(cts).to(dev)), pos, 64, 12)
        server = rd.expand_harmonics_server(ev, Ct(torch.from_numpy(cts).to(dev)), pos, 64, 12)
        outs[str(dev)] = (tabs.cpu(), batched.data.cpu(), server.data.cpu())
    assert built == (1, 0)
    cpu, gpu = outs["cpu"], outs[str(cuda)]
    assert gpu[0].dtype == torch.uint32 and tuple(gpu[0].shape) == (25, 96, par.L, n)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b)
    assert torch.equal(gpu[1], gpu[2])


def test_mul_plain_stacked_on_cuda_equals_cpu(cuda):
    """mul_plain_stacked of a batched size-3 ciphertext in coefficient form
    (the NTT kernel takes it to NTT form) by 16 per-row weights gives the
    CPU's residues."""
    par = BfvParams.create(n=8192, t=1 << 24)
    encoder = FractionalEncoder(par.t, par.n, 100, 10)
    x = _residues(np.random.default_rng(3), par.q_primes, (16, 3), par.n)
    w = np.random.default_rng(4).uniform(-1.0, 1.0, size=16)
    outs = []
    for dev in ("cpu", cuda):
        ev = Evaluator(par, encoder, device=dev)
        before = _ntt_launches()
        out = rd.mul_plain_stacked(ev, Ct(torch.from_numpy(x).to(dev)), w)
        launched = tuple(c - p for c, p in zip(_ntt_launches(), before))
        assert out.ntt_form
        outs.append(out.data.cpu())
    assert launched == (2, 0)  # the table's NTT and the ciphertext's
    assert torch.equal(outs[0], outs[1])


def test_timing_measure_on_cuda_events(cuda):
    """bench.timing.measure times a chain of server ops between two CUDA
    events: a window of at least MIN_DT, sec_per_iter = dt / k, and no longer
    than the same chain timed on the host clock up to a synchronize."""
    import time

    from fhetpu_torch.bench import timing

    par = BfvParams.create(n=4096, t=T)
    ev = Evaluator(par, FractionalEncoder(T, par.n), device=cuda)
    fn = server_compute_fn(ev, input_ntt=True, output_ntt=True)
    x = torch.from_numpy(_residues(np.random.default_rng(9), par.q_primes,
                                   (8, 3, 64, 2), par.n)).to(cuda)
    before = server_kernel.server_ycc_dct_fused.launches
    sec, k, dt = timing.measure(fn, x, "server op", cuda, verbose=False)
    assert sec > 0 and dt >= timing.MIN_DT and sec == pytest.approx(dt / k)
    assert server_kernel.server_ycc_dct_fused.launches - before >= k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = x
    for _ in range(k):
        y = fn(y)
    torch.cuda.synchronize()
    assert dt <= (time.perf_counter() - t0) * 1.25  # two runs: allow their spread


def test_noise_point_on_cuda_equals_artifact(cuda):
    """One point of fhetpu's committed noise sweep, bilinear with encrypted
    fracts at n = 2048, t = 64, measured through the NTT kernels: the
    artifact's budget (5 bits) and the CPU's row."""
    import json
    import os

    from fhetpu_torch.bench import noise_validation as nv

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "bench_results", "noise_validation.json")
    with open(path) as f:
        want = [r for r in nv.select(json.load(f), {"bilinear_ctct"}, {2048})
                if r["t"] == 64][0]
    before = _ntt_launches()
    got = nv.run_point("bilinear_ctct", 2048, 64, device=cuda)
    assert all(c > p for c, p in zip(_ntt_launches(), before))
    assert got["measured_budget"] == want["measured_budget"] == 5
    assert got == nv.run_point("bilinear_ctct", 2048, 64, device="cpu")


def test_sharded_jpeg_op_on_cuda_equals_unsharded(cuda):
    """The server op data-parallel over three logical shards on the card
    (5 blocks padded to 6) gives the unsharded op's bits and launches the
    forward NTT, fused and inverse NTT kernels once per shard."""
    par = BfvParams.create(n=2048, t=T)
    ev = Evaluator(par, FractionalEncoder(T, 2048), device=cuda)
    x = torch.from_numpy(_residues(np.random.default_rng(5), par.q_primes, (5, 3, 64, 2),
                                   2048)).to(cuda)
    op = server_compute_fn(ev)
    want = op(x)
    mesh = make_mesh({"dp": 3}, [cuda] * 3)
    before = _launches()
    got = map_blocks({ev.device: op}, x, mesh)
    torch.cuda.synchronize()
    assert _launches() == tuple(c + 3 for c in before)
    assert got.device == x.device and torch.equal(got, want)


@pytest.mark.parametrize("H,W,H2,W2,mode,D", [(16, 16, 8, 7, rz.BICUBIC, 4),
                                              (32, 8, 4, 5, rz.BICUBIC, 8)],
                         ids=["halo", "gather"])
def test_sharded_resize_on_cuda_equals_unsharded_and_cpu(cuda, H, W, H2, W2, mode, D):
    """Row-sharded plain-fract resize over D logical shards on the card
    equals the single-device resize_tile on the card and the sharded run
    on the CPU, with the NTT kernels launched."""
    par = BfvParams.create(n=2048, t=T)
    src = torch.from_numpy(_residues(np.random.default_rng(H), par.q_primes, (H, W, 3, 2), 2048))
    outs = []
    for dev in ("cpu", cuda):
        ev = Evaluator(par, FractionalEncoder(T, 2048), device=dev)
        before = _ntt_launches()
        outs.append(halo.resize_sharded(ev, src.to(dev), H2, W2, mode,
                                        make_mesh({"sp": D}, [dev] * D)).cpu())
    assert all(c > p for c, p in zip(_ntt_launches(), before))
    rp, cp = rz.axis_plan(H, H2, mode), rz.axis_plan(W, W2, mode)
    yops, xops = rz.make_fract_bundles(ev, rp, cp, mode)
    single = rz.resize_tile(ev, src.to(cuda), rp, cp, yops, xops, mode, True).cpu()
    assert torch.equal(outs[1], single) and torch.equal(outs[1], outs[0])


def test_kernels_launch_on_the_last_card_from_device_0(cuda):
    """Every kernel launched on a tensor of cuda:{count-1} while cuda:0 is
    the current device (each wrapper makes its tensor's device current for
    the launch) gives the bits of its plain version.  On a one-card host
    the last card is cuda:0 itself."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    par = BfvParams.create(n=2048, t=T)
    x = _residues(np.random.default_rng(7), par.q_primes, (2, 3, 64, 2), 2048)
    got, want = [], []
    for dev, out in ((last, got), ("cpu", want)):
        ev = Evaluator(par, FractionalEncoder(T, 2048), device=dev)
        with torch.cuda.device(0):
            xd = torch.from_numpy(x).to(dev)
            out += [ntt.ntt(xd, par.tables_q), ntt.intt(xd, par.tables_q),
                    server_kernel.server_ycc_dct_fused(ev, xd),
                    server_kernel.server_ycc_dct_fused(ev, xd, lazy=True),
                    dct_kernel.dct8x8_kernel(ev, xd)]
            assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(last)
    for g, w in zip(got, want):
        assert g.device == last and torch.equal(g.cpu(), w)


def test_native_jpeg_op_on_cuda_runs_the_lazy_kernel(cuda):
    """On the native n = 8192 chain (m = 2), the lazy JPEG op on a CUDA
    tensor launches the NTTs and the lazy kernel, never the strict one, and
    gives the residues of the same op's plain versions on the CPU."""
    par = BfvParams.create_native(n=8192, t=T)
    enc = FractionalEncoder(T, 8192)
    x = _residues(np.random.default_rng(81), par.q_primes, (1, 3, 64, 2), 8192)
    want = server_compute_fn(Evaluator(par, enc, device="cpu"),
                             fused_lazy=True)(torch.from_numpy(x))
    ev = Evaluator(par, enc, device=cuda)
    assert server_kernel.lazy_bound_multiple(ev) == 2
    before = _launches() + (server_kernel.server_ycc_dct_fused.lazy_launches,)
    got = server_compute_fn(ev, fused_lazy=True)(torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    after = _launches() + (server_kernel.server_ycc_dct_fused.lazy_launches,)
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2],
            after[3] - before[3]) == (1, 0, 1, 1)
    assert np.array_equal(got.cpu().numpy(), want.numpy())


def test_lazy_kernel_at_native_16384(cuda):
    """n = 16384 on the native chain (L = 16): the lazy kernel at m = 2 is
    bit-equal to its plain version and to the strict kernel, and the NTT
    kernels on the native q to their plain versions."""
    par = BfvParams.create_native(n=16384, t=T)
    ev = Evaluator(par, device=cuda)
    assert server_kernel.lazy_bound_multiple(ev) == 2
    x = torch.from_numpy(_residues(np.random.default_rng(82), par.q_primes, (1, 3, 64, 2),
                                   16384)).to(cuda)
    lazy = server_kernel.server_ycc_dct_fused(ev, x, lazy=True)
    st = ev.server_state(cuda)
    assert torch.equal(lazy, server_kernel.server_ycc_dct_lazy_plain(x, st, 2))
    assert torch.equal(lazy, server_kernel.server_ycc_dct_fused(ev, x))
    dt = ntt_kernel.device_tables(par.tables_q, cuda)
    polys = x[0, 0, :4].reshape(-1, par.L, par.n)
    fx = ntt_kernel.ntt_forward(polys, dt)
    assert torch.equal(fx, ntt_kernel.ntt_plain(polys, dt))
    assert torch.equal(ntt_kernel.ntt_inverse(fx, dt), ntt_kernel.intt_plain(fx, dt))


@pytest.mark.parametrize("n", [2048, 4096, 8192, 16384])
def test_ntt4_on_cuda_equals_ntt_kernels(cuda, n):
    """The four-step NTT's int8 products on the card (torch._int_mm) give
    the NTT kernels' bits, forward and inverse, on q."""
    from fhetpu_torch.core import ntt4step

    tables = BfvParams.create(n=n, t=T).tables_q
    x = torch.from_numpy(_residues(np.random.default_rng(83), tables.primes, (3,), n)).to(cuda)
    fx = ntt.ntt(x, tables)
    assert torch.equal(ntt4step.ntt4(x, tables, True), fx)
    assert torch.equal(ntt4step.ntt4(fx, tables, False), ntt.intt(fx, tables))


def test_fast_quantize_op_on_cuda_equals_default(cuda):
    """server_compute_fn(use_fast=True) with quantize on a CUDA tensor
    launches the NTT kernels and no JPEG kernel, and gives the default
    --quantize op's bits (torch YCC, the DCT-only kernel, torch quantize)."""
    par = BfvParams.create(n=2048, t=T)
    ev = Evaluator(par, FractionalEncoder(T, 2048), device=cuda)
    quant = build_quant_tables(50)[0][ZIGZAG].astype(np.float64)
    x = torch.from_numpy(_residues(np.random.default_rng(84), par.q_primes, (2, 3, 64, 2),
                                   2048)).to(cuda)
    want = server_compute_fn(ev, apply_quantize=True, quant=quant)(x)
    before = (dct_kernel.dct8x8_kernel.launches,) + _launches()
    got = server_compute_fn(ev, apply_quantize=True, quant=quant, use_fast=True)(x)
    torch.cuda.synchronize()
    after = (dct_kernel.dct8x8_kernel.launches,) + _launches()
    assert (after[0] - before[0], after[2] - before[2]) == (0, 0)
    assert after[1] > before[1] and after[3] > before[3]
    assert torch.equal(got, want)


@pytest.mark.parametrize("quantize", [False, True], ids=["default", "quantize"])
def test_make_server_on_cuda_equals_server_compute_fn(cuda, quantize):
    """make_server on a CUDA tensor launches the NTT kernels and the fused
    kernel (the DCT-only kernel with quantize) and gives server_compute_fn's
    bits on the card and on the CPU."""
    par = BfvParams.create(n=2048, t=T)
    enc = FractionalEncoder(T, 2048)
    quant = build_quant_tables(50)[0][ZIGZAG].astype(np.float64) if quantize else None
    x = _residues(np.random.default_rng(85), par.q_primes, (2, 3, 64, 2), 2048)
    ev = Evaluator(par, enc, device=cuda)
    want = server_compute_fn(ev, apply_quantize=quantize, quant=quant)(torch.from_numpy(x).to(cuda))
    cpu = server_compute_fn(Evaluator(par, enc, device="cpu"), apply_quantize=quantize,
                            quant=quant)(torch.from_numpy(x))
    before = (dct_kernel.dct8x8_kernel.launches,) + _launches()
    got = make_server(ev, quantize, quant)(torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    after = (dct_kernel.dct8x8_kernel.launches,) + _launches()
    assert after[1] > before[1] and after[3] > before[3]
    assert (after[0] > before[0], after[2] > before[2]) == (quantize, not quantize)
    assert torch.equal(got, want) and np.array_equal(got.cpu().numpy(), cpu.numpy())


def test_ntt_kernel_product_equals_naive_convolution(cuda):
    """ntt_forward -> pointwise product -> ntt_inverse on the card at
    n = 2048 equals the O(n^2) golden model prime by prime, for a sparse a
    (with the wrap-around terms) and a dense b."""
    from fhetpu_torch.core import modops

    tables = BfvParams.create(n=2048, t=T).tables_q
    dt = ntt_kernel.device_tables(tables, cuda)
    rng = np.random.default_rng(86)
    L, n = len(tables.primes), tables.n
    a = np.zeros((L, n), np.uint32)
    for li, p in enumerate(tables.primes):
        hot = rng.choice(n, size=16, replace=False)
        hot[:2] = (0, n - 1)
        a[li, hot] = rng.integers(1, p, size=16, dtype=np.uint64)
    b = _residues(rng, tables.primes, (), n)
    fa, fb = (ntt_kernel.ntt_forward(torch.from_numpy(v).to(cuda), dt) for v in (a, b))
    p = modops.to_i64(dt.p).reshape(L, 1)
    prod = ntt_kernel.ntt_inverse(modops.to_u32(modops.mulmod(
        modops.to_i64(fa), modops.to_i64(fb), p)), dt).cpu().numpy()
    for li, q in enumerate(tables.primes):
        assert np.array_equal(prod[li], ntt.negacyclic_convolve_naive(a[li], b[li], q))


def test_server_jpeg_on_cuda_reads_a_fifo(cuda, tmp_path):
    """server_jpeg --device cuda reading the client's stream from a FIFO
    (fed by a thread) writes the stream it writes from the file, byte for
    byte."""
    from chip_smoke import feed_fifo
    from fhetpu_torch.cli import client_jpeg, server_jpeg

    img = np.random.default_rng(87).integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    keys = ["--keydir", str(tmp_path / "keys")]
    c2s = str(tmp_path / "c2s.bin")
    client_jpeg.send_array(client_jpeg.parser().parse_args(
        ["--send", "-c", c2s, "--cmod", "2048", "--pmod", str(T)] + keys), img)
    with open(c2s, "rb") as f, feed_fifo(str(tmp_path / "c2s.fifo"), f.read()) as fifo:
        server_jpeg.main(["-i", fifo, "-c", str(tmp_path / "fifo.bin"), "--device", "cuda"] + keys)
    server_jpeg.main(["-i", c2s, "-c", str(tmp_path / "file.bin"), "--device", "cuda"] + keys)
    with open(tmp_path / "fifo.bin", "rb") as a, open(tmp_path / "file.bin", "rb") as b:
        assert a.read() == b.read()
