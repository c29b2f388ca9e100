"""The fast server network (``fhetpu_torch/pipelines/jpeg_fast.py`` on
``core/lazy.py``, selected by ``server_compute_fn(use_fast=True)``) against
fhetpu's and the port's default path: the lazy ops hold fhetpu's values and
bound multiples step for step; the composite NTT-domain operands equal
fhetpu's ``_CompositeOperand``; ``use_fast=True`` gives the default path's
bits with quantize off and on; fhetpu's own fast network, run eagerly,
equals the port's.  Every comparison is exact; inputs come from
np.random.default_rng.  fhetpu's XLA server graph is never jitted here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fhetpu.bfv.encoder import FractionalEncoder as FFractionalEncoder
from fhetpu.bfv.evaluator import Evaluator as FEvaluator
from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.core import lazy as f_lazy
from fhetpu.core import modops as f_modops
from fhetpu.pipelines import jpeg_fast as f_fast

from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.codec.jpeg import ZIGZAG, build_quant_tables
from fhetpu_torch.core import lazy
from fhetpu_torch.pipelines import jpeg_fast
from fhetpu_torch.pipelines.jpeg_encode import server_compute_fn

torch.set_num_threads(2)

N, T = 2048, 1 << 14
QUANT = build_quant_tables(50)[0][ZIGZAG].astype(np.float64)


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


@pytest.fixture(scope="module")
def pair():
    fev = FEvaluator(FBfvParams.create(n=N, t=T), FFractionalEncoder(T, N))
    ev = Evaluator(BfvParams.create(n=N, t=T), FractionalEncoder(T, N), device="cpu")
    x = _residues(np.random.default_rng(71), ev.params.q_primes, (1, 3, 64, 2), N)
    return fev, ev, x


def test_lazy_ops_hold_fhetpu_values_and_bounds():
    """A chain of adds, subs and Shoup products that drives the bounds past
    the u32 headroom (forcing _fit's reductions) gives fhetpu's LazyOps'
    values and bound multiples at every step; verify passes, and fails for
    a value outside [0, 2^32)."""
    primes = BfvParams.create(n=N).q_primes  # 27-bit: M = 32
    rng = np.random.default_rng(72)
    p_np = np.array(primes, dtype=np.uint32).reshape(-1, 1)
    ours = lazy.LazyOps(torch.from_numpy(p_np.astype(np.int64)), 27)
    ref = f_lazy.LazyOps(jnp.asarray(p_np), 27)
    vals = [_residues(rng, primes, (), 64) for _ in range(3)]
    w = _residues(rng, primes, (), 64)
    ws = f_modops.shoup(w, p_np.astype(np.uint64))
    a = [lazy.Lazy(torch.from_numpy(v.astype(np.int64)), 1) for v in vals]
    b = [f_lazy.Lazy(jnp.asarray(v), 1) for v in vals]
    tw, tws = (torch.from_numpy(t.astype(np.int64)) for t in (w, ws))
    steps = []
    x, y = a[0], b[0]
    ops = ["dbl"] * 7 + ["sub", "mul", "dbl", "sub", "add"] + ["dbl"] * 4 + ["sub", "mul"]
    for i, op in enumerate(ops):
        k = i % 3
        if op == "mul":
            x, y = ours.mul_shoup(x, tw, tws), ref.mul_shoup(y, jnp.asarray(w), jnp.asarray(ws))
        elif op == "sub":
            x, y = ours.sub(x, a[k]), ref.sub(y, b[k])
        elif op == "add":
            x, y = ours.add(x, a[k]), ref.add(y, b[k])
        else:
            x, y = ours.add(x, x), ref.add(y, y)
        steps.append((x.m, y.m, np.array_equal(x.v.numpy(), np.asarray(y.v))))
    x, y = ours.reduce_to(x, 3), ref.reduce_to(y, 3)
    steps.append((x.m, y.m, np.array_equal(x.v.numpy(), np.asarray(y.v))))
    assert all(m1 == m2 and same for m1, m2, same in steps), steps
    assert max(m for m, _, _ in steps) == ours.M == ref.M == 32
    assert np.array_equal(ours.canon(x).numpy(), np.asarray(ref.canon(y)))
    ours.verify()
    ours.checked(torch.tensor([1 << 32]))
    with pytest.raises(AssertionError, match="outside"):
        ours.verify()


def test_composite_operands_equal_fhetpu(pair):
    """The column pass's composites E(c)*E(1/8) and a three-way product,
    NTT-domain tables and Shoup companions, equal fhetpu's; the port caches
    them on the evaluator."""
    fev, ev, _ = pair
    assert jpeg_fast.ROT == f_fast.ROT and jpeg_fast.EIGHTH == f_fast.EIGHTH
    for values in [(c, jpeg_fast.EIGHTH) for c in jpeg_fast.ROT] + [(0.5, -0.25, 3.0)]:
        ours = jpeg_fast._CompositeOperand(ev, values)
        ref = f_fast._CompositeOperand(fev, values)
        assert np.array_equal(ours.mul_ntt, ref.mul_ntt), values
        assert np.array_equal(ours.mul_ntt_shoup, ref.mul_ntt_shoup), values
    w, ws = jpeg_fast._operand(ev, jpeg_fast.ROT[0], jpeg_fast.EIGHTH)
    ref = f_fast._CompositeOperand(fev, (jpeg_fast.ROT[0], jpeg_fast.EIGHTH))
    assert np.array_equal(w.numpy(), ref.mul_ntt.astype(np.int64))
    assert np.array_equal(ws.numpy(), ref.mul_ntt_shoup.astype(np.int64))
    assert jpeg_fast._operand(ev, jpeg_fast.ROT[0], jpeg_fast.EIGHTH)[0] is w


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quantize"])
def test_use_fast_equals_default(pair, quantize):
    """server_compute_fn(use_fast=True) gives the default op's bits at nb =
    1, n = 2048, coefficient form in and out (NTTs on both ends), with
    quantize off (default: the fused kernel's plain version) and on
    (default: torch YCC, the DCT-only kernel's plain version, torch
    quantize)."""
    _, ev, x = pair
    kw = dict(apply_quantize=quantize, quant=QUANT)
    want = server_compute_fn(ev, **kw)(torch.from_numpy(x))
    got = server_compute_fn(ev, use_fast=True, **kw)(torch.from_numpy(x))
    assert got.dtype == torch.uint32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="different networks"):
        server_compute_fn(ev, use_fast=True, fused_lazy=True, **kw)


def test_fast_equals_fhetpu_fast_eager(pair):
    """fhetpu's server_ycc_dct_fast run op by op (jax.disable_jit) and the
    port's, on the same NTT-form block with quantize: equal."""
    fev, ev, x = pair
    with jax.disable_jit():
        want = np.asarray(f_fast.server_ycc_dct_fast(fev, jnp.asarray(x), True, QUANT))
    got = jpeg_fast.server_ycc_dct_fast(ev, torch.from_numpy(x), True, QUANT)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(jpeg_fast.server_ycc_dct_fast(ev, torch.from_numpy(x)),
                       server_compute_fn(ev, input_ntt=True, output_ntt=True)(torch.from_numpy(x)))
