"""The harmonic expansion kernel's arithmetic (``csrc/harmonic_expand.cu``)
on the CPU, and the expansion's dispatch.

The card is not here, so a NumPy twin repeats the kernel's sums in its
order: exact 64-bit products summed in uint64 registers that wrap as the
card's do, a Barrett fold into [0, 2q) after every ``CHUNK`` products,
one conditional subtraction at the end.  It is held to the exact sum of
Python integers at the largest q and H the wrapper accepts, with every
input at q - 1, and to ``rle_decode.expand_harmonics_plain``, the
expansion's CPU path.  The kernel itself is held to the torch loop on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 3c)."""

import numpy as np
import pytest
import torch

from fhetpu_torch.bfv import crypto
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Ct, Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.core import expand_kernel
from fhetpu_torch.pipelines import rle_decode as rd

CHUNK = expand_kernel.CHUNK
Q_MAX = expand_kernel.PRIME_LIMIT - 1  # the largest odd q the wrapper accepts
H_MAX = expand_kernel.MAX_ROWS // min(expand_kernel.SIZES)  # the most harmonics it accepts
LOW = np.uint64(0xFFFFFFFF)


def _mulhi64(x: np.ndarray, m: int) -> np.ndarray:
    """The high 64 bits of x * m (x uint64, m < 2^64): __umul64hi."""
    ml, mh = np.uint64(m & 0xFFFFFFFF), np.uint64(m >> 32)
    xl, xh = x & LOW, x >> np.uint64(32)
    t = xl * ml
    u = xh * ml + (t >> np.uint64(32))
    v = xl * mh + (u & LOW)
    return xh * mh + (u >> np.uint64(32)) + (v >> np.uint64(32))


def kernel_sum(w: np.ndarray, h: np.ndarray, q: int, chunk: int = CHUNK) -> np.ndarray:
    """sum_k w[k] * h[k] mod q for uint32 [H, ...] arrays, as the kernel
    computes it for one prime."""
    m = (1 << 64) // q
    acc = np.zeros(np.broadcast_shapes(w.shape[1:], h.shape[1:]), dtype=np.uint64)
    for k0 in range(0, len(w), chunk):
        for k in range(k0, min(k0 + chunk, len(w))):
            acc = acc + w[k].astype(np.uint64) * h[k].astype(np.uint64)
        # x - mulhi64(x, m) q in 32 bits: [0, 2q)
        acc = ((acc & LOW) - (_mulhi64(acc, m) & LOW) * np.uint64(q)) & LOW
    return np.where(acc >= q, acc - np.uint64(q), acc).astype(np.uint32)


def exact_sum(w: np.ndarray, h: np.ndarray, q: int) -> np.ndarray:
    return ((w.astype(object) * h.astype(object)).sum(axis=0) % q).astype(np.uint32)


@pytest.mark.parametrize("q,H,worst", [(Q_MAX, H_MAX, True), (Q_MAX, H_MAX, False),
                                       (132710401, 25, True)])
def test_kernel_sums_equal_the_exact_sum_at_the_limits(q, H, worst):
    """At the largest q and H the wrapper accepts, and at the decode
    cell's prime and H, the twin's sums equal the exact sums, with every
    input at q - 1 (the largest 64-bit sums) or random."""
    rng = np.random.default_rng(q + H)
    shape = (H, 257)
    if worst:
        w = h = np.full(shape, q - 1, dtype=np.uint32)
    else:
        w, h = (rng.integers(0, q, size=shape, dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    assert np.array_equal(kernel_sum(w, h, q), exact_sum(w, h, q))


def test_one_more_product_between_folds_would_overflow():
    """The fold interval is the largest that holds: a 17th product of
    (q - 1)^2 on a sum near 2q passes 2^64 at the largest q, and the twin
    with 17 products between folds gives wrong residues there."""
    q = Q_MAX
    assert 2 * q + CHUNK * (q - 1) ** 2 < 1 << 64 <= 2 * q + (CHUNK + 1) * (q - 1) ** 2
    w = np.full((2 * CHUNK + 2, 8), q - 1, dtype=np.uint32)
    assert np.array_equal(kernel_sum(w, w, q), exact_sum(w, w, q))
    assert not np.array_equal(kernel_sum(w, w, q, CHUNK + 1), exact_sum(w, w, q))


@pytest.mark.parametrize("n,S", [(2048, 2), (4096, 3)])
def test_kernel_sums_equal_the_torch_loop(n, S):
    """Column by column, the twin over tables [H, P, L, n] and harmonics
    [H, S, L, n] gives expand_harmonics_plain's residues."""
    par = BfvParams.create(n=n)
    qs, H, P = par.q_primes, 25, 3
    rng = np.random.default_rng(n)

    def residues(prefix):
        return np.stack([rng.integers(0, q, size=prefix + (n,), dtype=np.uint64)
                         for q in qs], axis=-2).astype(np.uint32)

    tabs, harm = residues((H, P)), residues((H, S))
    want = rd.expand_harmonics_plain(torch.from_numpy(tabs), torch.from_numpy(harm).long(),
                                     torch.tensor(qs, dtype=torch.int64).reshape(-1, 1))
    got = np.stack([kernel_sum(tabs[:, :, None, l], harm[:, None, :, l], q)
                    for l, q in enumerate(qs)], axis=-2)
    assert np.array_equal(got, want.numpy())


def test_the_cpu_path_is_the_torch_loop_and_the_wrapper_refuses_it():
    """On CPU tensors expand_harmonics_batched runs the torch loop (int64
    out, no kernel call), and the kernel's wrapper refuses CPU tensors
    before it launches anything."""
    par = BfvParams.create(n=2048)
    encoder = FractionalEncoder(par.t, par.n)
    ev = Evaluator(par, encoder, device="cpu")
    kg = crypto.KeyGenerator(par, seed=22)
    harm = rd.fourier_harmonics_host([(200, 2), (13, 3)], 64, 2, 0.5)
    ct = Ct(torch.from_numpy(crypto.Encryptor(par, kg.public_key(), seed=23).encrypt_batch(
        encoder.encode_batch(harm))))
    pos = np.arange(4)
    launches = expand_kernel.harmonic_expand.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(expand_kernel, "harmonic_expand",
                   lambda *a: pytest.fail("the kernel's wrapper was called on the CPU"))
        out = rd.expand_harmonics_batched(ev, ct, pos, 64, 2)
    tabs = rd.harmonic_weight_tables(ev, pos, 64, 2)
    hn = ev.transform_to_ntt(ct).data.long()
    assert out.ntt_form and out.data.dtype == torch.int64
    assert torch.equal(out.data, rd.expand_harmonics_plain(tabs, hn, ev.p))
    with pytest.raises(ValueError, match="CUDA"):
        expand_kernel.harmonic_expand(tabs, ev.transform_to_ntt(ct).data, par.q_primes)
    assert expand_kernel.harmonic_expand.launches == launches
