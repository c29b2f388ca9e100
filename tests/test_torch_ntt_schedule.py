"""The NTT kernels' schedule (``fhetpu_torch/csrc/ntt.cu``), emulated in
NumPy on the CPU.

The emulation follows the kernel step for step: its register rounds
(``ntt_kernel.kernel_rounds``), the element each thread holds in a round,
its twiddle records as ``device_tables`` builds them (``fwd_tw``/``inv_tw``),
its lazy butterflies and the n^-1 folded into the inverse's last stage.  At
every step each value must stay below 4p (forward) or 2p (inverse), and so
below 2^32; the outputs must equal fhetpu's ``np_ntt``/``np_intt`` bit for
bit.  It also checks that the shared-memory swizzle leaves no bank conflict
in any round, and that the kernel path refuses a prime of 2^30 or more.
"""

import numpy as np
import pytest
import torch

from fhetpu.bfv.params import BfvParams as FBfvParams
from fhetpu.core.ntt import np_intt as f_np_intt, np_ntt as f_np_ntt
from fhetpu_torch.core import ntt_kernel
from fhetpu_torch.core.modops import shoup

T = 1 << 14
U32 = np.uint64(0xFFFFFFFF)


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


def _element(tid, s, lo):
    """The index of the s-th value thread tid holds in a round whose window
    starts at bit lo (ntt.cu:elem)."""
    return (tid & ((1 << lo) - 1)) | (s << lo) | ((tid >> lo) << (lo + 4))


def _swizzle(i):
    """ntt.cu:swz: XOR the 16-byte chunk bits 2..4 of a word index with a
    linear function of bits 5..8."""
    j = i >> 5
    h = ((j ^ (((j >> 2) & 1) * 3)) & 3) | ((j >> 1) & 4)
    return i ^ (h << 2)


def _mul_lazy(x, w, ws, p):
    """ntt.cu's lazy Shoup product: x*w - mulhi(x, ws)*p mod 2^32, in [0, 2p)."""
    q = (x * ws) >> np.uint64(32)
    return (x * w - q * p) & U32


def _emulate(x, dt, forward):
    """The kernel's schedule on uint64 copies of x [B, L, n]; asserts the
    lazy bounds at every stage."""
    n, L = dt.n, dt.L
    logn = n.bit_length() - 1
    p = np.asarray(dt.primes, dtype=np.uint64).reshape(1, L, 1)
    p2 = 2 * p
    tw = (dt.fwd_tw if forward else dt.inv_tw).numpy().astype(np.uint64)
    rounds = ntt_kernel.kernel_rounds(logn)
    offsets = np.cumsum([0] + [32 << (logn - lo - 4) for lo, _, _ in rounds])
    limit = 4 * p if forward else p2
    a = x.astype(np.uint64).copy()
    tid = np.arange(n // 16)
    order = range(len(rounds)) if forward else reversed(range(len(rounds)))
    for r in order:
        lo, alo, ahi = rounds[r]
        idx = _element(tid[:, None], np.arange(16)[None, :], lo)  # [threads, 16]
        v = a[:, :, idx]  # [B, L, threads, 16]
        rec = tw[:, offsets[r]:offsets[r + 1]].reshape(L, 8, -1, 4).transpose(0, 2, 1, 3)
        rec = rec.reshape(L, -1, 2, 16)[:, tid >> lo]
        w, ws = rec[None, :, :, 0], rec[None, :, :, 1]  # [1, L, threads, 16]
        bits = range(ahi - lo, alo - lo - 1, -1) if forward else range(alo - lo, ahi - lo + 1)
        for sb in bits:
            for s in range(16):
                if s & (1 << sb):
                    continue
                pos = ntt_kernel.twiddle_slot(sb, s >> (sb + 1))
                X, Y = v[..., s].copy(), v[..., s | (1 << sb)].copy()
                assert (X < limit).all() and (Y < limit).all()
                if forward:
                    X = np.minimum(X, (X - p2) & U32)
                    t = _mul_lazy(Y, w[..., pos], ws[..., pos], p)
                    v[..., s], v[..., s | (1 << sb)] = X + t, X - t + p2
                elif r == 0 and sb == 3:  # the last stage, with n^-1 folded in
                    v[..., s] = _mul_lazy(X + Y, w[..., 3], ws[..., 3], p)
                    v[..., s | (1 << sb)] = _mul_lazy(X - Y + p2, w[..., 0], ws[..., 0], p)
                else:
                    S = X + Y
                    v[..., s] = np.minimum(S, (S - p2) & U32)
                    v[..., s | (1 << sb)] = _mul_lazy(X - Y + p2, w[..., pos],
                                                      ws[..., pos], p)
        assert (v < limit[..., None]).all() and (v < (1 << 32)).all()
        a[:, :, idx] = v
    # canonical only at the end: two conditional subtractions (forward), one (inverse)
    if forward:
        a = np.minimum(a, (a - p2) & U32)
    a = np.minimum(a, (a - p) & U32)
    return a.astype(np.uint32)


CASES = [(2048, "tables_q"), (4096, "tables_q"), (4096, "tables_bsk")]


@pytest.mark.parametrize("n,base", CASES)
def test_schedule_equals_fhetpu_np_ntt(n, base):
    """The emulated kernels give fhetpu's np_ntt / np_intt bits, with every
    value inside its lazy range, on a batch of 3."""
    tables = getattr(FBfvParams.create(n=n, t=T), base)
    dt = ntt_kernel.device_tables(tables, "cpu")
    x = _residues(np.random.default_rng(n + len(base)), tables.primes, (3,), n)
    fx = _emulate(x, dt, forward=True)
    assert np.array_equal(fx, f_np_ntt(x, tables))
    assert np.array_equal(_emulate(fx, dt, forward=False), f_np_intt(fx, tables))
    assert np.array_equal(_emulate(fx, dt, forward=False), x)


@pytest.mark.parametrize("logn", ntt_kernel.KERNEL_LOGN)
def test_rounds_cover_every_stage_without_bank_conflicts(logn):
    """Each stage runs in exactly one round, inside the thread's window; the
    twiddle records have the size the kernel assumes; and every shared-memory
    access of every round is free of bank conflicts under the swizzle: 32
    distinct banks per warp for 4-byte accesses, 8 distinct 16-byte bank
    groups per quarter warp for the 16-byte accesses of a window at bit 0
    and of the copy-in."""
    n = 1 << logn
    rounds = ntt_kernel.kernel_rounds(logn)
    assert sorted(b for _, alo, ahi in rounds for b in range(alo, ahi + 1)) == list(range(logn))
    assert all(lo <= alo <= ahi <= lo + 3 < logn for lo, alo, ahi in rounds)
    slots = [ntt_kernel.twiddle_slot(sb, q) for sb in range(4) for q in range(1 << (3 - sb))]
    assert sorted(slots) == [0, 1, 2] + list(range(4, 16))
    tid = np.arange(n // 16)
    for lo, _, _ in rounds:
        if lo == 0:
            for c in range(4):
                chunk = _swizzle(16 * tid + 4 * c) >> 2
                assert all(len(set(g)) == 8 for g in (chunk % 8).reshape(-1, 8))
        else:
            for s in range(16):
                bank = _swizzle(_element(tid, s, lo)) % 32
                assert all(len(set(g)) == 32 for g in bank.reshape(-1, 32))
        idx = _element(tid[:, None], np.arange(16)[None, :], lo)
        assert np.array_equal(np.sort(idx.ravel()), np.arange(n))
        # the kernel swizzles a thread's base once and XORs in swz(s << lo)
        s16 = np.arange(16)[None, :]
        assert np.array_equal(_swizzle(idx), _swizzle(_element(tid[:, None], 0, lo))
                              ^ _swizzle(s16 << lo))
    for c in range(4):  # the copy-in: thread tid's c-th chunk is tid + c * threads
        chunk = _swizzle(4 * (tid + c * tid.size)) >> 2
        assert np.array_equal(chunk << 2, _swizzle(4 * tid) ^ _swizzle(4 * c * tid.size))
        assert all(len(set(g)) == 8 for g in (chunk % 8).reshape(-1, 8))
    assert np.array_equal(np.sort(_swizzle(np.arange(n))), np.arange(n))


def _tables_31_bit(n):
    """NTT tables for one prime above 2^30 (2^31 - 2^17 + 1 = 2147352577 is
    1 mod 2^17), built directly: NttTables refuses such primes."""
    p = (1 << 31) - (1 << 17) + 1
    logn = n.bit_length() - 1
    g = next(g for g in range(2, 100) if pow(pow(g, (p - 1) // (2 * n), p), n, p) == p - 1)
    psi = pow(g, (p - 1) // (2 * n), p)
    br = [int(format(i, f"0{logn}b")[::-1], 2) for i in range(n)]
    psi_br = np.array([[pow(psi, e, p) for e in br]], dtype=np.uint64)
    ipsi_br = np.array([[pow(psi, (2 * n - e) % (2 * n), p) for e in br]], dtype=np.uint64)
    n_inv = np.array([pow(n, p - 2, p)], dtype=np.uint64)
    pa = np.uint64(p)
    return ntt_kernel.DeviceNttTables.from_numpy(
        [p], psi_br, shoup(psi_br, pa), ipsi_br, shoup(ipsi_br, pa), n_inv,
        shoup(n_inv, pa), "cpu")


def test_kernel_path_refuses_primes_from_2_30():
    """check_kernel_tables, which the CUDA wrapper runs before any launch,
    raises on a prime >= 2^30 and on a ring degree without a kernel; the
    plain versions on a CPU tensor still take the 31-bit prime."""
    dt = _tables_31_bit(2048)
    with pytest.raises(ValueError, match="2\\^30"):
        ntt_kernel.check_kernel_tables(dt)
    x = torch.from_numpy(_residues(np.random.default_rng(1), dt.primes, (2,), 2048))
    fx = ntt_kernel.ntt_forward(x, dt)
    assert int(fx.to(torch.int64).max()) < dt.primes[0]
    assert torch.equal(ntt_kernel.ntt_inverse(fx, dt), x)
    ok = ntt_kernel.device_tables(FBfvParams.create(n=2048, t=T).tables_q, "cpu")
    ntt_kernel.check_kernel_tables(ok)
    small = ntt_kernel.device_tables(FBfvParams.create(n=1024, t=T).tables_q, "cpu")
    with pytest.raises(ValueError, match="takes n"):
        ntt_kernel.check_kernel_tables(small)
