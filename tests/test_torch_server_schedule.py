"""The strict fused kernel's schedule (``fhetpu_torch/csrc/server_ycc_dct_strict.cu``),
emulated in NumPy on the CPU.

The emulation follows the kernel step for step: a CTA of 8 warps takes one
(block, component) and 32 lanes, warp g loads slots 8g..8g+7 of R, G and B,
computes Y, Cb and Cr and the row pass in registers, writes the rows to
shared memory at word (ch*64 + slot)*32 + lane, and after the barrier reads
column g, runs the column pass with x0.125 and stores it.  Every value goes
through the kernel's lazy schedule, and each one is asserted below its
stated bound (4p at most, so below 2^32 for p < 2^30).  Each warp access to
shared memory must hit 32 distinct banks, and every shared word must be
written once and read once.  The outputs must equal ``server_ycc_dct_plain``
(and, in ``tests/test_torch_server.py``, fhetpu's fused kernel), including
on the n = 16384 chain's 30-bit primes and on the largest prime below 2^30,
with every input at p - 1, the worst case for the bounds.
"""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fhetpu_torch.bfv.evaluator import Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.core import server_kernel
from fhetpu_torch.core.modops import shoup

T = 1 << 14
U32 = np.uint64(0xFFFFFFFF)
LANES = 32  # kLanes: a warp's lanes, one CTA's lane tile
YCC_ROW, SUB_ROW, P_ROW = 13, 21, 22


class _Lazy:
    """The kernel's arithmetic on uint64 copies, each result checked below
    its bound in multiples of the lane's p."""

    def __init__(self, p):
        self.p, self.p2 = p, 2 * p

    def below(self, v, k):
        assert (v < k * self.p).all() and (v < (1 << 32)).all()
        return v

    def add(self, a, b):
        return self.below(a + b, 4)

    def sub(self, a, b):  # a + 2p - b
        self.below(b, 2)
        return self.below(a + self.p2 - b, 4)

    def red(self, v):  # min(x, x - 2p): [0, 4p) -> [0, 2p)
        self.below(v, 4)
        return self.below(np.minimum(v, (v - self.p2) & U32), 2)

    def canon(self, v):  # min(x, x - p): [0, 2p) -> [0, p)
        self.below(v, 2)
        return self.below(np.minimum(v, (v - self.p) & U32), 1)

    def mul(self, v, w, ws):  # x*w - mulhi(x, w')*p mod 2^32, in [0, 2p)
        self.below(v, 4)
        q = (v * ws) >> np.uint64(32)
        return self.below((v * w - q * self.p) & U32, 2)


def _aan8(a, m, w, ws):
    """aan8_lazy: inputs < 2p, outputs < 4p, in the kernel's order."""
    def mul(v, ci):
        return m.mul(v, w[ci], ws[ci])

    for v in a:
        m.below(v, 2)
    t0, t7 = m.red(m.add(a[0], a[7])), m.red(m.sub(a[0], a[7]))
    t1, t6 = m.red(m.add(a[1], a[6])), m.red(m.sub(a[1], a[6]))
    t2, t5 = m.red(m.add(a[2], a[5])), m.red(m.sub(a[2], a[5]))
    t3, t4 = m.red(m.add(a[3], a[4])), m.red(m.sub(a[3], a[4]))
    t10, t13 = m.red(m.add(t0, t3)), m.red(m.sub(t0, t3))
    t11, t12 = m.red(m.add(t1, t2)), m.red(m.sub(t1, t2))
    o = [None] * 8
    o[0], o[4] = m.add(t10, t11), m.sub(t10, t11)
    z1e = mul(m.add(t12, t13), 0)
    o[2], o[6] = m.add(z1e, mul(t13, 1)), m.add(z1e, mul(t12, 2))
    z1, z2, z3, z4 = m.add(t4, t7), m.add(t5, t6), m.add(t4, t6), m.add(t5, t7)
    z5 = mul(m.add(m.red(z3), m.red(z4)), 3)
    z1m, z2m = mul(z1, 8), mul(z2, 9)
    z3m, z4m = m.red(m.add(mul(z3, 10), z5)), m.red(m.add(mul(z4, 11), z5))
    o[7] = m.add(m.red(m.add(mul(t4, 4), z1m)), z3m)
    o[5] = m.add(m.red(m.add(mul(t5, 5), z2m)), z4m)
    o[3] = m.add(m.red(m.add(mul(t6, 6), z2m)), z3m)
    o[1] = m.add(m.red(m.add(mul(t7, 7), z1m)), z4m)
    return o


def _conflict_free(addr):
    """Each warp's 32 word addresses (one lane tile each) in 32 banks."""
    banks = np.sort(addr.reshape(-1, LANES) % 32, axis=1)
    assert (banks == np.arange(32)).all()


def emulate_strict_kernel(x, consts, consts_shoup):
    """The strict kernel on x uint32 [nb, 3, 64, 2, ...] (lanes last, L*n of
    them) with the [24, L*n] tables: returns x's shape, uint32."""
    nb = x.shape[0]
    lanes = consts.shape[1]
    xv = np.asarray(x).reshape(nb, 3, 64, 2, lanes).astype(np.uint64)
    C, Csh = np.asarray(consts, np.uint64), np.asarray(consts_shoup, np.uint64)
    tiles = -(-lanes // LANES)
    j0 = np.arange(tiles * LANES)  # thread (tile, lane) of every CTA of a (block, comp)
    live = j0 < lanes
    j = np.minimum(j0, lanes - 1)  # a thread past the last lane computes on lanes - 1
    tile, lane = j0 // LANES, j0 % LANES
    m = _Lazy(C[P_ROW, j])
    xin = xv[..., j]  # [nb, 3, 64, 2, threads]
    sub = np.stack([C[SUB_ROW, j], np.zeros_like(j, dtype=np.uint64)])  # comp 0, comp 1
    yw, ys = C[YCC_ROW:YCC_ROW + 8, j], Csh[YCC_ROW:YCC_ROW + 8, j]
    w, ws = C[:13, j], Csh[:13, j]
    smem = np.zeros((nb, 2, tiles, 3 * 64 * LANES), dtype=np.uint64)
    writes = np.zeros((tiles, 3 * 64 * LANES), dtype=np.int64)
    reads = np.zeros_like(writes)

    for g in range(8):  # warp g: row g
        chans = [[], [], []]
        for i in range(8):
            r, gr, bl = (xin[:, c, 8 * g + i] for c in range(3))  # [nb, 2, threads]
            P = [m.mul(v, yw[k], ys[k]) for k, v in enumerate((r, gr, bl, r, gr, bl, gr, bl))]
            p5r = m.mul(r, yw[5], ys[5])
            chans[0].append(m.red(m.add(m.red(m.add(P[0], P[1])), m.red(m.sub(P[2], sub)))))
            chans[1].append(m.red(m.add(m.red(m.sub(P[3], P[4])), P[5])))
            chans[2].append(m.red(m.sub(m.red(m.sub(p5r, P[6])), P[7])))
        for ch in range(3):
            row = _aan8(chans[ch], m, w, ws)
            for i in range(8):
                addr = (ch * 64 + 8 * g + i) * LANES + lane
                _conflict_free(addr)
                smem[:, :, tile, addr] = m.red(row[i])
                np.add.at(writes, (tile, addr), 1)
    assert (writes == 1).all()

    out = np.zeros((nb, 3, 64, 2, lanes), dtype=np.uint64)
    for g in range(8):  # after the barrier, warp g: column g
        for ch in range(3):
            col = []
            for i in range(8):
                addr = (ch * 64 + g + 8 * i) * LANES + lane
                _conflict_free(addr)
                col.append(smem[:, :, tile, addr])
                np.add.at(reads, (tile, addr), 1)
            col = _aan8(col, m, w, ws)
            for i in range(8):
                v = m.canon(m.mul(col[i], w[12], ws[12]))
                out[:, ch, g + 8 * i, :, j0[live]] = np.moveaxis(v[..., live], -1, 0)
    assert (reads == 1).all()
    return out.astype(np.uint32).reshape(x.shape)


def _residues(rng, primes, prefix, n):
    return np.stack(
        [rng.integers(0, int(p), size=tuple(prefix) + (n,), dtype=np.uint64)
         for p in primes], axis=-2).astype(np.uint32)


def _plain(x, consts, consts_shoup):
    state = SimpleNamespace(consts=torch.from_numpy(consts),
                            consts_shoup=torch.from_numpy(consts_shoup))
    return server_kernel.server_ycc_dct_plain(torch.from_numpy(x), state).numpy()


def test_schedule_equals_plain_at_2048():
    """n = 2048, nb = 1, random residues: the emulated kernel gives
    server_ycc_dct_plain's bits."""
    par = BfvParams.create(n=2048, t=T)
    C, Csh = server_kernel.pack_server_constants(Evaluator(par, device="cpu"))
    x = _residues(np.random.default_rng(3), par.q_primes, (1, 3, 64, 2), 2048)
    assert np.array_equal(emulate_strict_kernel(x, C, Csh), _plain(x, C, Csh))


@functools.lru_cache(maxsize=None)
def _slice_16384():
    """24 lanes of each of the n = 16384 chain's 15 limbs (11 30-bit primes):
    the op is lane-wise, so the slice's tables give the full op's bits on
    those lanes; 360 lanes leave the last lane tile ragged."""
    par = BfvParams.create(n=16384, t=T)
    C, Csh = server_kernel.pack_server_constants(Evaluator(par, device="cpu"))
    sel = (np.arange(par.L)[:, None] * par.n + np.arange(24)[None, :]).reshape(-1)
    return C[:, sel], Csh[:, sel]


def _table_below_2_30(lanes, rng):
    """A [24, lanes] table on 1073741789, the largest prime below 2^30, with
    random constants and their Shoup companions."""
    p = 1073741789
    C = rng.integers(0, p, size=(24, lanes), dtype=np.uint64)
    C[P_ROW], C[23] = p, 0
    Csh = shoup(C, np.uint64(p)).astype(np.uint64)
    Csh[SUB_ROW:] = 0
    return C.astype(np.uint32), Csh.astype(np.uint32)


@pytest.mark.parametrize("table", ["16384", "2^30-35"])
@pytest.mark.parametrize("inputs", ["random", "p-1"])
def test_schedule_equals_plain_near_2_30(table, inputs):
    """On a lane slice of the n = 16384 chain and on the largest prime below
    2^30, with random residues and with every input at p - 1, every value
    stays below its bound and the outputs equal server_ycc_dct_plain."""
    rng = np.random.default_rng(5)
    C, Csh = _slice_16384() if table == "16384" else _table_below_2_30(72, rng)
    p = C[P_ROW].astype(np.uint64)
    if inputs == "random":
        x = (rng.integers(0, 1 << 62, size=(2, 3, 64, 2, 1, p.size), dtype=np.uint64) % p)
    else:
        x = np.broadcast_to(p - 1, (1, 3, 64, 2, 1, p.size))
    x = np.ascontiguousarray(x.astype(np.uint32))
    assert np.array_equal(emulate_strict_kernel(x, C, Csh), _plain(x, C, Csh))


def test_kernel_path_refuses_primes_from_2_30():
    """The fused wrapper's kernel path checks the primes before it builds or
    launches anything: a 31-bit prime raises ValueError (without the check,
    a machine without nvcc would fail in the build instead); the n = 16384
    chain passes."""
    par = BfvParams.create(n=2048, t=T)
    st = Evaluator(par, device="cpu").server_state("cpu")
    wide = dataclasses.replace(st, q_primes=((1 << 31) - (1 << 17) + 1,) * par.L)
    x = torch.zeros((1, 3, 64, 2, par.L, par.n), dtype=torch.int64).to(torch.uint32)
    with pytest.raises(ValueError, match="2\\^30"):
        server_kernel._launch(x, wide, 0)
    server_kernel.check_kernel_primes(st)
    server_kernel.check_kernel_primes(SimpleNamespace(q_primes=BfvParams.create(n=16384).q_primes))
