"""The program's spans (``fhetpu_torch/trace.py``) on the CPU: one shared
no-op with no profiler on; under ``torch.profiler`` the resize tile (4x4 ->
3x3 at n=2048) and the harmonic decode server's step (6 positions, degree
2, n=2048) emit the spans PERF.md lists, nested as it lists them, and give
the same residues as without the profiler; the bicubic step opens its span
once a call, and ``rns.multiply`` counts its products' positions."""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fhetpu_torch import trace
from fhetpu_torch.bfv import crypto, rns
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Ct, Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.pipelines import resize as rz
from fhetpu_torch.pipelines import rle_decode as rd

torch.set_num_threads(2)

TILE = "pipelines.resize.resize_tile"
MULTIPLY = "bfv.evaluator.multiply"
# each span's parent, the innermost program span around it
ENCRYPTED = {TILE: None, "pipelines.resize.gather": TILE, MULTIPLY: TILE,
             "bfv.evaluator.linear": TILE, "bfv.rns.extend": MULTIPLY,
             "bfv.rns.tensor": MULTIPLY, "bfv.rns.scale_floor": MULTIPLY,
             "bfv.rns.convert": MULTIPLY}
PLAIN = {TILE: None, "pipelines.resize.gather": TILE, "bfv.evaluator.transform": TILE,
         "bfv.evaluator.multiply_plain": TILE, "bfv.evaluator.linear": TILE}
EXPAND, TABLES = "pipelines.rle_decode.expand", "pipelines.rle_decode.weight_tables"
CUBIC = "pipelines.resize.cubic_interp"
PROGRAM = {"pipelines.resize.resize_tile", "pipelines.resize.gather",
           "bfv.evaluator.transform", "bfv.evaluator.multiply_plain", "bfv.evaluator.linear",
           "bfv.evaluator.multiply", "bfv.rns.extend", "bfv.rns.tensor",
           "bfv.rns.scale_floor", "bfv.rns.convert", EXPAND, TABLES, CUBIC}


def _spans(prof):
    """Counter of (span, parent span) over the program's spans."""
    out = Counter()
    for e in prof.events():
        if e.name not in PROGRAM:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in PROGRAM:
            parent = parent.cpu_parent
        out[(e.name, parent.name if parent is not None else None)] += 1
    return out


@pytest.fixture(scope="module", params=["encrypted", "plain"])
def tile(request):
    """One bilinear tile, 4x4 -> 3x3 at n=2048, without and with the
    profiler: (fracts, output without, output with, span counter)."""
    n, t = 2048, 1 << 14
    par = BfvParams.create(n=n, t=t)
    kg = crypto.KeyGenerator(par, seed=61)
    encoder = FractionalEncoder(t, n)
    img = np.random.default_rng(61).integers(0, 256, size=(4, 4, 3), dtype=np.uint8)
    coeffs = encoder.encode_batch(img.astype(np.float64)).reshape(-1, n)
    cts = crypto.Encryptor(par, kg.public_key(), seed=62).encrypt_batch(coeffs)
    src = torch.from_numpy(cts.reshape(4, 4, 3, 2, par.L, n))
    ev = Evaluator(par, encoder, device="cpu")
    rp = cp = rz.axis_plan(4, 3, rz.BILINEAR)
    plain = request.param == "plain"
    encryptor = None if plain else crypto.Encryptor(par, kg.public_key(), seed=9)
    yops, xops = rz.make_fract_bundles(ev, rp, cp, rz.BILINEAR, encryptor=encryptor)

    def run():
        return rz.resize_tile(ev, src, rp, cp, yops, xops, rz.BILINEAR, plain)

    off = run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    return request.param, off, on, _spans(prof)


def test_a_span_is_one_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("a") is trace.span("bfv.rns.tensor") is trace._OFF
    with trace.span("a") as entered:
        assert entered is None


def test_a_span_records_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("a") is not trace._OFF
        with trace.span("fhetpu_torch.test_span"):
            torch.ones(4).sum()
    assert [e.name for e in prof.events()].count("fhetpu_torch.test_span") == 1
    assert trace.span("a") is trace._OFF


def test_the_tile_emits_the_listed_spans_nested_as_listed(tile):
    """Encrypted fracts: the tile, the gather, six BEHZ products, each with
    its four steps, and three adds; plain fracts: no ct x ct and so no
    bfv.rns span, the grid's forward and the output's inverse transform."""
    fracts, _, _, got = tile
    if fracts == "encrypted":
        want = {(s, p): 6 for s, p in ENCRYPTED.items() if p == MULTIPLY}
        want.update({(TILE, None): 1, ("pipelines.resize.gather", TILE): 1,
                     (MULTIPLY, TILE): 6, ("bfv.evaluator.linear", TILE): 3})
    else:
        want = {(TILE, None): 1, ("pipelines.resize.gather", TILE): 1,
                ("bfv.evaluator.transform", TILE): 2,
                ("bfv.evaluator.multiply_plain", TILE): 6, ("bfv.evaluator.linear", TILE): 3}
        assert not any(s.startswith("bfv.rns.") for s, _ in got)
    assert dict(got) == want
    assert {s: p for s, p in got} == (ENCRYPTED if fracts == "encrypted" else PLAIN)


def test_the_profiler_leaves_the_residues_as_they_are(tile):
    _, off, on, _ = tile
    assert off.dtype == on.dtype == torch.uint32 and torch.equal(off, on)


@pytest.fixture(scope="module")
def decode():
    """One channel's harmonics (degree 2, 5 harmonics) expanded at 6
    positions by the server's step, with the weight tables built under the
    profiler and then cached: (output without, output with the profiler,
    expand_harmonics_server then transform_from_ntt, the program's spans in
    the order they opened, the counters' increments, the ring's shape)."""
    n, t, order, degree = 2048, 1 << 14, 64, 2
    par = BfvParams.create(n=n, t=t)
    encoder = FractionalEncoder(t, n)
    pairs = [(200, 2), (13, 3), (255, 1)]
    harm = rd.fourier_harmonics_host(pairs, order, degree, 0.5)
    kg = crypto.KeyGenerator(par, seed=63)
    cts = crypto.Encryptor(par, kg.public_key(), seed=64).encrypt_batch(
        encoder.encode_batch(harm))
    ev = Evaluator(par, encoder, device="cpu")
    pos = np.arange(6)
    ct = Ct(torch.from_numpy(cts))
    fn = rd.expand_harmonics_batched
    calls, products = fn.calls, fn.products
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = rd.serve_harmonics_channel(ev, ct, pos, order, degree)
    counted = (fn.calls - calls, fn.products - products)
    off = rd.serve_harmonics_channel(ev, ct, pos, order, degree)
    server = ev.transform_from_ntt(rd.expand_harmonics_server(ev, ct, pos, order, degree))
    opened = [(e.name, e.cpu_parent.name if e.cpu_parent is not None else None)
              for e in sorted(prof.events(), key=lambda e: e.time_range.start)
              if e.name in PROGRAM]
    return off, on, server, opened, counted, (2 * degree + 1, len(pos), 2, par.L, n)


def test_the_decode_step_emits_its_spans_and_counts_its_products(decode):
    """The expansion, with the harmonics' forward transform and the first
    call's table build inside it, then the output's inverse transform; one
    call of H * P * size * L * n modular products."""
    _, _, _, opened, counted, (H, P, size, L, n) = decode
    assert opened == [(EXPAND, None), (TABLES, EXPAND), ("bfv.evaluator.transform", EXPAND),
                      ("bfv.evaluator.transform", None)]
    assert counted == (1, H * P * size * L * n)


def test_the_decode_step_keeps_its_residues(decode):
    """The same residues with the profiler on and off, and those of the
    stacked-product expansion followed by the inverse transform."""
    off, on, server, _, _, (_, P, size, L, n) = decode
    assert not off.ntt_form and off.data.dtype == torch.uint32
    assert off.data.shape == (P, size, L, n)
    assert torch.equal(off.data, on.data) and torch.equal(off.data, server.data)


def test_the_cubic_step_opens_its_span_and_multiply_counts_positions():
    """One Catmull-Rom step of size-5 operands [1, 2, 1] against fract
    ciphertexts [2, 1, 1] of sizes 2, 3, 4 (random residues, n=2048), as
    the bicubic column pass runs it: one span around its three products,
    5x4, 5x3 and 5x2; each product counts its operands' (component,
    coefficient) positions as passed and its broadcast output's, and a
    square counts its operand once."""
    n = 2048
    par = BfvParams.create(n=n, t=1 << 14)
    ev = Evaluator(par, FractionalEncoder(par.t, n), device="cpu")
    gen = torch.Generator().manual_seed(65)

    def ct(batch, size):
        return Ct(torch.randint(0, 1 << 26, batch + (size, par.L, n), generator=gen))

    px = [ct((1, 2, 1), 5) for _ in range(4)]
    fr = SimpleNamespace(t=ct((2, 1, 1), 2), t2=ct((2, 1, 1), 3), t3=ct((2, 1, 1), 4))
    fn = rns.multiply
    before = (fn.calls, fn.positions_in, fn.positions_out)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = rz.cubic_interp(ev, *px, fr, False)
    ev.square(fr.t3)
    counted = tuple(c - b for c, b in zip((fn.calls, fn.positions_in, fn.positions_out), before))
    assert out.size == 8 and tuple(out.data.shape[:3]) == (2, 2, 1)
    got = _spans(prof)
    assert got[(CUBIC, None)] == 1 and got[(MULTIPLY, CUBIC)] == 3
    pairs = ((5, 4), (5, 3), (5, 2))
    assert counted == (4, sum(2 * k1 * n + 2 * k2 * n for k1, k2 in pairs) + 2 * 4 * n,
                       sum(4 * (k1 + k2 - 1) * n for k1, k2 in pairs) + 2 * 7 * n)
