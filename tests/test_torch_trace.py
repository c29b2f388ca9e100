"""The program's spans (``fhetpu_torch/trace.py``) on the CPU: one shared
no-op with no profiler on; under ``torch.profiler`` the resize tile (4x4 ->
3x3 at n=2048) emits the spans PERF.md lists, nested as it lists them, and
gives the same residues as without the profiler."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fhetpu_torch import trace
from fhetpu_torch.bfv import crypto
from fhetpu_torch.bfv.encoder import FractionalEncoder
from fhetpu_torch.bfv.evaluator import Evaluator
from fhetpu_torch.bfv.params import BfvParams
from fhetpu_torch.pipelines import resize as rz

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
PROGRAM = {"pipelines.resize.resize_tile", "pipelines.resize.gather",
           "bfv.evaluator.transform", "bfv.evaluator.multiply_plain", "bfv.evaluator.linear",
           "bfv.evaluator.multiply", "bfv.rns.extend", "bfv.rns.tensor",
           "bfv.rns.scale_floor", "bfv.rns.convert"}


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
