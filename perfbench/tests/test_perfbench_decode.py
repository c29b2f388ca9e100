"""The decode cell (``decode_harmonics2048.resident``) on the CPU at a tiny
size (a 4x4 image, degree 2) with the plain kernels: a whole result line on
large seeds, planted faults and the control not correct, the reference's
expansion equal to the program's, and the decode readers' None where they
find nothing to read; one ``gpu`` test runs the cell traced on the card."""

import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import ROOT, SEED, TINY

import faults
from perfbench import decode_spans, harness

WORKLOAD = "decode_harmonics2048.resident"
CELL = {"config": {"image_hw": [4, 4], "degree": 2}, "traffic": {**TINY, "images": 1}}


def dry_run(seed: int = SEED) -> dict:
    return harness.run(WORKLOAD, seed, 0.0, False, device="cpu", overrides=CELL)


def per_layer_names() -> set:
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    return {m["name"] for m in bench["per_layer"] if WORKLOAD in m.get("workloads", [WORKLOAD])}


@pytest.mark.parametrize("seed", [SEED, 2**32 + 4099])
def test_a_dry_run_prints_a_whole_result_line(seed):
    r = dry_run(seed)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {k: v["unit"] for k, v in r["metrics"].items()} == {"resize_images_per_s": "images/s",
                                                               "setup_s": "s"}
    assert r["compared"] == {"mismatched_coeffs": {"value": 0, "limit": 0}}
    assert list(r)[-1] == "compared"
    json.dumps(r)


def _moved(out: torch.Tensor) -> torch.Tensor:
    """The first output's plaintext moved by one in one coefficient: Delta =
    floor(q / t) added to its c0 in every prime.  (One residue moved by one
    moves the plaintext by t / p_0 * (q / p_0)^-1 mod p_0, 0.028 on this
    chain, which decrypts as before.)"""
    _, _, config, _ = harness.cell_data(WORKLOAD, CELL)
    primes, t = config["q_primes"], config["t"]
    delta = math.prod(primes) // t
    wide = out.to(torch.int64)
    for l, p in enumerate(primes):
        wide[0, 0, l, 0] = (wide[0, 0, l, 0] + delta % p) % p
    return wide.to(out.dtype)


def test_a_fault_in_the_server_step_is_not_correct():
    """Half of each channel's outputs zeroed, or one plaintext moved."""
    from fhetpu_torch.bfv.evaluator import Ct
    from fhetpu_torch.pipelines import rle_decode as rd

    for bad in (faults._half, _moved):
        def wrap(step):
            def fn(*args, **kwargs):
                out = step(*args, **kwargs)
                return Ct(bad(out.data), out.ntt_form)

            return fn

        with faults.planted(rd, "serve_harmonics_channel", wrap):
            r = dry_run()
        assert r["correct"] is False and r["failed"] == 1
        assert r["compared"]["mismatched_coeffs"]["value"] > 0


def test_the_control_is_not_correct():
    _, _, config, traffic = harness.cell_data(WORKLOAD, CELL)
    control = harness.load_module("kinds", traffic["kind"]).CONTROL
    for seed in (SEED, SEED + 1, SEED + 2):
        with control(config):
            r = dry_run(seed)
        assert r["correct"] is False
        assert r["compared"]["mismatched_coeffs"]["value"] > 0


def test_the_references_expansion_is_the_programs():
    """On seeded random runs: the client's aggregation, the encoder and the
    expansion's plaintexts against the program's, 6 positions at degree 3."""
    from fhetpu_torch.bfv.encoder import FractionalEncoder
    from fhetpu_torch.bfv.evaluator import Ct, Evaluator
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.pipelines import rle_decode as rd

    from perfbench.reference import decode
    from perfbench.reference.bfv import SecretKey
    from perfbench.reference.ring import Encoder, Ring

    n, t, order, degree = 2048, 1 << 14, 64, 3
    par = BfvParams.create(n=n, t=t)
    rng = np.random.default_rng(SEED)
    pairs = decode.run_length_pairs(np.repeat(rng.integers(0, 256, 9), rng.integers(1, 6, 9)))
    harm = decode.channel_harmonics(pairs, order, degree, 0.5)
    assert np.array_equal(harm, rd.fourier_harmonics_host(pairs, order, degree, 0.5))
    enc = Encoder(t, n, 100, 100)
    values = np.concatenate([harm, decode.weights(np.arange(6), order, degree).reshape(-1)])
    plain = decode.encode_batch(enc, values)
    assert np.array_equal(plain, np.stack([enc.encode(v) for v in values]))
    assert np.array_equal(plain, FractionalEncoder(t, n).encode_batch(values))
    gen = torch.Generator().manual_seed(SEED)
    sk = SecretKey(Ring(par.q_primes, n), t, gen)
    cts = sk.encrypt(plain[:len(harm)], gen).to(torch.uint32)
    out = rd.serve_harmonics_channel(Evaluator(par, FractionalEncoder(t, n), device="cpu"),
                                     Ct(cts), np.arange(6), order, degree)
    got, _ = sk.decrypt(out.data)
    want = decode.DecodeReference(enc, np.arange(6), order, degree, "cpu").plain(plain[:len(harm)])
    assert torch.equal(got, want)


def test_the_decode_readers_read_nothing_where_nothing_was_traced(monkeypatch):
    """None in an untraced run, and in a traced one of a program whose
    expansion does not count its calls (an older program)."""
    from fhetpu_torch.pipelines import rle_decode as rd

    names = per_layer_names() - {"decode_roofline", "idle_pct.decode"}
    assert names == {"expand_ms.decode", "ntt_roofline.decode"}
    untraced = SimpleNamespace(trace=None, cell=None)
    assert all(harness.load_module("metrics", m).read(untraced) is None for m in names)
    monkeypatch.delattr(rd.expand_harmonics_batched, "calls")
    traced = SimpleNamespace(trace=object(), cell=None)
    assert decode_spans.window(traced) is None
    assert all(harness.load_module("metrics", m).read(traced) is None for m in names)


@pytest.mark.gpu
def test_the_cell_runs_traced_on_the_card(cuda_card):
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", WORKLOAD,
                        "--seed", str(2**32 + SEED), "--seconds", "3", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and set(line["metrics"]) == per_layer_names()
