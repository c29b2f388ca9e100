"""The bicubic resize cell (``resize_bicubic8192.resident``) on the CPU at a
tiny size with the plain kernels: a whole result line on large seeds, a
planted fault in the stencil and the control not correct, and the bicubic
readers' None where they find nothing to read; one ``gpu`` test runs the
cell traced on the card.

The chain is n = 4096's four primes at t = 64: at t = 2^14 the depth-4
chain at n = 4096 leaves no noise budget (the outputs decrypt wrong), so
the cell's n = 8192 stays for the card."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
from conftest import ROOT, SEED, TINY

import faults
from perfbench import bicubic_spans, harness

WORKLOAD = "resize_bicubic8192.resident"
CHAIN = {"n": 4096, "t": 64, "q_primes": [268369921, 132710401, 132120577, 131923969],
         "q_bits": 109, "bsk_size": 6}
CELL = {"config": CHAIN, "traffic": {**TINY, "src_hw": [4, 4], "dst_hw": [2, 2],
                                     "tile_rows": 1, "images": 1}}


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


def test_a_changed_constant_in_the_stencil_is_not_correct():
    """The encoder's polynomial for 5 (1 + x^2) given one more coefficient
    (1 + x^2 + x^3, the polynomial for 13) in the Catmull-Rom step's b."""
    from fhetpu_torch.bfv.evaluator import Evaluator

    def wrap(encode):
        def fn(self, value):
            return encode(self, 13.0 if float(value) == 5.0 else value)

        return fn

    with faults.planted(Evaluator, "encode", wrap):
        r = dry_run()
    assert r["correct"] is False and r["failed"] == 1
    assert r["compared"]["mismatched_coeffs"]["value"] > 0


def test_the_control_is_not_correct():
    _, _, config, traffic = harness.cell_data(WORKLOAD, CELL)
    control = harness.load_module("kinds", traffic["kind"]).CONTROL
    with control(config):
        r = dry_run(SEED + 1)
    assert r["correct"] is False
    assert r["compared"]["mismatched_coeffs"]["value"] > 0


def test_the_bicubic_readers_read_nothing_where_nothing_was_traced(monkeypatch):
    """None in an untraced run, and in a traced one of a program whose
    products do not count their positions (an older program)."""
    from fhetpu_torch.bfv import rns

    names = per_layer_names() - {"tile_roofline.bicubic", "idle_pct.bicubic"}
    assert names == {"behz_ms.bicubic", "tensor_roofline.bicubic", "stencil_ms.bicubic",
                     "ntt_roofline.bicubic"}
    untraced = SimpleNamespace(trace=None, cell=None)
    assert all(harness.load_module("metrics", m).read(untraced) is None for m in names)
    monkeypatch.delattr(rns.multiply, "positions_in")
    traced = SimpleNamespace(trace=object(), cell=None)
    assert bicubic_spans.window(traced) is None
    assert all(harness.load_module("metrics", m).read(traced) is None for m in names)


@pytest.mark.gpu
def test_the_cell_runs_traced_on_the_card(cuda_card):
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", WORKLOAD,
                        "--seed", str(2**32 + SEED), "--seconds", "3", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and set(line["metrics"]) == per_layer_names()
