"""Every cell's whole run on the CPU at a tiny size, with the plain kernels,
and what the run may import."""

import json
import os
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT, SEED, dry_run

from perfbench import harness


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_dry_run_prints_a_whole_result_line(workload):
    r = dry_run(workload)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    want = {m["name"]: m["unit"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {k: v["unit"] for k, v in r["metrics"].items()} == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(r)[-1] == "compared" and all(c["value"] <= c["limit"]
                                            for c in r["compared"].values())
    json.dumps(r)


def test_no_run_loads_jax_or_fhetpu():
    """Top-level module names compared whole: fhetpu_torch is not fhetpu."""
    code = ("import sys; sys.path.insert(0, 'perfbench/tests'); import conftest; "
            "from perfbench import harness; "
            "[conftest.dry_run(w) for w in conftest.CELLS]; "
            "print(harness.leftover_modules(), 'fhetpu_torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split("\n")[-2] == "[] True"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, importlib, pkgutil; sys.path.insert(0, '.'); "
            "import perfbench.reference as ref; "
            "[importlib.import_module('perfbench.reference.' + m.name) "
            " for m in pkgutil.iter_modules(ref.__path__)]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'fhetpu_torch', 'fhetpu', 'jax', 'jaxlib', 'flax'}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "[]"


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(cuda_card):
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "jpeg4096.resident",
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
