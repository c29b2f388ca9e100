"""Tests of the benchmark, run on the CPU at tiny sizes with the plain
kernels:  python -m pytest perfbench/tests -q
Tests marked ``gpu`` run a cell on the card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SEED = 2**31 + 977  # more than 32 signed bits hold, as a check's seeds may
TINY = {"warmup_units": 1, "warmup_s": 0, "samples": 1, "sample_within": 1}
SMALL_CHAIN = {"n": 2048, "q_primes": [132710401, 132120577]}
# each cell shrunk to what a test run holds; the resize cells keep n = 4096,
# the least ring degree whose noise budget the ct x ct product survives
CELLS = {
    "jpeg4096.resident": {"config": SMALL_CHAIN, "traffic": {**TINY, "chunks": 2, "blocks": 2}},
    "resize_bilinear4096.resident": {"traffic": {**TINY, "src_hw": [4, 4], "dst_hw": [3, 3],
                                                 "tile_rows": 2, "images": 1}},
    "resize_bilinear4096.plainfract": {"traffic": {**TINY, "src_hw": [4, 4], "dst_hw": [3, 3],
                                                   "images": 1}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def dry_run(workload: str, seed: int = SEED) -> dict:
    from perfbench import harness

    return harness.run(workload, seed, 0.0, False, device="cpu", overrides=CELLS[workload])
