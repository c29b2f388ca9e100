"""fhetpu_torch.bench.noise_validation against fhetpu's measured noise
budgets and its live noise model.

``bench_results/noise_validation.json`` is fhetpu's committed sweep,
measured on a TPU: 66 points, 7 pipelines x n in {2048, 4096, 8192, 16384}
x t in {64, 1024, 16384}.  The port runs the same seeds through residue-equal
ops, so at every n = 2048 point its measured budget must equal the
artifact's exactly (tolerance 0).  The model columns are held to fhetpu's
live ``fhetpu.bfv.noise`` rather than to the artifact's, which
``scripts/noise_reeval.py`` exists to refresh: at every one of the 66
points the port's rounded mean and worst budgets, gate, conservative and
gate_mismatch must equal those computed from fhetpu's model on the same
measured budget.  One test per pipeline, so the file stays at 7 tests.
"""

import json
import math
import os

import pytest
import torch

from fhetpu.bfv import noise as f_noise
from fhetpu.bfv.encoder import FractionalEncoder as FEncoder
from fhetpu.bfv.params import BfvParams as FParams

from fhetpu_torch.bench import noise_validation as nv

torch.set_num_threads(2)

ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "bench_results", "noise_validation.json")

# fhetpu's model calls of fhetpu/bench/noise_validation.py, per pipeline
F_MODELS = {
    "jpeg": lambda p, e, m: f_noise.estimate_jpeg_pipeline(p, e, mean=m),
    "bilinear_plain": lambda p, e, m: f_noise.estimate_resize_pipeline(
        p, e, False, plain_fracts=True, mean=m),
    "bilinear_ctct": lambda p, e, m: f_noise.estimate_resize_pipeline(
        p, e, False, plain_fracts=False, mean=m),
    "bicubic_plain": lambda p, e, m: f_noise.estimate_resize_pipeline(
        p, e, True, plain_fracts=True, mean=m),
    "bicubic_ctct": lambda p, e, m: f_noise.estimate_resize_pipeline(
        p, e, True, plain_fracts=False, mean=m),
    "bicubic_ctct_relin": lambda p, e, m: f_noise.estimate_resize_pipeline(
        p, e, True, plain_fracts=False, mean=m, relin_dbc=16),
    "decode_harmonics48": lambda p, e, m: f_noise.estimate_harmonics_decode(p, e, 48, mean=m),
}


def fhetpu_row(pipeline, n, t, measured):
    """The row fhetpu's run_point builds from its live model and a measured
    budget (fhetpu/bench/noise_validation.py:run_point)."""
    par, enc = FParams.create(n=n, t=t), FEncoder(t, n)
    mean, worst = F_MODELS[pipeline](par, enc, True), F_MODELS[pipeline](par, enc, False)
    return {"pipeline": pipeline, "n": n, "t": t, "measured_budget": measured,
            "model_mean_budget": round(mean.budget_bits, 1),
            "model_worst_budget": round(worst.budget_bits, 1),
            "gate": "run" if not mean.exhausted() else "refuse",
            "conservative": bool(math.floor(mean.budget_bits) <= measured),
            "gate_mismatch": bool(not mean.exhausted() and measured == 0)}


def artifact_rows(pipeline):
    with open(ARTIFACT) as f:
        return [r for r in json.load(f) if r["pipeline"] == pipeline]


@pytest.mark.parametrize("pipeline", list(nv.PIPELINES))
def test_pipeline_budgets_equal_fhetpu(pipeline):
    """Measured on the CPU, the port's budget equals the artifact's at each
    n = 2048 point, and its row equals fhetpu's live model's row there; at
    every n of the artifact, the port's model row on the artifact's
    measured budget equals fhetpu's."""
    rows = artifact_rows(pipeline)
    assert len(rows) == (12 if pipeline == "jpeg" else 9)  # 66 points in all
    for want in rows:
        n, t = want["n"], want["t"]
        if n == 2048:
            got = nv.run_point(pipeline, n, t, device="cpu")
            assert got["measured_budget"] == want["measured_budget"], (n, t, got)
            assert got == fhetpu_row(pipeline, n, t, got["measured_budget"]), (n, t)
        measured = want["measured_budget"]
        assert nv.model_row(pipeline, n, t, measured) == fhetpu_row(pipeline, n, t, measured), \
            (n, t)
