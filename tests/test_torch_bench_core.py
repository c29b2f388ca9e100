"""``python -m fhetpu_torch.bench.core`` (the counterpart of
``scripts/bench_core.py``) on the CPU at a tiny size: every section of
fhetpu's bench_core.json with its fields (the NTT sweep's kernel column
only), ``--only`` merging into the file; and its refusal to run without a
card unless ``--device cpu`` is given."""

import json
import os

import pytest
import torch

from fhetpu_torch.bench import core, timing

torch.set_num_threads(2)

NTT_FIELDS = {"us_per_call", "ntts_per_s", "achieved_gb_per_s", "peak_gb_per_s", "k", "dt_s"}
TILE_FIELDS = {"ms_per_tile", "out_px", "interps_per_s", "ms_per_interp", "k", "dt_s"}


def test_bench_core_cpu_writes_every_section(tmp_path, monkeypatch, capsys):
    """n = 1024, batch 2, sweep batches 2 and 4, one sample per op, the
    resize tiles cut to 3x3 -> 2x2 and the harmonics to orders 4 and 8:
    every label and field of fhetpu's sections, numbers positive; the
    fields' arithmetic holds; a second run with --only refreshes one op
    and keeps the rest."""
    monkeypatch.setattr(timing, "TARGET_SECONDS", 0.01)
    monkeypatch.setattr(timing, "MIN_DT", 0.001)
    monkeypatch.setattr(core, "REPEATS", 1)
    monkeypatch.setattr(core, "RESIZE", tuple(r[:4] + (3, 2) for r in core.RESIZE))
    monkeypatch.setattr(core, "HARMONICS", ((4, 2), (8, 3)))
    out = tmp_path / "bench_core_torch.json"
    argv = ["--device", "cpu", "--n", "1024", "--batch", "2", "--sweep", "2,4", "--out", str(out)]
    assert core.main(argv) == 0
    res = json.loads(out.read_text())
    assert (res["n"], res["L"], res["batch"]) == (1024, 1, 2) and "CPU" in res["device"]
    assert set(res["ntt_sweep"]) == {"2", "4"}
    for B, row in res["ntt_sweep"].items():
        assert set(row) == {"kernel"}
        for col in row.values():
            assert set(col) == NTT_FIELDS and col["peak_gb_per_s"] is None
            assert col["ntts_per_s"] == pytest.approx(int(B) * 1e6 / col["us_per_call"])
    ops = res["ops"]
    assert set(ops) == {"ntt_fwd_kernel", "ntt_inv_kernel", "behz_multiply", "relinearize",
                        "linear_plainfract", "cubic_plainfract", "cubic_ctct_relin16",
                        "cubic_ctct_faithful", "harmonics_order4", "harmonics_order8"}
    assert set(ops["ntt_fwd_kernel"]) == set(ops["ntt_inv_kernel"]) == NTT_FIELDS
    assert set(ops["behz_multiply"]) == {"ms_per_batch", "ct_mults_per_s", "k", "dt_s"}
    assert set(ops["relinearize"]) == {"ms_per_batch", "relins_per_s", "dbc", "k", "dt_s"}
    for label, mode, *_ in core.RESIZE:
        tile = ops[label]
        assert set(tile) == TILE_FIELDS and tile["out_px"] == 4
        per = 20 if mode == core.rz.BICUBIC else 3
        assert tile["interps_per_s"] == pytest.approx(4 * per * 1e3 / tile["ms_per_tile"])
    for order, degree in core.HARMONICS:
        h = ops[f"harmonics_order{order}"]
        assert (h["degree"], h["positions"]) == (degree, order) and h["positions_per_s"] > 0
    assert all(v > 0 for op in ops.values() for k, v in op.items()
               if k.endswith("_s") and v is not None)
    first = ops["ntt_inv_kernel"]
    capsys.readouterr()
    assert core.main(argv + ["--only", "ntt_fwd"]) == 0
    merged = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == merged["ops"]
    assert set(merged["ops"]) == set(ops) and merged["ops"]["ntt_inv_kernel"] == first
    assert set(merged["ntt_sweep"]) == {"2", "4"}


def test_bench_core_refuses_without_cuda(tmp_path, monkeypatch):
    """With no card and no --device it exits at once, writing nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no CUDA device"):
        core.main([])
    assert os.listdir(tmp_path) == []
