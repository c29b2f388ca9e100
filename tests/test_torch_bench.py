"""fhetpu_torch.bench on the CPU: the log parsers against fhetpu's, the
timing primitive, the headline's output line, one reference-grid config
against the port's CLIs run directly, and the PIL-free JPEG decoder that
gives that config its RMS against PIL's decoder.  Inputs come from
np.random.default_rng; every comparison is exact."""

import json
import os

import numpy as np
import pytest
import torch

from fhetpu.bench import analyze as f_analyze
from fhetpu.bench import results_parser as f_results

from fhetpu_torch.bench import (analyze, benchmark, decode_sweep, headline,
                                noise_validation, results_parser, timing)
from fhetpu_torch.cli import client_jpeg, server_jpeg
from fhetpu_torch.codec import jpeg as jpeg_codec
from fhetpu_torch.codec.jpeg_decode import decode_baseline
from fhetpu_torch.io import images

torch.set_num_threads(2)

N, T = 2048, 1 << 14


def test_parsers_equal_fhetpu(tmp_path):
    """parse_log, parse_results and average_over_pmod read the same dicts
    as fhetpu's from the same logs: every label, empty and malformed
    fields, lines of other stages, two plain moduli to average over."""
    rng = np.random.default_rng(7)
    log = tmp_path / "jpg_rand48_2048_11_30.txt"
    rows = []
    for label in analyze.LABELS + ("Other",):
        vals = ",".join(f"{v:.6g}" for v in rng.random(3) * 100)
        rows.append(f"{label},{vals},")
    rows += ["$ python -m x", "DCT,abc,,1.5,", "garbage line", "Linear,"]
    log.write_text("\n".join(rows) + "\n")
    assert analyze.LABELS == f_analyze.LABELS
    assert dict(analyze.parse_log(str(log))) == dict(f_analyze.parse_log(str(log)))

    res = tmp_path / "results.txt"
    lines = []
    for kind, n, pmod in (("jpg", 2048, 11), ("jpg", 2048, 31), ("bilinear", 4096, 11)):
        lines.append(f"{kind}_boaz48_{n}_{pmod}_30")
        for label in ("DCT", "RMSError"):
            lines.append(f"  {label},{rng.random() * 10:.6g},{rng.random():.6g}")
    res.write_text("\n".join(lines) + "\n")
    got = results_parser.parse_results(str(res))
    assert got == f_results.parse_results(str(res)) and len(got) == 3
    assert (results_parser.average_over_pmod(got) == f_results.average_over_pmod(got))


def test_measure_cpu_chain():
    """On the CPU, measure chains x = fn(x) k times in one window of at
    least MIN_DT and returns a positive per-iteration time from it."""
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 3 + 1) % 1000003

    sec, k, dt = timing.measure(fn, torch.arange(1 << 16, dtype=torch.int64), "cpu", "cpu",
                                target_seconds=0.06, verbose=False)
    assert sec > 0 and k >= 1 and dt >= timing.MIN_DT
    assert sec == pytest.approx(dt / k) and len(calls) >= k


def test_measure_refuses_a_short_window(monkeypatch):
    """A window that stays under MIN_DT after every retry raises instead of
    returning a number."""
    monkeypatch.setattr(timing, "MIN_DT", 3600.0)
    with pytest.raises(RuntimeError, match="could not obtain a measurable window"):
        timing.measure(lambda x: x + 1, torch.zeros(4), "tiny", "cpu",
                       target_seconds=1e-6, verbose=False)


def test_headline_cpu_prints_one_json_line(tmp_path, monkeypatch, capsys):
    """--device cpu at n=2048, nb=1: one JSON line with the four keys,
    naming the CPU, and a sidecar with every variant's samples."""
    monkeypatch.setattr(timing, "TARGET_SECONDS", 0.02)
    monkeypatch.setattr(timing, "MIN_DT", 0.01)
    details = tmp_path / "details.json"
    assert headline.main(["--device", "cpu", "--ns", str(N), "--blocks", "1",
                          "--details", str(details)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert "CPU" in line["metric"] and line["value"] > 0 and line["unit"] == "channel-blocks/s"
    row = json.loads(details.read_text())["per_n"][str(N)]
    assert row["nb"] == 1 and set(row["variants"]) == {v for v, _, _ in headline.VARIANTS}
    assert all(len(v["ms_per_op_samples"]) == 3 for v in row["variants"].values())
    assert line["vs_baseline"] == round(row["vs_baseline"], 2)
    for v in row["variants"].values():  # SEAL's ms per channel-block over ours
        assert v["vs_baseline"] == pytest.approx(
            v["channel_blocks_per_s"] * headline.BASELINE_DCT_MS[N] / 1000)


def test_entry_points_refuse_without_cuda(tmp_path, monkeypatch):
    """Without a card and without --device cpu, every entry point that
    drives the card exits at once, before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for main, argv in ((headline.main, []),
                       (noise_validation.main, ["--from-artifact", "missing.json"]),
                       (benchmark.main, ["--quick"]), (decode_sweep.main, ["--quick"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
    assert os.listdir(tmp_path) == []


def test_jpeg_decoder_equals_pil():
    """decode_baseline gives PIL's pixels for the client's two JFIF files:
    the jo_jpeg baseline and the all-ones-quantized result, on working
    coefficients and on garbage ones outside the IDCT's range."""
    rng = np.random.default_rng(11)
    for h, w in ((8, 8), (16, 24), (48, 48)):
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        jo = jpeg_codec.jo_jpeg_encode(img, quality=0)
        assert np.array_equal(decode_baseline(jo), images.decode_jpeg_bytes(jo))
        nb = (h // 8) * (w // 8)
        vals = rng.normal(0, 60, size=(nb, 3, 64))
        vals[:, :, 0] = rng.uniform(-1000, 1000, size=(nb, 3))
        garbage = rng.uniform(-1023, 1023, size=(nb, 3, 64))  # what the codes allow
        garbage[:, :, 0] = vals[:, :, 0]
        for blocks in (vals, garbage):
            ours = client_jpeg.result_jpeg(blocks, w, h)
            assert np.array_equal(decode_baseline(ours), images.decode_jpeg_bytes(ours))


def test_benchmark_jpg_config_equals_cli(tmp_path, capsys):
    """One grid config (jpg, n=2048, t=2^14, an 8x8 image, --device cpu)
    logs DCT/Encryption/Decryption/RMSError rows and aggregates to a
    one-row grid_results.json whose RMS is the one the port's CLIs print
    for the same image and keydir."""
    img = np.random.default_rng(5).integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    logdir, work = tmp_path / "logs", tmp_path / "work"
    logdir.mkdir()
    work.mkdir()
    rc, log = benchmark.call_pipeline("jpg", N, T, str(logdir), str(work), "cpu", img)
    assert rc == 0, open(log).read()
    assert os.path.basename(log) == f"jpg_rand8_{N}_{T}_{benchmark.DBC}.txt"
    stats = analyze.parse_log(log)
    assert {"DCT", "Encryption", "Decryption", "RMSError"} <= set(stats)
    rows = benchmark.aggregate(str(logdir), str(logdir))
    assert len(rows) == 1 and rows[0]["n"] == N and rows[0]["pmod"] == T
    assert json.loads((logdir / "grid_results.json").read_text()) == rows

    png, keydir = str(tmp_path / "in.png"), str(work / "keys")
    images.save_rgb(png, img)
    common = ["--cmod", str(N), "--pmod", str(T), "--keydir", keydir]
    c2s, s2c = str(tmp_path / "c2s.bin"), str(tmp_path / "s2c.bin")
    capsys.readouterr()
    client_jpeg.main(["--send", "-f", png, "-c", c2s] + common)
    server_jpeg.main(["-i", c2s, "-c", s2c, "--keydir", keydir, "--device", "cpu"])
    capsys.readouterr()
    client_jpeg.main(["--recieve", "-f", png, "-i", s2c, "-o", str(tmp_path / "o.jpg"),
                      "--keydir", keydir])
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RMSError,")]
    assert len(printed) == 1
    logged = [ln for ln in open(log).read().splitlines() if ln.startswith("RMSError,")]
    assert logged == printed
    assert rows[0]["rms"] == round(float(printed[0].split(",")[1]), 4)
