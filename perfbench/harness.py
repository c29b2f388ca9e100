"""One run of one cell: set-up, warm-up, the measured window (or, with
trace, the traced window), the comparison with the plain reference, and the
result line.

Everything that belongs to one cell is data found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic file under
``traffic/`` (whose ``kind`` names a module under ``kinds/``), and one
reader per metric under ``metrics/``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "fhetpu")
SMI_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def log(msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """perfbench/<kind>/<name>.py, by file (metric names hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_age_s() -> float:
    """Seconds since this process started (/proc/self/stat's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def smi() -> dict:
    """The card's name, power limit, clocks, power draw and temperature, or
    {} where nvidia-smi cannot be read."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    return dict(zip(SMI_FIELDS.split(","), (v.strip() for v in r.stdout.split(","))))


def leftover_modules() -> list:
    """Top-level names of loaded modules that the port's benchmark must not
    load, compared whole (``fhetpu_torch`` is not ``fhetpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _merge(base: dict, over: dict) -> dict:
    return {**base, **(over or {})}


class Ctx:
    """What a kind's cell gets: the cell's data, the seed's generators, the
    device and the card's facts."""

    def __init__(self, workload, seed, device, config, traffic, sampled):
        import torch

        self.workload, self.seed = workload, seed
        self.device = torch.device(device)
        self.config, self.traffic, self.sampled = config, traffic, sampled
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.rng = np.random.default_rng(seed)
        self.cuda = self.device.type == "cuda"
        self.sms = self.clock_hz = None
        if self.cuda:
            self.sms = torch.cuda.get_device_properties(self.device).multi_processor_count
            card = smi()
            self.clock_hz = float(card["clocks.max.sm"]) * 1e6 if card else None

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.device)


def _warm(cell, ctx):
    tr, t0, i = ctx.traffic, time.perf_counter(), 0
    while i < tr["warmup_units"] or time.perf_counter() - t0 < tr["warmup_s"]:
        cell.unit(i, False)
        i += 1
    ctx.sync()
    log(f"warm-up: {i} units in {time.perf_counter() - t0:.2f} s")


def _window(cell, ctx, seconds: float) -> tuple:
    """Units until ``seconds`` have passed, then the card drained: (units,
    seconds from the first unit to the drain, the sampled outputs)."""
    kept, i = {}, 0
    t0 = time.perf_counter()
    while True:
        keep = i in ctx.sampled
        out = cell.unit(i, keep)
        if keep:
            kept[i] = out
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    ctx.sync()
    return i, time.perf_counter() - t0, kept


def cell_data(workload: str, overrides: dict = None) -> tuple:
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic),
    the last two with ``overrides`` ({"config": {...}, "traffic": {...}})
    merged in."""
    overrides = overrides or {}
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _merge(load_json(os.path.join(ROOT, cfg_entry["file"])), overrides.get("config"))
    traffic = _merge(load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
                     overrides.get("traffic"))
    return bench, w, config, traffic


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: dict = None) -> dict:
    """One run of the cell ``workload``; the result line as a dict.
    ``overrides`` ({"config": {...}, "traffic": {...}}) shrink a cell for a
    dry run on the CPU."""
    import torch

    bench, w, config, traffic = cell_data(workload, overrides)
    sampled = set(random.Random(seed).sample(range(traffic["sample_within"]),
                                             traffic["samples"]))
    ctx = Ctx(workload, seed, device, config, traffic, sampled)
    cell = load_module("kinds", traffic["kind"]).Cell(ctx)
    _warm(cell, ctx)
    before = smi()
    log(f"before the window: {before or 'nvidia-smi not read'}")
    gc.collect()
    gc.freeze()
    gc.disable()
    setup_s = process_age_s()
    try:
        if trace:
            from . import tracing

            def run_units(k, keep):
                kept = {}
                for i in range(k):
                    out = cell.unit(i, keep and i in sampled)
                    if keep and i in sampled:
                        kept[i] = out
                return kept

            tr, kept = tracing.traced_window(run_units, traffic["trace_warm_units"],
                                             traffic["trace_units"])
            units, window_s = tr.units, tr.window_s
        else:
            tr = None
            units, window_s, kept = _window(cell, ctx, seconds)
    finally:
        gc.enable()
        gc.unfreeze()
    log(f"after the window: {smi() or 'nvidia-smi not read'}")
    log(f"window: {units} units in {window_s:.4f} s; set-up {setup_s:.3f} s")
    peak = int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.cuda else 0
    cell.release()
    if ctx.cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    compared, failed = cell.check(kept)
    missing = sorted(sampled - set(kept))
    log(f"comparison with the reference: {time.perf_counter() - t0:.2f} s; sampled units "
        f"{sorted(sampled)}, never produced {missing}")
    correct = not missing and all(v <= lim for _, v, lim in compared)
    summary = SimpleNamespace(units=units, window_s=window_s, setup_s=setup_s,
                              work=cell.work, trace=tr, cell=cell)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if _applies(m, workload):
            value = load_module("metrics", m["name"]).read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    card = torch.cuda.get_device_name(ctx.device) if ctx.cuda else "cpu"
    dev = {"platform": "gpu" if ctx.cuda else "cpu", "kind": card, "count": w["chips"],
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": units, "failed": failed + len(missing),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
        log(f"profiler saw {tr.seen}, the program counted {tr.launched}")
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in compared}
    return result
