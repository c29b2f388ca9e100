#!/usr/bin/env python3
"""Where torch.profiler stops seeing the card's kernels in one long-lived
process, as chip_smoke.py's main process is, and whether padding the
profiled window with host time repairs it.

    python3 scripts/torch_profiler_probe.py
    python3 scripts/torch_profiler_probe.py --soak SECONDS

A probe profiles PROBE_REPS forward NTT launches at n = 4096, L = 4,
B = 16, each inside a record_function annotation, twice: in a bare window,
then in one with PAD_S of sleep on both sides.  It prints

    probe <step>: bare window k of 20, padded window m of 20 (first / last
    kernel less first / last annotation: bare f / l ms, padded f / l ms)

f and l are about 0.01-3 ms (the first launch under the profiler is slow)
and 0.03 ms when every launch is seen; a large f with a small l means the
first kernels of the window were missed.

Without arguments: chip_smoke.py's phases 1-10 in this one process, in the
script's order, with a probe before the first and after each phase and
around each subprocess a phase starts; a check of chip_smoke that fails is
printed and the run goes on; last, phase 9c runs in this process (chip_smoke
runs it in a fresh one).  With --soak: a fresh process probed while idle,
every SOAK_STEP_S for SECONDS, then after large pageable copies, after
phase 4a-c, and in a newly spawned process.  The card's name and power
limit come first.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402

PROBE_REPS = 20
PROBE_B = 16
PAD_S = 0.2  # host time in the padded window before and after the launches


def make_probe(dev, scratch: str):
    import torch
    from fhetpu_torch.bfv.params import BfvParams
    from fhetpu_torch.core import ntt_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED + 11)
    tables = BfvParams.create(n=smoke.TIMING_N).tables_q
    dt = ntt_kernel.device_tables(tables, dev)
    x = smoke.rand_residues((PROBE_B,), tables.primes, tables.n, gen, dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    seen = []

    def launches():
        for i in range(PROBE_REPS):
            with torch.profiler.record_function(f"probe ntt {i}"):
                ntt_kernel.ntt_forward(x, dt)

    def read(prof):
        """(NTT kernels seen, "first / last" gaps: the first seen kernel's
        timestamp less the first annotation's, the last's less the last's,
        in ms; about +0.01 each when no launch was missed)."""
        path = os.path.join(scratch, "probe.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kern = sorted(e["ts"] for e in events if e.get("cat") == "kernel"
                      and "ntt_kernel" in e.get("name", ""))
        note = sorted(e["ts"] for e in events if e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith("probe ntt"))
        if not (kern and note):
            return len(kern), "not measured"
        return len(kern), f"{(kern[0] - note[0]) / 1e3:.3f} / {(kern[-1] - note[-1]) / 1e3:.3f} ms"

    def probe(step: str):
        ntt_kernel.ntt_forward(x, dt)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            launches()
            torch.cuda.synchronize()
        bare, bare_lag = read(prof)
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(PAD_S)
            launches()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
        padded, lag = read(prof)
        seen.append((step, bare, padded))
        print(f"probe {step}: bare window {bare} of {PROBE_REPS}, padded window {padded} of "
              f"{PROBE_REPS} (first / last kernel less first / last annotation: bare "
              f"{bare_lag}, padded {lag})", flush=True)

    return probe, seen


SOAK_STEP_S = 15
COPY_BYTES = 1 << 30


def fresh_probe(scratch: str):
    """One probe in a newly spawned process (the caller's process is old)."""
    import torch

    probe, _ = make_probe(torch.device("cuda:0"), scratch)
    probe("in a fresh spawned process")


def soak(dev, seconds: float, work: str):
    """Whether time alone, large pageable copies or phase 4a-c's work make
    the profiler miss launches: probes in an idle fresh process every
    SOAK_STEP_S for ``seconds``, then after 8 copies of COPY_BYTES each way
    between pageable host memory and the card, then after phase 4a-c, then
    in a newly spawned process."""
    import concurrent.futures
    import multiprocessing

    import torch

    probe, _ = make_probe(dev, work)
    t0 = time.perf_counter()
    probe("idle, 0 s")
    while time.perf_counter() - t0 < seconds:
        time.sleep(SOAK_STEP_S)
        probe(f"idle, {time.perf_counter() - t0:.0f} s")
    host = torch.ones(COPY_BYTES, dtype=torch.uint8)
    for _ in range(8):
        host.copy_(host.to(dev).cpu())
    torch.cuda.synchronize()
    del host
    probe(f"after 8 pageable copies of {COPY_BYTES >> 20} MiB each way")
    t1 = time.perf_counter()
    smoke.phase_main_paths(dev, work)
    print(f"step phase 4a-c: {time.perf_counter() - t1:.1f} s", flush=True)
    probe("after phase 4a-c")
    probe("again after phase 4a-c")
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        pool.submit(fresh_probe, work).result()
    probe("after the spawned process")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from fhetpu_torch.core import build

    dev = torch.device("cuda:0")
    build.lib()
    card = smoke.smi("name,power.limit")
    print(card, flush=True)
    if len(sys.argv) == 3 and sys.argv[1] == "--soak":
        with tempfile.TemporaryDirectory() as work:
            soak(dev, float(sys.argv[2]), work)
        return 0
    run_module, check_seen = smoke._run_module, smoke._check_seen

    def probed_run_module(args, cwd, timeout, stdin=None):
        probe(f"before subprocess {args[0]}")
        run_module(args, cwd, timeout, stdin)
        probe(f"after subprocess {args[0]}")

    def logged_check_seen(prof, launched, what):
        try:
            return check_seen(prof, launched, what)
        except RuntimeError as e:
            print(f"probe: chip_smoke's check failed: {e}", flush=True)
            return 1, 1.0

    smoke._run_module = probed_run_module
    smoke._check_seen = logged_check_seen
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    errs = {name: 0 for name in smoke.KERNELS}
    with tempfile.TemporaryDirectory() as work:
        probe, seen = make_probe(dev, work)
        probe("before phase 2")
        steps = (("phase 2", lambda: smoke.phase_ntt(dev, gen, errs)),
                 ("phase 3", lambda: smoke.phase_server(dev, gen, errs)),
                 ("phase 4a-c", lambda: smoke.phase_main_paths(dev, work)),
                 ("phase 4d-h", lambda: smoke.phase_resize_paths(dev)),
                 ("phase 4i-k", lambda: smoke.phase_decode_paths(dev, work)),
                 ("phase 5 kernels", lambda: smoke.phase_timing(dev, gen, errs, card)),
                 ("phase 5 resize", lambda: smoke.phase_resize_timing(dev, gen, card)),
                 ("phase 5 decode", lambda: smoke.phase_decode_timing(dev, card)),
                 ("phase 6", smoke.phase_bench),
                 ("phase 7", lambda: smoke.phase_sharded(dev, card)),
                 ("phase 8", lambda: smoke.phase_native_fast(dev, gen, errs, card)),
                 ("phase 9", lambda: smoke.phase_last_helpers(dev, gen, errs, card)),
                 ("phase 10", lambda: smoke.phase_pipes(work)),
                 ("phase 9c in this process",
                  lambda: print("\n".join(smoke.ntt_small_batch_times(dev, card)), flush=True)))
        for step, run in steps:
            t0 = time.perf_counter()
            try:
                run()
            except RuntimeError as e:
                print(f"step {step} failed: {e}", flush=True)
            print(f"step {step}: {time.perf_counter() - t0:.1f} s", flush=True)
            probe(f"after {step}")
    for i, kind in ((1, "bare"), (2, "padded")):
        short = next((r[0] for r in seen if r[i] < PROBE_REPS), None)
        print(f"first {kind} probe short of {PROBE_REPS}: {short}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
