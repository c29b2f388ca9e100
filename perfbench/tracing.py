"""torch.profiler over the traced window, reduced to what the per-layer
readers take: device busy time, idle gaps by what the host was doing, and
device time by operation.

A process that has worked before can lose the first device records of a
profiled window, so the profiler starts one warm-up step early (its
records are dropped), and the window fails unless the profiler saw every
launch that the program's own counters counted (``reduce``).
"""

from __future__ import annotations

import re
import sys
import time
from dataclasses import dataclass, field

WINDOW = "perfbench.window"
# kernel families in a trace by the names nvcc gives them, and the program's
# launch counters of each (module, function, attribute)
FAMILIES = {
    "ntt_forward": (r"ntt_kernel<(true|\(bool\)1)|ntt_kernelILb1",
                    ("fhetpu_torch.core.ntt_kernel", "ntt_forward", "launches")),
    "ntt_inverse": (r"ntt_kernel<(false|\(bool\)0)|ntt_kernelILb0",
                    ("fhetpu_torch.core.ntt_kernel", "ntt_inverse", "launches")),
    "server_ycc_dct": (r"server_ycc_dct_strict_kernel",
                       ("fhetpu_torch.core.server_kernel", "server_ycc_dct_fused", "launches")),
}
TOP = 10


def _counter(spec):
    import importlib

    module, fn, attr = spec
    return getattr(importlib.import_module(module), fn), attr


def reset_launches():
    for _, spec in FAMILIES.values():
        fn, attr = _counter(spec)
        setattr(fn, attr, 0)


def read_launches() -> dict:
    out = {}
    for name, (_, spec) in FAMILIES.items():
        fn, attr = _counter(spec)
        out[name] = getattr(fn, attr)
    return out


@dataclass
class Trace:
    """One traced window: seconds, the units it ran, and what the card did."""

    window_s: float
    units: int
    busy_s: float
    device_ops: list = field(default_factory=list)  # [(name, seconds)], longest first
    idle_gaps: list = field(default_factory=list)  # [(host activity, seconds)]
    launched: dict = field(default_factory=dict)
    seen: dict = field(default_factory=dict)


def traced_window(run_units, warm_units: int, units: int) -> tuple:
    """run_units(warm_units, False) under the profiler's warm-up step, then
    run_units(units, True) as the traced window; (Trace, what the window's
    run_units returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=lambda p: None)
    prof.start()
    try:
        run_units(warm_units, False)
        torch.cuda.synchronize()
        prof.step()
        reset_launches()
        with record_function(WINDOW):
            out = run_units(units, True)
            torch.cuda.synchronize()
        launched = read_launches()
        prof.step()
    finally:
        prof.stop()
    t0 = time.perf_counter()
    trace = reduce(prof.profiler.kineto_results.events(), units, launched)
    print(f"perfbench: trace reduced in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
          flush=True)
    return trace, out


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, units: int, launched: dict) -> Trace:
    """Kineto events of one window -> Trace; raises where the profiler saw
    no device time or missed a counted launch."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # the window's span on the host; the profiler mirrors spans on the device
    # as user annotations, which are no device work
    win = [e for e in events if e.name() == WINDOW and e.device_type() != cuda]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} '{WINDOW}' spans, not one")
    w0, w1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    thread = win[0].start_thread_id()  # host events of the harness's thread nest
    dev, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if s + d < w0 or s > w1:
            continue
        span = e.name() == WINDOW or e.name().startswith("ProfilerStep")
        if e.device_type() == cuda:
            if not span and not e.is_user_annotation():
                dev.append((max(s, w0), min(s + d, w1), e.name()))
        elif e.start_thread_id() == thread and not span:
            host.append((s, s + d, e.name()))
    seen = {k: sum(bool(re.search(pat, name)) for _, _, name in dev)
            for k, (pat, _) in FAMILIES.items()}
    if not dev:
        raise RuntimeError("torch.profiler saw no device time in the traced window")
    if seen != launched:
        raise RuntimeError(f"torch.profiler saw {seen} launches, the program counted "
                           f"{launched}: a blind reading")
    busy = _merge([(s, e) for s, e, _ in dev])
    by_op: dict = {}
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0) + (e - s)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return Trace(window_s=(w1 - w0) / 1e9, units=units,
                 busy_s=sum(e - s for s, e in busy) / 1e9,
                 device_ops=_top(by_op), idle_gaps=_top(_attribute(gaps, host)),
                 launched=launched, seen=seen)


def _attribute(gaps, host) -> dict:
    """Each idle gap's nanoseconds to the innermost host event open at its
    middle (host events nest), or to 'host_outside_the_spans'."""
    host.sort(key=lambda h: (h[0], -h[1]))
    out: dict = {}
    stack, k = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host_outside_the_spans"
        out[name] = out.get(name, 0) + (g1 - g0)
    return out


def _top(ns_by_name: dict) -> list:
    ranked = sorted(ns_by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:96], ns / 1e9] for name, ns in ranked]
