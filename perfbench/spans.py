"""The program's own spans in a traced window: device time and idle time by
the span of the program that caused them, and the NTT kernels' polynomials.

The program opens its spans (``fhetpu_torch/trace.py``) only while a
profiler records, so they share the device trace's clock.  A device op
belongs to the innermost program span open on the harness's thread when the
host launched it: its ``correlation_id`` is that of the CUDA API call
that launched it (a torch op's id may be the same number, so only calls
named ``cu...`` count).  The card runs behind the host, so a
kernel often runs after its span has closed, and device time is never
matched to spans by overlap.  An idle gap belongs to the innermost program
span open at its middle, or to ``outside_the_program``.

The harness keeps no kineto events after its traced window, so the readers
below trace a window of their own in the same process, after the harness's:
the cell built anew (the harness has released its own), warmed, and traced
as ``tracing.traced_window`` traces it, with the same units and the same
check that the profiler saw every launch the program counted.  A program
without these spans or counters (an older one) is not traced again, and
the readers return None.
"""

from __future__ import annotations

import gc
import importlib.util
import re
import sys
import time

from perfbench import roofline, tracing

# the program's spans, by the names its trace module gives them
SPANS = (
    "pipelines.resize.resize_tile",
    "pipelines.resize.gather",
    "bfv.evaluator.transform",
    "bfv.evaluator.multiply_plain",
    "bfv.evaluator.linear",
    "bfv.evaluator.multiply",
    "bfv.rns.extend",
    "bfv.rns.tensor",
    "bfv.rns.scale_floor",
    "bfv.rns.convert",
)
OUTSIDE = "outside_the_program"
UNLINKED = "no_launch_event"  # a device op whose launching call the trace lacks
LAUNCH = re.compile(r"^cu(da)?[A-Z]")  # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...
NTT = tuple(tracing.FAMILIES[k][0] for k in ("ntt_forward", "ntt_inverse"))
# the NTT wrappers' counters of (polynomial, limb) pairs transformed
POLYS = {"ntt_forward": ("fhetpu_torch.core.ntt_kernel", "ntt_forward", "polys"),
         "ntt_inverse": ("fhetpu_torch.core.ntt_kernel", "ntt_inverse", "polys")}


def reset():
    """Zero the polynomial counters where the program has them."""
    for spec in POLYS.values():
        fn, attr = tracing._counter(spec)
        if hasattr(fn, attr):
            setattr(fn, attr, 0)


def read():
    """{kernel: polynomials} since ``reset``, or None where the program
    does not count them."""
    out = {}
    for name, spec in POLYS.items():
        fn, attr = tracing._counter(spec)
        if not hasattr(fn, attr):
            return None
        out[name] = getattr(fn, attr)
    return out


def _open_at(spans, times) -> list:
    """For each time, the names of the spans open then, outermost first;
    ``spans`` are (start, end, name) that nest, as spans of one thread do."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out = [()] * len(times)
    stack, k = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack)
    return out


def _add(table: dict, key: str, family: str, ns: int):
    row = table.setdefault(key, {"ntt": 0.0, "other": 0.0})
    row[family] += ns / 1e9


def reduce(events, w0: int, w1: int, thread) -> dict:
    """Kineto events of one window [w0, w1] (ns), whose harness ran on
    ``thread``, to the program's spans:

    - ``device_s``: {span: {"ntt": s, "other": s}}, each device op under the
      innermost program span open at its launch, ``outside_the_program``
      where none was, ``no_launch_event`` where the trace lacks its launch;
    - ``inclusive_s``: the same with each op also under every enclosing span;
    - ``idle_s``: {span: s} of the window's idle gaps;
    - ``attributed``: the share of device time under some program span;
    - ``count``, ``host_s``: each span's number and host seconds;
    - ``ntt_device_s``: the NTT kernels' device seconds in the window.
    """
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, launched_at, dev = [], {}, []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if s + d < w0 or s > w1:
            continue
        name = e.name()
        if e.device_type() == cuda:
            if (not e.is_user_annotation() and name != tracing.WINDOW
                    and not name.startswith("ProfilerStep")):
                family = "ntt" if any(re.search(p, name) for p in NTT) else "other"
                dev.append((max(s, w0), min(s + d, w1), family, e.correlation_id()))
        elif name in SPANS:
            if e.start_thread_id() == thread:
                spans.append((s, s + d, name))
        elif LAUNCH.match(name) and e.correlation_id():
            launched_at[e.correlation_id()] = s
    count, host_s = {}, {}
    for s, e, name in spans:
        count[name] = count.get(name, 0) + 1
        host_s[name] = host_s.get(name, 0.0) + (e - s) / 1e9
    linked = [op for op in dev if op[3] in launched_at]
    device_s, inclusive_s = {}, {}
    for (s, e, family, _), stack in zip(linked, _open_at(spans, [launched_at[op[3]]
                                                                  for op in linked])):
        _add(device_s, stack[-1] if stack else OUTSIDE, family, e - s)
        for span in set(stack):
            _add(inclusive_s, span, family, e - s)
    for s, e, family, corr in dev:
        if corr not in launched_at:
            _add(device_s, UNLINKED, family, e - s)
    total = sum(e - s for s, e, _, _ in dev) / 1e9
    attributed = sum(v["ntt"] + v["other"] for k, v in device_s.items()
                     if k not in (OUTSIDE, UNLINKED))
    gaps, prev = [], w0
    for s, e in tracing._merge([(s, e) for s, e, _, _ in dev]):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    idle_s = {}
    for (g0, g1), stack in zip(gaps, _open_at(spans, [(g0 + g1) // 2 for g0, g1 in gaps])):
        key = stack[-1] if stack else OUTSIDE
        idle_s[key] = idle_s.get(key, 0.0) + (g1 - g0) / 1e9
    out = {"device_s": device_s, "inclusive_s": inclusive_s, "idle_s": idle_s,
           "attributed": attributed / total if total else 0.0, "count": count,
           "host_s": host_s,
           "ntt_device_s": sum(e - s for s, e, f, _ in dev if f == "ntt") / 1e9}
    print(f"perfbench: device s by program span {_fmt(device_s)}; idle s by program span "
          f"{_fmt(idle_s)}; {100.0 * out['attributed']:.4f} % of device time under a "
          f"program span; spans {count}, host s {_fmt(host_s)}", file=sys.stderr, flush=True)
    return out


def _fmt(table: dict) -> dict:
    return {k: ({f: round(s, 6) for f, s in v.items()} if isinstance(v, dict) else round(v, 6))
            for k, v in sorted(table.items())}


# ---------------------------------------------------------------------------
# what the metric readers under metrics/ take
# ---------------------------------------------------------------------------


def _has_spans() -> bool:
    """Whether the program opens these spans and counts the polynomials."""
    try:
        return importlib.util.find_spec("fhetpu_torch.trace") is not None and read() is not None
    except ImportError:
        return False


def _bounds(events) -> tuple:
    """The window's (start ns, end ns, harness thread), as ``tracing.reduce``
    finds them."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == tracing.WINDOW and e.device_type() != cuda]
    w = win[0]
    return w.start_ns(), w.start_ns() + w.duration_ns(), w.start_thread_id()


def window(run):
    """The cell built anew from the run's context and traced: ``reduce``'s
    tables with ``polys``, ``units`` and ``window_s``; None where the
    profiler missed a launch the program counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    t0 = time.perf_counter()
    ctx = run.cell.ctx
    tr = ctx.traffic
    cell = type(run.cell)(ctx)

    def run_units(k):
        for i in range(k):
            cell.unit(i, False)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=lambda p: None)
    try:
        run_units(tr["warmup_units"])
        torch.cuda.synchronize()
        gc.collect()
        gc.disable()
        prof.start()
        try:
            run_units(tr["trace_warm_units"])
            torch.cuda.synchronize()
            prof.step()
            tracing.reset_launches()
            reset()
            with record_function(tracing.WINDOW):
                run_units(tr["trace_units"])
                torch.cuda.synchronize()
            launched, polys = tracing.read_launches(), read()
            prof.step()
        finally:
            prof.stop()
            gc.enable()
    finally:
        cell.release()
        torch.cuda.empty_cache()
    events = prof.profiler.kineto_results.events()
    try:
        whole = tracing.reduce(events, tr["trace_units"], launched)
    except RuntimeError as e:
        print(f"perfbench: the spans' window is not read: {e}", file=sys.stderr, flush=True)
        return None
    out = reduce(events, *_bounds(events))
    out.update(polys=polys, units=whole.units, window_s=whole.window_s)
    print(f"perfbench: the spans' window, {whole.units} units in {whole.window_s:.4f} s, "
          f"busy {whole.busy_s:.4f} s; built, run and reduced in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


def _spans(run):
    """The spans' window of this run, traced once and kept on ``run``;
    None in an untraced run or with an older program."""
    if not hasattr(run, "program_spans"):
        run.program_spans = (window(run) if run.trace is not None and _has_spans()
                             else None)
    return run.program_spans


def behz_ms(run):
    """Device ms per unit of the non-NTT kernels launched under
    ``bfv.evaluator.multiply`` (BEHZ with its children)."""
    sp = _spans(run)
    if not sp or not sp["count"].get("bfv.evaluator.multiply") or sp["units"] <= 0:
        return None
    return 1e3 * sp["inclusive_s"]["bfv.evaluator.multiply"]["other"] / sp["units"]


def ntt_least_s(polys: dict, n: int, sms: int, clock_hz: float) -> float:
    """The NTT launches' least time: each residue read and written once
    (twiddle tables left out), against the fewest operations of each
    transform (``roofline``)."""
    pf, pi = polys["ntt_forward"], polys["ntt_inverse"]
    ops = roofline.ntt_ops("ntt_forward", pf, n) + roofline.ntt_ops("ntt_inverse", pi, n)
    return roofline.bound_s(8 * n * (pf + pi), ops, sms, clock_hz)


def ntt_roofline(run):
    """The NTT launches' least time over the NTT kernels' device time, in %."""
    sp = _spans(run)
    ctx = run.cell.ctx
    if not sp or not sp.get("polys") or sp["ntt_device_s"] <= 0 or not ctx.sms \
            or not ctx.clock_hz:
        return None
    least = ntt_least_s(sp["polys"], ctx.config["n"], ctx.sms, ctx.clock_hz)
    return 100.0 * least / sp["ntt_device_s"]


def idle_pct(run, span: str):
    """The window's idle seconds under ``span`` over the window, in %."""
    sp = _spans(run)
    if not sp or not sp["count"].get(span) or sp["window_s"] <= 0:
        return None
    return 100.0 * sp["idle_s"].get(span, 0.0) / sp["window_s"]
