"""The decode cell's program spans and counters in a traced window.

As ``spans.window`` does for the resize, the readers below trace a window
of their own after the harness's: the cell built anew, warmed, and traced
with the same units and the same check that the profiler saw every launch
the program counted.  Device ops go to the spans open at their launch
(``spans.reduce``, here over ``SPANS``: ``spans.SPANS`` and the decode
spans).  The window also resets and reads the expansion's own counters,
``calls`` and ``products``, and the NTT wrappers' ``polys``.

The window's span starts ``MARGIN_S`` before the first unit and ends
``MARGIN_S`` after the card drains: in a process's second profiled window
the profiler has placed device ops milliseconds after the host's span
(2.7 ms on an H100), which dropped the last inverse NTT and failed the
launch check.  The readers take no idle time from this window.

A program without the decode spans or counters (an older one) is not
traced again, and the readers return None.
"""

from __future__ import annotations

import gc
import sys
import time

from perfbench import spans, tracing

EXPAND = "pipelines.rle_decode.expand"
TABLES = "pipelines.rle_decode.weight_tables"
SPANS = spans.SPANS + (EXPAND, TABLES)
COUNTERS = ("calls", "products")  # attributes of rle_decode.expand_harmonics_batched
MARGIN_S = 0.05


def _counted():
    """``rle_decode.expand_harmonics_batched``, or None where the program
    does not count its calls and products."""
    from fhetpu_torch.pipelines import rle_decode

    fn = rle_decode.expand_harmonics_batched
    return fn if all(hasattr(fn, c) for c in COUNTERS) else None


def _reduce(events, w0: int, w1: int, thread) -> dict:
    """``spans.reduce`` over this module's ``SPANS``."""
    saved = spans.SPANS
    spans.SPANS = SPANS
    try:
        return spans.reduce(events, w0, w1, thread)
    finally:
        spans.SPANS = saved


def window(run):
    """The cell built anew from the run's context and traced: ``spans.reduce``'s
    tables with ``polys`` and the expansion's ``calls`` and ``products``;
    None in an untraced run, with an older program, or where the profiler
    missed a launch the program counted."""
    fn = _counted()
    if run.trace is None or fn is None:
        return None
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
            spans.reset()
            for c in COUNTERS:
                setattr(fn, c, 0)
            with record_function(tracing.WINDOW):
                time.sleep(MARGIN_S)
                run_units(tr["trace_units"])
                torch.cuda.synchronize()
                time.sleep(MARGIN_S)
            launched, polys = tracing.read_launches(), spans.read()
            counted = {c: getattr(fn, c) for c in COUNTERS}
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
        print(f"perfbench: the decode spans' window is not read: {e}", file=sys.stderr,
              flush=True)
        return None
    out = _reduce(events, *spans._bounds(events))
    out.update(polys=polys, **counted)
    print(f"perfbench: the decode spans' window, {whole.units} units in "
          f"{whole.window_s:.4f} s, busy {whole.busy_s:.4f} s, counted {counted}, "
          f"polys {polys}; built, run and reduced in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return out


def _window(run):
    """The decode spans' window of this run, traced once and kept on ``run``."""
    if not hasattr(run, "decode_spans"):
        run.decode_spans = window(run)
    return run.decode_spans


def expand_ms(run):
    """Device ms of the kernels launched under the expansion's span (its
    harmonics' transform, products, sums and reduction) per counted call,
    so per channel."""
    sp = _window(run)
    if not sp or not sp["calls"] or EXPAND not in sp["inclusive_s"]:
        return None
    dev = sp["inclusive_s"][EXPAND]
    return 1e3 * (dev["ntt"] + dev["other"]) / sp["calls"]


def ntt_roofline(run):
    """The NTT launches' least time over the NTT kernels' device time in
    the decode spans' window, in %."""
    sp = _window(run)
    if not sp or not sp["polys"] or sp["ntt_device_s"] <= 0:
        return None
    ctx = run.cell.ctx
    if not ctx.sms or not ctx.clock_hz:
        return None
    least = spans.ntt_least_s(sp["polys"], ctx.config["n"], ctx.sms, ctx.clock_hz)
    return 100.0 * least / sp["ntt_device_s"]
