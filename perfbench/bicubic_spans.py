"""The bicubic resize cell's program spans and counters in a traced window.

As ``decode_spans.py`` does for the decode, the readers below trace a
window of their own after the harness's: the cell built anew, warmed, and
traced with the same units and the same check that the profiler saw every
launch the program counted.  Device ops go to the spans open at their
launch (``spans.reduce``, here over ``SPANS``: ``spans.SPANS`` and the
Catmull-Rom step's span).  The window also resets and reads the BEHZ
product's own counters (``rns.multiply``'s ``calls``, ``positions_in`` and
``positions_out``) and the NTT wrappers' ``polys``.  It keeps
``decode_spans.MARGIN_S`` on both edges, for the same reason.

A program without the product's counters (an older one) is not traced
again, and the readers return None.
"""

from __future__ import annotations

import gc
import sys
import time

from perfbench import decode_spans, roofline, spans, tracing

CUBIC = "pipelines.resize.cubic_interp"
MULTIPLY = "bfv.evaluator.multiply"
TENSOR = "bfv.rns.tensor"
SPANS = spans.SPANS + (CUBIC,)
COUNTERS = ("calls", "positions_in", "positions_out")  # attributes of rns.multiply
RESIDUE_BYTES = 4


def _counted():
    """``rns.multiply``, or None where the program does not count its
    products' positions."""
    from fhetpu_torch.bfv import rns

    fn = rns.multiply
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
    tables with ``polys``, ``units`` and the product's counters; None in an
    untraced run, with an older program, or where the profiler missed a
    launch the program counted."""
    if run.trace is None:
        return None
    fn = _counted()
    if fn is None:
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
                time.sleep(decode_spans.MARGIN_S)
                run_units(tr["trace_units"])
                torch.cuda.synchronize()
                time.sleep(decode_spans.MARGIN_S)
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
        print(f"perfbench: the bicubic spans' window is not read: {e}", file=sys.stderr,
              flush=True)
        return None
    out = _reduce(events, *spans._bounds(events))
    out.update(polys=polys, units=whole.units, **counted)
    print(f"perfbench: the bicubic spans' window, {whole.units} units in "
          f"{whole.window_s:.4f} s, busy {whole.busy_s:.4f} s, counted {counted}, "
          f"polys {polys}; built, run and reduced in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    return out


def _window(run):
    """The bicubic spans' window of this run, traced once and kept on ``run``."""
    if not hasattr(run, "bicubic_spans"):
        run.bicubic_spans = window(run)
    return run.bicubic_spans


def _device_s(sp, span: str, families=("ntt", "other")) -> float:
    row = sp["inclusive_s"].get(span, {})
    return sum(row.get(f, 0.0) for f in families)


def behz_ms(run):
    """Device ms per image of the non-NTT kernels launched under
    ``bfv.evaluator.multiply`` (BEHZ with its children)."""
    sp = _window(run)
    if not sp or not sp["count"].get(MULTIPLY) or sp["units"] <= 0:
        return None
    return 1e3 * _device_s(sp, MULTIPLY, ("other",)) / sp["units"]


def stencil_ms(run):
    """Device ms per image under the Catmull-Rom step's span less that
    under its ct x ct products: the constant products with their NTT
    bounces, and the adds."""
    sp = _window(run)
    if not sp or not sp["count"].get(CUBIC) or sp["units"] <= 0:
        return None
    return 1e3 * (_device_s(sp, CUBIC) - _device_s(sp, MULTIPLY)) / sp["units"]


def tensor_roofline(run):
    """The tensor step's least time over the non-NTT device time under
    ``bfv.rns.tensor``, in %: each operand's (component, coefficient)
    positions read once and the product's written once, a residue in each
    of the L + K primes of q and Bsk (L and K from the configuration)."""
    sp = _window(run)
    if not sp or not sp["calls"] or not sp["count"].get(TENSOR):
        return None
    dev = _device_s(sp, TENSOR, ("other",))
    if dev <= 0:
        return None
    cfg = run.cell.ctx.config
    primes = len(cfg["q_primes"]) + cfg["bsk_size"]
    least = (RESIDUE_BYTES * primes * (sp["positions_in"] + sp["positions_out"])
             / roofline.HBM_BYTES_PER_S)
    return 100.0 * least / dev


def ntt_roofline(run):
    """The NTT launches' least time over the NTT kernels' device time in
    the bicubic spans' window, in %."""
    sp = _window(run)
    if not sp or not sp["polys"] or sp["ntt_device_s"] <= 0:
        return None
    ctx = run.cell.ctx
    if not ctx.sms or not ctx.clock_hz:
        return None
    least = spans.ntt_least_s(sp["polys"], ctx.config["n"], ctx.sms, ctx.clock_hz)
    return 100.0 * least / sp["ntt_device_s"]
