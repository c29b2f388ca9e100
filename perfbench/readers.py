"""What the metric readers under ``metrics/`` share.  A reader takes the
run's summary (units, window_s, setup_s, the cell's work per unit, and with
trace the window's ``tracing.Trace``) and returns a number, or None where
it finds nothing to read."""

from __future__ import annotations


def rate(run, work: str) -> float:
    """All the work of the window over all of its time."""
    return run.units * run.work[work] / run.window_s


def idle_pct(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def step_roofline(run):
    """The step's least time (``roofline``), times the units traced, over
    the device's busy time in the traced window, in %."""
    tr, bound = run.trace, run.cell.bound_s
    if tr is None or not bound or tr.busy_s <= 0:
        return None
    return 100.0 * bound * tr.units / tr.busy_s
