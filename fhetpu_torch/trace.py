"""The program's named spans, on the profiler's clock.

``span(name)`` is a context manager around one step of the program.  While
a ``torch.profiler`` records (the CLIs' ``--profile-dir``, ``chip_smoke.py``,
a benchmark's traced window) it is ``torch.profiler.record_function(name)``,
so the span lands in the trace beside the kernels it launched, on the same
clock.  Otherwise it is one shared no-op, and a span costs one check of the
profiler's state: entering a ``record_function`` costs microseconds even with
no profiler on.  PERF.md lists the spans and what reads each of them.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A context manager that records ``name`` while a profiler is on."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
