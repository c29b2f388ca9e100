"""The reducer of the program's spans (``perfbench/spans.py``) on synthetic
kineto events: no card needed."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import roofline, spans, tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
HARNESS = 7  # the harness's thread
NTT_F = "void ntt_kernel<true, 12>(unsigned int const*, ...)"
NTT_I = "void ntt_kernel<false, 12>(unsigned int const*, ...)"
ELEMENTWISE = "void at::native::elementwise_kernel<128, 2>(...)"


class Ev:
    """A stand-in for torch's _KinetoEvent: what the reducers call, and
    nothing newer than torch 2.11 has."""

    def __init__(self, name, start, end, device=CPU, activity="cpu_op", corr=0,
                 thread=HARNESS):
        self._name, self._s, self._d = name, start, end - start
        self._dev, self._act, self._corr, self._tid = device, activity, corr, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._act in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


def span(name, start, end):
    return Ev(name, start, end, activity="user_annotation")


def launch(corr, at):
    return Ev("cudaLaunchKernel", at, at + 5, activity="cuda_runtime", corr=corr)


def op(name, start, end, corr):
    """A torch op whose id is a launch's correlation id too."""
    return Ev(name, start, end, corr=corr)


def kernel(name, corr, start, end):
    return Ev(name, start, end, device=CUDA, activity="kernel", corr=corr)


def window(events, end=1000):
    """spans.reduce over ``events`` in a window [0, end], found as the
    spans' window finds it, after tracing.reduce's check of the launches of
    each family, counted as the trace shows them."""
    events = [span(tracing.WINDOW, 0, end)] + events
    launched = {"ntt_forward": sum(e.name() == NTT_F for e in events),
                "ntt_inverse": sum(e.name() == NTT_I for e in events),
                "server_ycc_dct": 0}
    tracing.reduce(events, 1, launched)
    return spans.reduce(events, *spans._bounds(events))


def test_a_kernel_belongs_to_the_span_it_was_launched_in():
    """Launched inside bfv.rns.tensor, run after the span has closed (and
    while bfv.rns.scale_floor is open): still bfv.rns.tensor's."""
    sp = window([span("bfv.evaluator.multiply", 100, 600),
                 span("bfv.rns.tensor", 110, 200), launch(11, 150), op("aten::mul", 5, 50, 11),
                 span("bfv.rns.scale_floor", 210, 300),
                 kernel(ELEMENTWISE, 11, 250, 400)])
    assert sp["device_s"] == {"bfv.rns.tensor": {"ntt": 0.0, "other": 150e-9}}
    assert sp["inclusive_s"]["bfv.evaluator.multiply"]["other"] == pytest.approx(150e-9)
    assert sp["attributed"] == 1.0 and sp["count"]["bfv.rns.tensor"] == 1


def test_idle_goes_to_the_innermost_program_span():
    """A gap whose middle lies inside cudaStreamSynchronize within
    pipelines.resize.gather is the gather's; a gap outside every program
    span is outside_the_program's; aten and runtime events are passed over."""
    sp = window([kernel(ELEMENTWISE, 1, 0, 100), launch(1, 0),
                 span("pipelines.resize.resize_tile", 100, 800),
                 span("pipelines.resize.gather", 100, 300),
                 Ev("aten::to", 110, 290), Ev("cudaStreamSynchronize", 120, 280,
                                              activity="cuda_runtime"),
                 launch(2, 290), kernel(ELEMENTWISE, 2, 300, 900),
                 Ev("aten::copy_", 905, 990), launch(3, 990),
                 kernel(ELEMENTWISE, 3, 995, 1000)])
    assert sp["idle_s"] == {"pipelines.resize.gather": pytest.approx(200e-9),
                            "outside_the_program": pytest.approx(95e-9)}
    assert sp["device_s"]["pipelines.resize.gather"]["other"] == pytest.approx(600e-9)
    assert sp["device_s"]["outside_the_program"]["other"] == pytest.approx(105e-9)
    assert sp["attributed"] == pytest.approx(600 / 705)


def test_a_device_op_without_its_launch_is_unattributed():
    sp = window([span("bfv.rns.extend", 0, 50), kernel(NTT_F, 9, 10, 40)])
    assert sp["device_s"] == {"no_launch_event": {"ntt": 30e-9, "other": 0.0}}
    assert sp["attributed"] == 0.0 and sp["ntt_device_s"] == pytest.approx(30e-9)


def test_spans_of_other_threads_and_an_older_program_read_nothing():
    """Spans of another thread are not the harness's; with no program span
    and no polynomial counters every span reader returns None."""
    sp = window([Ev("bfv.evaluator.multiply", 0, 500, activity="user_annotation", thread=3),
                 launch(1, 10), kernel(ELEMENTWISE, 1, 20, 400)])
    assert sp["count"] == {} and sp["attributed"] == 0.0
    ctx = SimpleNamespace(sms=132, clock_hz=1.98e9, config={"n": 4096})
    run = SimpleNamespace(program_spans={**sp, "polys": None, "units": 1, "window_s": 1e-6},
                          cell=SimpleNamespace(ctx=ctx))
    assert spans.behz_ms(run) is None and spans.ntt_roofline(run) is None
    assert spans.idle_pct(run, "pipelines.resize.gather") is None
    untraced = SimpleNamespace(trace=None, cell=None)  # never built anew
    assert spans.behz_ms(untraced) is None and untraced.program_spans is None


def test_the_ntt_roofline_is_the_frozen_bound_over_ntt_time():
    """A known launch mix: 6,936 forward and 10,404 inverse polynomials of
    n = 4096 over 1 ms of NTT device time is roofline.bound_s by hand; the
    elementwise kernel's time is not NTT time."""
    n, pf, pi = 4096, 6936, 10404
    sp = window([span("bfv.rns.extend", 0, 100), launch(1, 10), launch(2, 20), launch(3, 30),
                 kernel(NTT_F, 1, 100, 400_100), kernel(NTT_I, 2, 400_100, 1_000_100),
                 kernel(ELEMENTWISE, 3, 1_000_100, 1_500_000)], end=1_500_000)
    assert sp["ntt_device_s"] == pytest.approx(1e-3)
    ctx = SimpleNamespace(sms=132, clock_hz=1.98e9, config={"n": n})
    run = SimpleNamespace(program_spans={**sp, "polys": {"ntt_forward": pf, "ntt_inverse": pi},
                                         "units": 1, "window_s": 1.5e-3},
                          cell=SimpleNamespace(ctx=ctx))
    least = roofline.bound_s(8 * n * (pf + pi), roofline.ntt_ops("ntt_forward", pf, n)
                             + roofline.ntt_ops("ntt_inverse", pi, n), 132, 1.98e9)
    assert least == pytest.approx(8 * n * (pf + pi) / roofline.HBM_BYTES_PER_S)  # bytes bound
    assert spans.ntt_roofline(run) == pytest.approx(100.0 * least / 1e-3)
