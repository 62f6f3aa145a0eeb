"""
The traced slice read down to the program's spans
(:mod:`port_bench.attribution`), on hand-written chrome traces whose every
number is worked out below: nested program spans, kernels joined to their
launches by correlation (``cuda*`` and ``cu*`` calls), kernels with no launch
paired with their launch spans, late and queued launches, a blocking call
inside a step span and one outside. The readers that were there before
read on the same trace what :func:`port_bench.tracing.profile` gives them.
"""

import json

import pytest
import torch

from port_bench import attribution, tracing
from port_bench.parts import load

H, S = 11, 7          # the host thread, the stream
OLD_METRICS = ("host_ms_per_step", "device_idle_pct", "k1_roofline",
               "k2_roofline", "k3_roofline", "prologue_device_ms",
               "ienks_inner_device_ms")


def _x(cat, name, ts, dur, tid=H, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _bench(name, ts, dur):
    return _x("user_annotation", tracing.SPAN_PREFIX + name, ts, dur)


def _prog(name, ts, dur):
    return _x("user_annotation", attribution.PROGRAM_PREFIX + name, ts, dur)


def _launch(ts, corr, name="cudaLaunchKernel", cat="cuda_runtime"):
    return _x(cat, name, ts, 2, correlation=corr)


def _op(name, ts, dur, corr, cat="kernel"):
    return _x(cat, name, ts, dur, tid=S, correlation=corr)


RK4 = "void rk4_l96_kernel<8>(float const*, float*)"
CHECK = "check_sorted_kernel(float const*, int, int*)"
WINDOW = "void window1d_reg_kernel<8>(float const*)"
ELEMENTWISE = "void at::native::elementwise_kernel<128, 2>()"
SVD = "void svd_jacobi_kernel<3>(float const*)"
SORT = "void at::native::radixSortKVInPlace<2, -1, 32, 4>()"
COPY = "void at::native::vectorized_elementwise_kernel<4, copy>()"


def cycle_events():
    """Two cycle steps. The window opens at the first operation (40) and
    ends with the window span (1000): 960 us. Busy 40-90, 95-220,
    320-370, 610-620, 630-635, 640-740, 760-770 (350 us); the gaps
    90-95, 220-320, 370-610, 620-630, 635-640, 740-760, 770-1000."""
    return [
        _bench("window", 0, 1000),
        _bench("step", 10, 290),
        _prog("cycle.step", 12, 286),
        _prog("forecast", 14, 46),
        _prog("kernel.rk4_l96", 20, 10),
        _launch(22, 101),
        _prog("letkf.analysis", 62, 228),
        _launch(70, 102),
        _prog("kernel.window1d", 100, 20),
        _launch(105, 103),
        _launch(106, 103, "cuLaunchKernel", "cuda_driver"),
        _launch(200, 105, "cudaStreamSynchronize"),
        _launch(299, 106, "cudaEventSynchronize"),
        _bench("step", 300, 400),
        _prog("cycle.step", 302, 396),
        _prog("forecast", 304, 36),
        _prog("kernel.rk4_l96", 306, 6),
        _launch(308, 201, "cuLaunchKernel", "cuda_driver"),
        _prog("letkf.analysis", 350, 340),
        _launch(600, 202),
        _prog("kernel.window1d", 620, 20),
        _launch(625, 203),
        _bench("sync", 700, 300),
        _launch(750, 300, "cudaMemcpyAsync"),
        # the device: 101 queued, 102 queued at 95, 104 and 204 have no
        # launch, 201, 202 and 203 late, 300 launched outside the program
        _op(RK4, 40, 50, 101),
        _op(ELEMENTWISE, 95, 20, 102),
        _op(CHECK, 115, 5, 103),
        _op(WINDOW, 120, 100, 104),
        _op(RK4, 320, 50, 201),
        _op(ELEMENTWISE, 610, 10, 202),
        _op(CHECK, 630, 5, 203),
        _op(WINDOW, 640, 100, 204),
        _op("Memcpy DtoD (Device -> Device)", 760, 10, 300,
            cat="gpu_memcpy"),
    ]


def lienks_events():
    """One IEnKS step: the selection (20 us), a forecast of a copy (15)
    and K2 (40), an inner step of a gather (25) and an SVD of K3 (100)
    and its sort (8)."""
    return [
        _bench("window", 0, 500),
        _bench("step", 5, 400),
        _prog("lienks.step", 6, 398),
        _prog("lienks.taper", 8, 20),
        _launch(10, 1),
        _prog("lienks.outer", 30, 370),
        _prog("forecast", 32, 40),
        _launch(34, 2),
        _prog("kernel.rk4_l96", 40, 10),
        _launch(42, 3),
        _prog("lienks.inner", 80, 300),
        _launch(90, 4),
        _prog("linalg.svd", 100, 200),
        _prog("kernel.svd_jacobi", 110, 20),
        _launch(115, 5),
        _launch(200, 6),
        _op(ELEMENTWISE, 20, 20, 1),
        _op(COPY, 40, 15, 2),
        _op(RK4, 55, 40, 3),
        _op(ELEMENTWISE, 95, 25, 4),
        _op(SVD, 120, 100, 5),
        _op(SORT, 220, 8, 6),
    ]


class _Profiler:
    """``torch.profiler.profile`` in the shape :func:`tracing.profile`
    and :func:`attribution.profile` use, exporting ``events``."""

    events = []

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def traced(monkeypatch, events, steps, how):
    """The table ``tracing.profile`` (``how`` "tracing") or
    ``attribution.profile`` ("attribution") makes of ``events``."""
    _Profiler.events = events
    monkeypatch.setattr(torch.profiler, "profile", _Profiler)
    fn = tracing.profile if how == "tracing" else attribution.profile
    table = fn(lambda: steps)
    table.work = {"k1": (6.0e6, 4.0e6), "k2": (2.0e6, 8.0e6),
                  "k3": (5.0e6, 1.0e6)}
    table.host_ms = [1.25, 1.5]
    return table


@pytest.fixture
def cycle(monkeypatch):
    return traced(monkeypatch, cycle_events(), 2, "attribution")


@pytest.fixture
def lienks(monkeypatch):
    return traced(monkeypatch, lienks_events(), 1, "attribution")


def read(name, table):
    return load("metrics", name).read(table)


def test_program_spans_nest_by_thread_and_time(cycle):
    spans = cycle.program_spans
    parents = [(s.name, None if s.parent is None
                else spans[s.parent].name) for s in spans]
    assert parents == [
        ("cycle.step", None), ("forecast", "cycle.step"),
        ("kernel.rk4_l96", "forecast"), ("letkf.analysis", "cycle.step"),
        ("kernel.window1d", "letkf.analysis"),
    ] * 2


def test_operations_join_their_launches(cycle):
    got = [(launch.how, launch.name, launch.ts, cycle.names(launch))
           for launch in cycle.launch]
    step = ("cycle.step",)
    assert got == [
        ("correlation", "cudaLaunchKernel", 22.0,
         step + ("forecast", "kernel.rk4_l96")),
        ("correlation", "cudaLaunchKernel", 70.0, step + ("letkf.analysis",)),
        # the runtime call, not the cu* call beneath it
        ("correlation", "cudaLaunchKernel", 105.0,
         step + ("letkf.analysis", "kernel.window1d")),
        ("fallback", "kernel.window1d", 100.0,
         step + ("letkf.analysis", "kernel.window1d")),
        ("correlation", "cuLaunchKernel", 308.0,
         step + ("forecast", "kernel.rk4_l96")),
        ("correlation", "cudaLaunchKernel", 600.0,
         step + ("letkf.analysis",)),
        ("correlation", "cudaLaunchKernel", 625.0,
         step + ("letkf.analysis", "kernel.window1d")),
        ("fallback", "kernel.window1d", 620.0,
         step + ("letkf.analysis", "kernel.window1d")),
        ("correlation", "cudaMemcpyAsync", 750.0, ()),
    ]
    assert cycle.attributed_share() == pytest.approx(340.0 / 350.0)


def test_the_fallback_pairs_in_order_and_leaves_the_rest(monkeypatch):
    events = cycle_events()
    # the second K1 launch span gone: the second unlaunched kernel stays
    # unlaunched
    events = [e for e in events
              if not (e["name"] == "tpu_assim_torch.kernel.window1d"
                      and e["ts"] == 620)]
    table = traced(monkeypatch, events, 2, "attribution")
    windows = [launch for (name, _, _), launch in zip(table.ops,
                                                      table.launch)
               if "window1d" in name]
    assert windows[0].how == "fallback" and windows[0].ts == 100.0
    assert windows[1] is None


def test_idle_gaps_name_the_launching_span(cycle):
    gaps = cycle.idle_gaps()
    assert [g[0] for g in gaps] == [
        "letkf.analysis/late",        # 370-610, launched at 600
        "sync",                       # 770-1000, the tail
        "kernel.rk4_l96/late",        # 220-320, launched at 308
        "sync",                       # 740-760, launched outside
        "kernel.window1d/late",       # 620-630, launched at 625
        "letkf.analysis/queued",      # 90-95, launched at 70
        "kernel.window1d/queued",     # 635-640, paired with 620
    ]
    assert [g[1] for g in gaps] == pytest.approx(
        [240e-6, 230e-6, 100e-6, 20e-6, 10e-6, 5e-6, 5e-6])


def test_idle_gaps_keep_the_form_and_count_of_the_benchmarks(
        monkeypatch, cycle):
    old = traced(monkeypatch, cycle_events(), 2, "tracing").idle_gaps()
    assert [g[0] for g in old] == ["step", "sync", "step", "sync", "step",
                                   "step", "step"]
    new = cycle.idle_gaps()
    assert len(new) == len(old)
    assert [g[1] for g in new] == [g[1] for g in old]
    assert cycle.idle_gaps(3) == new[:3]


def test_host_late_idle_pct(cycle, lienks):
    # 88 (220 to the launch at 308) + 230 (370 to 600) + 5 (620 to 625)
    # + 10 (740 to the copy launched outside the program at 750)
    assert read("host_late_idle_pct", cycle) == pytest.approx(
        100.0 * 333.0 / 960.0)
    # the window 20-500, busy 20-228 without a gap; the tail gap ends at
    # no operation
    assert read("host_late_idle_pct", lienks) == 0.0


def test_host_syncs_per_step(cycle, lienks):
    # the stream synchronise at 200 inside a cycle step; the event's at
    # 299 lies between step spans, the copy at 750 is asynchronous
    assert cycle.syncs == [("cudaStreamSynchronize", 200.0)]
    assert read("host_syncs_per_step", cycle) == 0.5
    assert read("host_syncs_per_step", lienks) == 0.0


def test_prologue_span_device_ms(cycle, lienks):
    # the two elementwise kernels launched in letkf.analysis, 20 + 10 us
    assert read("prologue_span_device_ms", cycle) == pytest.approx(0.015)
    assert read("prologue_span_device_ms", lienks) is None
    # the remainder counts the copy launched outside the program too
    assert read("prologue_device_ms", cycle) == pytest.approx(0.020)


def test_ienks_span_device_ms(cycle, lienks):
    # the selection 20, the gather 25, the sort 8; not the forecast's copy
    # and K2, nor K3
    assert read("ienks_span_device_ms", lienks) == pytest.approx(0.053)
    assert read("ienks_span_device_ms", cycle) is None
    assert read("ienks_inner_device_ms", lienks) == pytest.approx(0.068)


@pytest.mark.parametrize("events,steps", [(cycle_events, 2),
                                          (lienks_events, 1)],
                         ids=["cycle", "lienks"])
def test_the_old_readers_read_what_tracing_profile_gives(monkeypatch,
                                                         events, steps):
    old = traced(monkeypatch, events(), steps, "tracing")
    new = traced(monkeypatch, events(), steps, "attribution")
    assert (new.ops, new.spans, new.t0, new.t1, new.steps) == (
        old.ops, old.spans, old.t0, old.t1, old.steps)
    for name in OLD_METRICS:
        assert read(name, new) == read(name, old), name


def test_the_old_readers_by_hand(monkeypatch):
    old = traced(monkeypatch, cycle_events(), 2, "tracing")
    assert read("device_idle_pct", old) == pytest.approx(
        100.0 * 610.0 / 960.0)
    assert read("host_ms_per_step", old) == pytest.approx(1.375)


def test_span_readers_read_nothing_from_the_tracing_table(monkeypatch):
    old = traced(monkeypatch, cycle_events(), 2, "tracing")
    for name in ("host_late_idle_pct", "host_syncs_per_step",
                 "prologue_span_device_ms", "ienks_span_device_ms"):
        assert read(name, old) is None


def test_blocking_calls():
    assert attribution.blocks_on_card("cudaStreamSynchronize")
    assert attribution.blocks_on_card("cudaMemcpy")
    assert attribution.blocks_on_card("cudaMemcpy2D")
    assert not attribution.blocks_on_card("cudaMemcpyAsync")
    assert not attribution.blocks_on_card("cudaLaunchKernel")
