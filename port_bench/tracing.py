"""
The traced slice of a run: ``torch.profiler`` over a few dispatch-ahead
steps, its chrome trace read back into a table of device operations and of
the benchmark's own host spans, in one timebase.
"""

import json
import os
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "port_bench."
WINDOW_SPAN = SPAN_PREFIX + "window"


@contextmanager
def span(name: str):
    """A host span of the benchmark's own, recorded while tracing."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Table:
    """The traced window: device operations and host spans as ``(name,
    start_us, duration_us)``, the window's bounds, and the steps in it."""

    ops: list
    spans: list
    t0: float
    t1: float
    steps: int
    work: dict = field(default_factory=dict)
    host_ms: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        """The union of the device operations' intervals inside the
        window, sorted."""
        merged = []
        for _, ts, dur in sorted(self.ops, key=lambda r: r[1]):
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_ms_per_step(self, names=None, exclude=None) -> float:
        """Device time a step of the operations whose name holds one of
        ``names`` (all with None), leaving out those holding one of
        ``exclude``."""
        total = sum(dur for name, _, dur in self.ops
                    if (names is None or any(n in name for n in names))
                    and not (exclude and any(n in name for n in exclude)))
        return total * 1e-3 / self.steps

    def count(self, name: str) -> int:
        return sum(1 for op, _, _ in self.ops if name in op)

    def top_ops(self, n: int = 10):
        """The ``n`` device operations that took most time, by name:
        ``[[name, seconds], ...]``."""
        by_name = {}
        for name, _, dur in self.ops:
            by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
        top = sorted(by_name.items(), key=lambda r: -r[1])[:n]
        return [[name[:120], s] for name, s in top]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest spans of the window in which no device
        operation ran, each named by the benchmark's host span that
        overlaps it most: ``[[span, seconds], ...]``."""
        gaps, edge = [], self.t0
        for a, b in self.busy_intervals():
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:n]:
            best, label = 0.0, "outside the benchmark's spans"
            for name, ts, dur in self.spans:
                if name == WINDOW_SPAN:
                    continue
                overlap = min(b, ts + dur) - max(a, ts)
                if overlap > best:
                    best, label = overlap, name[len(SPAN_PREFIX):]
            named.append([label, (b - a) * 1e-6])
        return named


def read_chrome_trace(prof) -> tuple:
    """``(device ops, host spans)`` of a finished profiler, through its
    chrome trace written to a temporary file under ``TMPDIR`` and deleted."""
    with tempfile.TemporaryDirectory(prefix="port_bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        row = (ev.get("name", ""), float(ev["ts"]), float(ev["dur"]))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            ops.append(row)
        elif cat == "user_annotation" and row[0].startswith(SPAN_PREFIX):
            spans.append(row)
    return ops, spans


def profile(run_steps) -> Table:
    """Trace ``run_steps()``, which dispatches steps inside a
    :data:`WINDOW_SPAN` span, synchronises, and returns how many steps it
    ran. The window runs from the span's first device operation to the
    span's end."""
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        steps = run_steps()
    ops, spans = read_chrome_trace(prof)
    window = [s for s in spans if s[0] == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the profiler recorded no window span")
    _, start, dur = window[0]
    # the window opens at its first device operation: the host's dispatch
    # of the first step after a synchronise happens once in a run's window
    # and would weigh as much as the steady state in a slice this short
    first = min((ts for _, ts, _ in ops if ts >= start), default=start)
    return Table(ops, spans, first, start + dur, steps)
