"""
The traced slice read down to the program's own spans: each device
operation joined to the host call that launched it, and through it to the
spans of ``tpu_assim_torch`` (``tpu_assim_torch.utils.profiling.span``)
open on the launching thread at that moment, all on the profiler's one
clock.

:func:`profile` takes the slice as :func:`port_bench.tracing.profile` does
and returns a :class:`SpanTable`: the same operations, benchmark spans and
window as :class:`port_bench.tracing.Table`, so every reader of
``metrics/`` reads the same numbers from it, and besides

- ``program_spans``: the program's spans, each with its parent;
- ``launch``: each operation's launch, the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``args.correlation``; where a kernel
  has none (a library bound through ``ctypes`` links the CUDA runtime
  statically), the n-th kernel of a name is paired with the n-th span of
  its launch (:data:`LAUNCH_SPANS`), in order on the one stream, and the
  span's start stands for the launch;
- ``syncs``: the launching threads' calls that block on the card inside a
  step span (:data:`STEP_SPANS`).

Its :meth:`SpanTable.idle_gaps` names a gap that ends at an operation by
the innermost program span of that operation's launch, ``/late`` when the
launch came after the gap opened (the card waited for the host),
``/queued`` when the operation was already queued.
"""

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

from port_bench import tracing

PROGRAM_PREFIX = "tpu_assim_torch."
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
STEP_SPANS = ("cycle.step", "lienks.step")
# a kernel's name (a part of it) -> the program span around its launch
LAUNCH_SPANS = {"window1d": "kernel.window1d",
                "check_sorted": "kernel.window1d",
                "rk4_l96": "kernel.rk4_l96",
                "svd_jacobi": "kernel.svd_jacobi"}
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize")


def blocks_on_card(name: str) -> bool:
    """True for a CUDA runtime call that waits for the card: a
    synchronise, or a copy without ``Async``."""
    return name in BLOCKING_CALLS or (name.startswith("cudaMemcpy")
                                      and "Async" not in name)


@dataclass
class ProgramSpan:
    """A span of the program: its name without the prefix, start and
    duration (us), host thread, and the index of its parent in
    ``program_spans`` (None at the top)."""

    name: str
    ts: float
    dur: float
    tid: object
    parent: object = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Launch:
    """The host side of a device operation: the launching call's name
    (the span's for a pairing), its host time (us), and the stack of
    program spans open there, indices into ``program_spans``, outermost
    first. ``how`` is ``"correlation"`` or ``"fallback"``."""

    name: str
    ts: float
    stack: tuple
    how: str


@dataclass
class SpanTable(tracing.Table):
    """:class:`port_bench.tracing.Table` with the program's spans, each
    operation's launch (None where neither its correlation nor a pairing
    finds one) and the blocking calls inside step spans, as ``(name,
    ts)``."""

    program_spans: list = field(default_factory=list)
    launch: list = field(default_factory=list)
    syncs: list = field(default_factory=list)

    def names(self, launch) -> tuple:
        """The names of the program spans open at ``launch``, outermost
        first."""
        return tuple(self.program_spans[i].name for i in launch.stack)

    def device_ms_under(self, under, outside=()) -> float:
        """Device time a step of the operations launched inside a program
        span named in ``under`` and inside none named in ``outside``."""
        total = 0.0
        for (_, _, dur), launch in zip(self.ops, self.launch):
            if launch is None:
                continue
            names = self.names(launch)
            if any(n in names for n in under) and not any(
                    n in names for n in outside):
                total += dur
        return total * 1e-3 / self.steps

    def attributed_share(self) -> float:
        """The share of the operations' device time launched inside a
        program span."""
        total = sum(dur for _, _, dur in self.ops)
        inside = sum(dur for (_, _, dur), launch in zip(self.ops, self.launch)
                     if launch is not None and launch.stack)
        return inside / total if total > 0.0 else 0.0

    def gaps(self):
        """Every span of the window with no device operation running, as
        ``(start, end, index of the operation that ends it or None)``, in
        the order :meth:`port_bench.tracing.Table.idle_gaps` finds them."""
        starts = {}
        for i, (_, ts, _) in enumerate(self.ops):
            starts.setdefault(ts, i)
        out, edge = [], self.t0
        for a, b in self.busy_intervals():
            if a > edge:
                out.append((edge, a, starts.get(a)))
            edge = max(edge, b)
        if self.t1 > edge:
            out.append((edge, self.t1, None))
        return out

    def late_us(self) -> float:
        """Sum over the gaps that end at an operation of the part before
        its launch: ``(min(gap end, launch) - gap start)+``."""
        total = 0.0
        for a, b, i in self.gaps():
            if i is not None and self.launch[i] is not None:
                total += max(min(b, self.launch[i].ts) - a, 0.0)
        return total

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest gaps as :meth:`port_bench.tracing.Table.
        idle_gaps` gives them, each that ends at an operation launched
        inside a program span named ``<innermost span>/late`` or
        ``/queued``; the others keep the benchmark span's name."""
        named = super().idle_gaps(n)
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        for row, (a, _, i) in zip(named, gaps):
            launch = None if i is None else self.launch[i]
            if launch is not None and launch.stack:
                inner = self.program_spans[launch.stack[-1]].name
                row[0] = f"{inner}/{'late' if launch.ts > a else 'queued'}"
        return named


def _nest(spans):
    """Set each span's parent: the innermost span of its thread that
    holds it. Spans of one thread nest, as ``record_function``'s do."""
    by_tid = {}
    for i in sorted(range(len(spans)),
                    key=lambda i: (spans[i].ts, -spans[i].dur)):
        open_ = by_tid.setdefault(spans[i].tid, [])
        while open_ and spans[open_[-1]].end <= spans[i].ts:
            open_.pop()
        spans[i].parent = open_[-1] if open_ else None
        open_.append(i)


class _Stacks:
    """The stack of program spans open on a thread at a time."""

    def __init__(self, spans):
        self.spans = spans
        self.by_tid = {}
        for i in sorted(range(len(spans)), key=lambda i: spans[i].ts):
            self.by_tid.setdefault(spans[i].tid, []).append(i)
        self.starts = {tid: [spans[i].ts for i in idx]
                       for tid, idx in self.by_tid.items()}

    def innermost(self, tid, t):
        """The innermost span of thread ``tid`` open at ``t``, or None:
        the latest to start at or before ``t``, or the nearest of its
        ancestors still open."""
        idx = self.by_tid.get(tid)
        if not idx:
            return None
        k = bisect.bisect_right(self.starts[tid], t) - 1
        i = idx[k] if k >= 0 else None
        while i is not None and not (self.spans[i].ts <= t
                                     < self.spans[i].end):
            i = self.spans[i].parent
        return i

    def stack(self, i) -> tuple:
        """Span ``i`` and its ancestors, outermost first."""
        out = []
        while i is not None:
            out.append(i)
            i = self.spans[i].parent
        return tuple(reversed(out))


def parse(events, steps) -> SpanTable:
    """The :class:`SpanTable` of a chrome trace's events: its operations
    and benchmark spans kept as :func:`port_bench.tracing.
    read_chrome_trace` keeps them, its window as :func:`port_bench.
    tracing.profile` opens it."""
    ops, spans, corr, program, calls = [], [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        name, ts, dur = ev.get("name", ""), float(ev["ts"]), float(ev["dur"])
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        if cat in tracing.DEVICE_CATEGORIES:
            ops.append((name, ts, dur))
            corr.append(args.get("correlation"))
        elif cat == "user_annotation":
            if name.startswith(tracing.SPAN_PREFIX):
                spans.append((name, ts, dur))
            elif name.startswith(PROGRAM_PREFIX):
                program.append(ProgramSpan(name[len(PROGRAM_PREFIX):], ts,
                                           dur, ev.get("tid")))
        elif cat in LAUNCH_CATEGORIES:
            calls.append((name, ts, ev.get("tid"), cat,
                          args.get("correlation")))
    window = [s for s in spans if s[0] == tracing.WINDOW_SPAN]
    if not window:
        raise RuntimeError("the profiler recorded no window span")
    _, start, wdur = window[0]
    first = min((ts for _, ts, _ in ops if ts >= start), default=start)

    _nest(program)
    stacks = _Stacks(program)
    by_corr = {}
    for name, ts, tid, cat, c in calls:
        # a runtime call and the cu* call beneath it: the runtime's
        if c is not None and (c not in by_corr or cat == "cuda_runtime"):
            by_corr[c] = (name, ts, tid)
    launch = []
    for c in corr:
        call = by_corr.get(c)
        if call is None:
            launch.append(None)
            continue
        name, ts, tid = call
        launch.append(Launch(name, ts,
                             stacks.stack(stacks.innermost(tid, ts)),
                             "correlation"))
    _pair_unlaunched(ops, launch, program, stacks)

    steps_open = [s for s in program if s.name in STEP_SPANS]
    syncs = [(name, ts) for name, ts, tid, cat, _ in calls
             if cat == "cuda_runtime" and blocks_on_card(name)
             and any(s.tid == tid and s.ts <= ts < s.end
                     for s in steps_open)]
    return SpanTable(ops, spans, first, start + wdur, steps,
                     program_spans=program, launch=launch, syncs=syncs)


def _pair_unlaunched(ops, launch, program, stacks):
    """The fallback: the n-th kernel of a name in :data:`LAUNCH_SPANS` is
    paired with the n-th span of its launch, where it found no launch."""
    for part, span_name in LAUNCH_SPANS.items():
        kernels = sorted((ts, i) for i, (name, ts, _) in enumerate(ops)
                         if part in name)
        if all(launch[i] is not None for _, i in kernels):
            continue
        own = sorted((s.ts, j) for j, s in enumerate(program)
                     if s.name == span_name)
        for (_, i), (ts, j) in zip(kernels, own):
            if launch[i] is None:
                launch[i] = Launch(span_name, ts, stacks.stack(j),
                                   "fallback")


def read_events(prof) -> list:
    """The events of a finished profiler's chrome trace, written to a
    temporary file under ``TMPDIR`` and deleted."""
    with tempfile.TemporaryDirectory(prefix="port_bench_spans_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return events


def profile(run_steps) -> SpanTable:
    """Trace ``run_steps()`` as :func:`port_bench.tracing.profile` does,
    read down to the program's spans."""
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        steps = run_steps()
    return parse(read_events(prof), steps)
