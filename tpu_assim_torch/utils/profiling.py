"""
Tracing and profiling utilities (the port of
:mod:`tpu_assim.utils.profiling`): named phase timers with a process-wide
registry, a ``torch.profiler`` trace context for device timelines, and
spans (``torch.profiler.record_function``) that show up in it.

The program's own layer boundaries open a :func:`span`
(``tpu_assim_torch.<name>`` in a trace): the cycle and IEnKS steps, the
forecast, the LETKF analysis, the x-strip analysis and its scatter back,
the IEnKS taper, outer iteration and inner step, the SVD dispatch, and
each launch of kernels K1, K2, K3 and K6. A span
records only while a profiler runs; otherwise it costs one check.

Usage::

    from tpu_assim_torch.utils.profiling import phase, report, trace

    with phase("forecast"):
        state = step(state)
    with phase("analysis", block=True):   # waits for the card's work
        analysis = analyse(...)
    print(report())

    with trace("traces"):                 # a Chrome trace (chrome://tracing)
        analysis = analyse(...)
"""

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

logger = logging.getLogger(__name__)

__all__ = ["phase", "report", "reset", "span", "timings", "trace"]

SPAN_PREFIX = "tpu_assim_torch."
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


def _recorded(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs,
    else the shared null context: with no profiler, one check and nothing
    entered."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


def span(name: str):
    """The program's span ``tpu_assim_torch.<name>``: recorded in the
    profiler's trace, beside the device operations it launches, while a
    profiler runs (``torch.profiler.profile``, :func:`trace`); with none
    running it returns a shared :class:`contextlib.nullcontext`."""
    return _recorded(SPAN_PREFIX + name)


@contextlib.contextmanager
def phase(name: str, block: bool = False) -> Iterator[None]:
    """Time a named phase, accumulating over calls, as a
    ``torch.profiler.record_function`` span (named in traces too) while a
    profiler runs.

    CUDA work is asynchronous: without ``block`` the timer measures what
    the host spent queueing it. With ``block=True`` it waits for the card's
    queued work (``torch.cuda.synchronize``) before stopping, when a card is
    in use.
    """
    start = time.perf_counter()
    with _recorded(name):
        yield
        if block and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    with _lock:
        _totals[name] += elapsed
        _counts[name] += 1
    logger.debug("phase %s: %.3f ms", name, elapsed * 1e3)


def timings() -> Dict[str, Dict[str, float]]:
    """Snapshot of the accumulated phase timings."""
    with _lock:
        return {
            name: {
                "total_s": _totals[name],
                "count": _counts[name],
                "mean_ms": 1e3 * _totals[name] / max(_counts[name], 1),
            }
            for name in _totals
        }


def report() -> str:
    """Human-readable phase report, the longest phase first."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1]["total_s"])
    lines = ["{0:<28} {1:>10} {2:>12} {3:>10}".format(
        "phase", "calls", "total [s]", "mean [ms]")]
    for name, row in rows:
        lines.append("{0:<28} {1:>10d} {2:>12.3f} {3:>10.3f}".format(
            name, row["count"], row["total_s"], row["mean_ms"]))
    return "\n".join(lines)


def reset() -> None:
    """Forget every accumulated timing."""
    with _lock:
        _totals.clear()
        _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` trace context: the host's activity, and the
    card's when one is in use, written as a Chrome trace
    (``log_dir/trace.json``; open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
