"""
The program's spans over one cell, on the card:

    python3 port_bench/spans.py --workload <cell> --seed <n> [--seconds 2.5]
    python3 port_bench/spans.py --span-cost

from the root of a checkout. The first builds and warms up the cell as
``run.py`` does, times the entry call with no profiler running (each step
after a synchronise, ``host_ms_per_step``), then takes the cell's traced
slice through :func:`port_bench.attribution.profile` and prints one JSON
line: the cell's per-layer metrics and the four read from the program's
spans (:data:`SPAN_METRICS`), the share of device time launched inside a
program span, how the kernels of K1-K3 joined their launches, the host time
of a step inside the traced slice, the part of the window the card waited
for the host in each step of the slice, and the idle gaps named both ways.
The second prints the host cost of one ``span`` with no profiler running.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import timeit
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SPAN_METRICS = ("host_late_idle_pct", "host_syncs_per_step",
                "prologue_span_device_ms", "ienks_span_device_ms")
# K1-K3's kernels, by a part of their names
KERNELS = ("window1d", "check_sorted", "rk4_l96", "svd_jacobi")


def span_cost(calls: int = 200_000) -> dict:
    """Microseconds a call, with no profiler running: ``span(name)``
    alone, a ``with`` of it, and a ``with`` of a bare null context; and a
    ``with`` of it while a profiler of the host and the card runs, over a
    tenth of the calls."""
    import torch
    from torch.profiler import ProfilerActivity

    from tpu_assim_torch.utils.profiling import span

    null = contextlib.nullcontext()

    def spanned():
        with span("forecast"):
            pass

    def bare():
        with null:
            pass

    def us(fn):
        return timeit.timeit(fn, number=calls) / calls * 1e6

    out = {"span_us": us(lambda: span("forecast")),
           "with_span_us": us(spanned), "with_null_us": us(bare),
           "calls": calls}
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    calls //= 10
    with torch.profiler.profile(activities=activities):
        out["with_span_profiled_us"] = us(spanned)
        out["with_null_profiled_us"] = us(bare)
    out["profiled_calls"] = calls
    return out


def idle_split(table) -> dict:
    """The window's idle milliseconds a step, by what the card waited
    for: ``late``, the part of each gap before its ending operation's
    launch; ``queued``, the rest of the gaps that end at a launched
    operation; ``end``, the gap after the last operation; ``unlaunched``,
    gaps that end at an operation with no launch found."""
    out = {"late": 0.0, "queued": 0.0, "end": 0.0, "unlaunched": 0.0}
    for a, b, i in table.gaps():
        launch = None if i is None else table.launch[i]
        if i is None:
            out["end"] += b - a
        elif launch is None:
            out["unlaunched"] += b - a
        else:
            late = max(min(b, launch.ts) - a, 0.0)
            out["late"] += late
            out["queued"] += b - a - late
    return {k: v * 1e-3 / table.steps for k, v in out.items()}


def span_ms(table) -> dict:
    """Mean host milliseconds of each program span, by name."""
    by_name = {}
    for s in table.program_spans:
        by_name.setdefault(s.name, []).append(s.dur * 1e-3)
    return {name: statistics.fmean(v) for name, v in sorted(by_name.items())}


def _late_by_step(table) -> list:
    """Milliseconds the card waited for the host, by the step of the
    slice (the benchmark's ``step`` spans, in order) whose launch ended
    the wait."""
    from port_bench.tracing import SPAN_PREFIX

    steps = sorted(ts for name, ts, _ in table.spans
                   if name == SPAN_PREFIX + "step")
    late = [0.0] * len(steps)
    for a, b, i in table.gaps():
        launch = None if i is None else table.launch[i]
        if launch is None or launch.ts <= a or not steps:
            continue
        k = max(sum(ts <= launch.ts for ts in steps) - 1, 0)
        late[k] += (min(b, launch.ts) - a) * 1e-3
    return late


def joins(table) -> dict:
    """How the kernels of K1-K3 found their launches: ``{kernel: {how:
    count}}``, ``"none"`` where neither the correlation nor the pairing
    found one."""
    out = {}
    for (name, _, _), launch in zip(table.ops, table.launch):
        part = next((p for p in KERNELS if p in name), None)
        if part is not None:
            how = "none" if launch is None else launch.how
            out.setdefault(part, Counter())[how] += 1
    return {k: dict(v) for k, v in out.items()}


def measure(root, workload, seed, seconds, device, retakes=2) -> dict:
    """One cell's spans: see the module's docstring."""
    import torch

    from port_bench import attribution, harness, tracing
    from port_bench.parts import load

    spec = harness.Spec(root, workload)
    entry, runner, events = harness.prepare(spec, seed, device)
    for j in range(harness.WARMUP_STEPS):
        runner.run_once(entry.initial(), j % runner.pool)
    events.sync()
    before = harness._counters(entry.work)
    runner.run_once(entry.initial(), 0)
    events.sync()
    launches = {k: v - before[k]
                for k, v in harness._counters(entry.work).items()}
    host = harness.synced_host_ms(runner, events, seconds)
    steps = spec.traffic["trace_steps"]
    for _ in range(1 + retakes):
        table = attribution.profile(
            lambda: harness._profiled(runner, events, steps))
        if all(table.count(load("work", k).KERNEL_NAMES[0])
               >= n * table.steps for k, n in launches.items()):
            break
    else:
        raise RuntimeError("the profiler recorded fewer launches than the "
                           "steps made")
    table.work, table.host_ms = entry.work, host
    metrics = {}
    for name in [m["name"] for m in spec.per_layer] + list(SPAN_METRICS):
        value = load("metrics", name).read(table)
        if value is not None:
            metrics[name] = value
    step_ms = [dur * 1e-3 for name, _, dur in table.spans
               if name == tracing.SPAN_PREFIX + "step"]
    nesting = Counter(
        (s.name, None if s.parent is None
         else table.program_spans[s.parent].name)
        for s in table.program_spans)
    out = {
        "workload": workload, "seed": seed,
        "card": harness.card_info(spec.chips) if device.type == "cuda"
        else {"platform": device.type},
        "host_ms_per_step": statistics.fmean(host),
        "host_steps": len(host),
        "traced_steps": table.steps,
        "traced_step_span_ms": statistics.fmean(step_ms),
        "metrics": metrics,
        "spans_per_step": {f"{name} in {parent}": n / table.steps
                           for (name, parent), n in sorted(
                               nesting.items(), key=str)},
        "span_ms": span_ms(table),
        "idle_ms_per_step": idle_split(table),
        "attributed_share": table.attributed_share(),
        "joins": joins(table),
        "syncs": table.syncs,
        "late_ms_by_step": _late_by_step(table),
        "idle_gaps": table.idle_gaps(),
        "idle_gaps_by_benchmark_span": tracing.Table.idle_gaps(table),
        "window_s": table.window_s, "busy_s": table.busy_s,
    }
    harness.release(entry, runner, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--seconds", type=float, default=2.5,
                        help="seconds of the synchronised host timing")
    parser.add_argument("--span-cost", action="store_true")
    args = parser.parse_args(argv)
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    if args.span_cost:
        print(json.dumps(span_cost()), flush=True)
        return 0
    if not args.workload:
        parser.error("--workload is required without --span-cost")

    import torch

    if not torch.cuda.is_available():
        print("the spans are measured on a CUDA device; "
              "torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    print(json.dumps(measure(ROOT, args.workload, args.seed, args.seconds,
                             torch.device("cuda:0"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
