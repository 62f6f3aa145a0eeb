"""
One run of one cell: everything is found by name from ``BENCHMARK.json``.

- ``configs/<config>.json``: the deployment's sizes, and the names of its
  network, obs operator, forecast model and localization, each a module
  found by name (:mod:`port_bench.parts`);
- ``traffic/<traffic>.json``: the mix's parameters, read by the general
  generator (:mod:`port_bench.inputs`); its ``entry`` names the module of
  ``entries/`` that drives the program;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a reader ``read(table) -> float or None`` of
  each per-layer metric, over the traced window (:mod:`port_bench.tracing`).

A run makes the inputs from the seed, builds the program's step, warms up
every shape the cell uses, then runs a closed loop of one caller for the
window: each step dispatched after the one before with no synchronise
between steps, at most :data:`INFLIGHT` steps ahead of the card, a CUDA
event after each. After the window it reads the peak memory, frees the
program, and compares a sample of the window's steps, drawn from the seed,
with the plain reference (:mod:`port_bench.reference`).
"""

import importlib
import json
import math
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from port_bench import tracing
from port_bench.inputs import make_inputs
from port_bench.parts import PACKAGE, load
from port_bench.reference.precision import Products

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_assim")
# steps a caller dispatches ahead of the card before it waits
INFLIGHT = 3
# warm-up steps on the seeded prior, observation vectors 0, 1, 2
WARMUP_STEPS = 3
# the share of ``--seconds`` of a traced run that times the entry call
HOST_FRACTION = 0.25


class Spec:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix,
    limits and metrics."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.cell = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = self._json(configs[self.cell["config"]]["file"])
        self.traffic = self._json(self._in_package(
            "traffic", self.cell["traffic"] + ".json"))
        self.limits = self._json(self._in_package("limits",
                                                  workload + ".json"))
        self.chips = int(self.cell["chips"])

        def mine(m):
            return workload in m.get("workloads", [workload])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def _in_package(self, *parts) -> str:
        return str(Path(PACKAGE.name, *parts))

    def _json(self, rel: str) -> dict:
        return json.loads((self.root / rel).read_text())

    def entry(self, inputs, device):
        return load("entries", self.traffic["entry"]).build(
            self.config, self.traffic, inputs, device)

    def reader(self, metric: str):
        return load("metrics", metric).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def seconds_since_process_start() -> float:
    """Seconds since this process started, from ``/proc/self/stat``."""
    import os

    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


def quantile(values, q: float) -> float:
    """The ``q`` quantile by linear interpolation between order
    statistics (``statistics.quantiles(..., method="inclusive")``)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[
        int(round(q * 100)) - 1]


def _counters(work_ids) -> dict:
    """The program's launch counters of the kernels in ``work_ids``."""
    out = {}
    for kid in work_ids:
        module, key = load("work", kid).COUNTER
        out[kid] = importlib.import_module(module).LAUNCHES[key]
    return out


class Runner:
    """The program's step driven in a closed loop, the steps to check
    kept."""

    def __init__(self, entry, traffic, seed, fault=None):
        self.entry, self.traffic = entry, traffic
        self.pool = traffic["obs_pool"]
        self.chained = traffic["chained"]
        self.fault = fault
        draws = random.Random(seed).sample(range(1, 64),
                                           traffic["check_samples"])
        self.sample = {0, *draws}
        self.reset()

    def reset(self):
        """Back to the first step on the seeded prior."""
        self.state = self.entry.initial()
        self.step_index = 0
        self.kept = {}
        self.last = None

    def run_once(self, prior, j):
        out = self.entry.run(prior, j)
        if self.fault is not None:
            out = self.fault(prior, out)
        return out

    def step(self):
        i, prior = self.step_index, self.state
        j = i % self.pool
        with tracing.span("step"):
            out = self.run_once(prior, j)
        if i in self.sample:
            self.kept[i] = (prior, j, out)
        self.last = (i, prior, j, out)
        if self.chained:
            self.state = out
        self.step_index += 1
        return out

    def samples(self):
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1:]
        return [kept[i] for i in sorted(kept)]

    def retained_bytes(self) -> int:
        """Bytes of the sampled steps' tensors that only the check holds:
        not the state the next step would take, nor the seeded prior."""
        def ptr(t):
            return t.untyped_storage().data_ptr()

        live = {ptr(self.state), ptr(self.entry.initial())}
        held = {ptr(t): t.untyped_storage().nbytes()
                for prior, _, out in self.samples() for t in (prior, out)}
        return sum(n for p, n in held.items() if p not in live)


class Events:
    """Step-completion marks: CUDA events on the card, the host clock
    after a synchronous step elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def dispatch_ahead(runner, events, seconds=None, steps=None):
    """Steps in a closed loop for ``seconds`` (or ``steps`` steps), at most
    :data:`INFLIGHT` ahead of the card. Returns ``(steps, wall s, [ms between
    successive step completions])``."""
    marks = []
    events.sync()
    t0 = time.perf_counter()
    start = events.mark()
    n = 0
    while (time.perf_counter() - t0 < seconds) if steps is None \
            else n < steps:
        if len(marks) >= INFLIGHT:
            with tracing.span("wait"):
                events.wait(marks[-INFLIGHT])
        runner.step()
        marks.append(events.mark())
        n += 1
    with tracing.span("sync"):
        events.sync()
    wall = time.perf_counter() - t0
    gaps = [events.ms(a, b) for a, b in zip([start] + marks[:-1], marks)]
    return n, wall, gaps


def synced_host_ms(runner, events, seconds) -> list:
    """Host milliseconds of each step call, each step after a
    synchronise, for ``seconds``."""
    host = []
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        events.sync()
        t = time.perf_counter()
        runner.step()
        host.append((time.perf_counter() - t) * 1e3)
    events.sync()
    return host


def errors(entry, samples, control=None) -> list:
    """``max|x - reference| / max|reference|`` of each sampled step, the
    reference in f64 and computed once a prior and observation vector;
    ``x`` the program's output, or with ``control`` (a precision of
    :mod:`port_bench.reference.precision`) the reference computed in that
    precision in the program's place. NaN or infinity reads as the largest
    float, which JSON carries."""
    cache, out = {}, []
    for prior, j, result in samples:
        key = (id(prior), j)
        if key not in cache:
            cache[key] = entry.reference(prior, j, Products("f64"))
        ref = cache[key]
        if control is not None:
            result = entry.reference(prior, j, Products(control))
        err = ((result.double() - ref).abs().max() / ref.abs().max()).item()
        out.append(err if math.isfinite(err) else sys.float_info.max)
    return out


def check(spec, entry, samples):
    """``({name: (value, limit)}, failed)``: the largest error of the
    sampled steps (:func:`errors`) and how many are over the limit."""
    limit = spec.limits["analysis_rel_err"]["limit"]
    errs = errors(entry, samples)
    return ({"analysis_rel_err": (max(errs), limit)},
            sum(e > limit for e in errs))


def card_info(chips: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        info["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "not read"
    return info


def prepare(spec, seed, device, fault=None, marks=None):
    """The cell's inputs from ``seed`` and the program's step built on
    them: ``(entry, runner, events)``. ``marks`` gets the seconds since
    the process started at the end of each part (``inputs``, ``build``)."""
    marks = {} if marks is None else marks
    if device.type == "cuda":
        # every configuration states f32 with TF32 off (its guarantees)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    events = Events(device)
    inputs = make_inputs(spec.config, spec.traffic, seed, device)
    events.sync()
    marks["inputs"] = seconds_since_process_start()
    entry = spec.entry(inputs, device)
    marks["build"] = seconds_since_process_start()
    return entry, Runner(entry, spec.traffic, seed, fault), events


def release(entry, runner, device) -> list:
    """The sampled steps, once the program's state is freed."""
    samples = runner.samples()
    entry.free()
    runner.state = runner.kept = runner.last = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return samples


def run_cell(root, workload, seed, seconds, trace, device, fault=None,
             log=None):
    """One run of cell ``workload``. Returns the result's dict and the
    lines of the numbers compared, each beside its limit."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    marks = {"imports": seconds_since_process_start()}
    spec = Spec(root, workload)
    entry, runner, events = prepare(spec, seed, device, fault, marks)

    # set-up: every shape of the cell's steps, then the launches a step
    for j in range(WARMUP_STEPS):
        runner.run_once(entry.initial(), j % runner.pool)
    events.sync()
    before = _counters(entry.work)
    runner.run_once(entry.initial(), 0)
    events.sync()
    launches = {k: v - before[k] for k, v in _counters(entry.work).items()}
    if trace:
        tracing.profile(lambda: _profiled(runner, events, 1))
        runner.reset()
    setup_s = seconds_since_process_start()
    parts, last = [], 0.0
    for part, t in (*marks.items(), ("warm-up", setup_s)):
        parts.append(f"{part} {t - last:.3f}")
        last = t
    log(f"[{workload}] set-up {setup_s:.3f} s ({', '.join(parts)}); "
        f"launches a step {launches}")
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(0)
        torch.cuda.reset_peak_memory_stats(0)

    dev = {}
    if not trace:
        n, wall, gaps = dispatch_ahead(runner, events, seconds=seconds)
        values = {"gridpoints_per_s": entry.columns * n / wall,
                  "step_ms_p95": quantile(gaps, 0.95),
                  "setup_s": setup_s}
        log(f"[{workload}] {n} steps in {wall:.4f} s; step ms median "
            f"{statistics.median(gaps)!r}, p95 {values['step_ms_p95']!r}, "
            f"longest {sorted(gaps)[-3:]!r}")
    else:
        host = synced_host_ms(runner, events, HOST_FRACTION * seconds)
        table = _traced_slice(runner, events, spec, launches, log)
        table.work, table.host_ms = entry.work, host
        n = len(host) + table.steps
        values = {}
        for m in spec.per_layer:
            v = spec.reader(m["name"])(table)
            if v is not None:
                values[m["name"]] = v
        dev = {"busy_s": table.busy_s, "window_s": table.window_s}
        breakdown = {"device_ops": table.top_ops(),
                     "idle_gaps": table.idle_gaps()}
    units = {m["name"]: m["unit"]
             for m in spec.end_to_end + spec.per_layer}
    metrics = {name: {"value": v, "unit": units[name]}
               for name, v in values.items()}

    device_info = {"platform": device.type, "kind": str(device), "count": 1}
    if device.type == "cuda":
        # every step of the window allocates alike, and the sampled steps
        # are kept by step 63, so the window's peak less what only the
        # check holds is the cell's own
        device_info = card_info(spec.chips)
        window_peak = torch.cuda.max_memory_allocated(0)
        retained = runner.retained_bytes()
        device_info["memory_peak_bytes"] = max(setup_peak,
                                               window_peak - retained)
        log(f"[{workload}] memory peak: set-up {setup_peak} B, window "
            f"{window_peak} B of which {retained} B the sampled steps "
            f"kept for the check")
    device_info.update(dev)

    samples = release(entry, runner, device)
    t_check = time.perf_counter()
    numbers, failed = check(spec, entry, samples)
    log(f"[{workload}] {len(samples)} sampled steps compared in "
        f"{time.perf_counter() - t_check:.3f} s")
    correct = all(v <= lim for v, lim in numbers.values())
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in numbers.items()}
    lines = [f"check {name} {v!r} limit {lim!r}"
             for name, (v, lim) in numbers.items()]
    return result, lines


def _profiled(runner, events, steps):
    with tracing.span("window"):
        n, _, _ = dispatch_ahead(runner, events, steps=steps)
    return n


def _traced_slice(runner, events, spec, launches, log, retakes=2):
    """The profiled dispatch-ahead slice of ``trace_steps`` steps, taken
    again (up to ``retakes`` times) when the profiler recorded fewer
    launches of a kernel than the steps made; fails after that."""
    steps = spec.traffic["trace_steps"]
    for attempt in range(1 + retakes):
        table = tracing.profile(lambda: _profiled(runner, events, steps))
        short = {}
        for kid, per_step in launches.items():
            seen = table.count(load("work", kid).KERNEL_NAMES[0])
            if seen < per_step * table.steps:
                short[kid] = (seen, per_step * table.steps)
        if not short:
            return table
        log(f"[{spec.name}] the profiler recorded fewer launches than made "
            f"(seen, made): {short}; attempt {attempt + 1}")
    raise RuntimeError(f"the profiler recorded fewer launches than the "
                       f"steps made: {short}")
