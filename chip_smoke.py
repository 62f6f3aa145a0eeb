"""
Smoke test of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version, drives the cycled
Lorenz-96 LETKF (fused RK4 forecast + fused1d analysis) at the reference
benchmark shape, checks it against the f64 eigh oracle, and times the
kernels.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1 device and kernel build     5 the cycle, 10 cycles through both kernels
  2 K2 (RK4) against plain      6 large analysis (ens 100, 2^20 columns)
  3 K1 (window) against plain   7 times (CUDA events around 10 chained
  4 fused1d against f64 eigh       calls, median of 20 such samples)
Then one JSON line with each kernel's launches, error and times, the card's
name and power limit, and last {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import tpu_assim_torch
from tpu_assim_torch import _build
from tpu_assim_torch.analysis import (
    _normalized_obs_space,
    make_cycle_step,
    make_letkf_analysis,
)
from tpu_assim_torch.convert import coord1_distance
from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.models import cuda_forecast as k2
from tpu_assim_torch.ops.cuda import letkf as k1
from tpu_assim_torch.ops.localization import GaspariCohn

SEED = 42
TOL = 1e-5          # f32 budget, relative to max|reference|
RADIUS, INF, DEGREE = 20.0, 1.1, 12
NB = 12             # window of the headline cell: exact, as it is >= the
                    # workload's in-support maximum of 8


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card():
    """``name, power.limit`` as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def build_workload(ens_size, len_grid, nr_obs, seed=SEED):
    """The reference benchmark's workload recipe (bench.py:build_workload):
    random ensemble, evenly spaced point observations, unit variances."""
    rnd = np.random.RandomState(seed)
    state = rnd.normal(size=(ens_size, len_grid)).astype("float32")
    obs_locs = np.linspace(0, len_grid, num=nr_obs, endpoint=False)
    obs_idx = np.rint(obs_locs).astype(np.int32) % len_grid
    obs_vals = rnd.normal(size=(nr_obs,)).astype("float32")
    obs_var = np.ones(nr_obs, dtype="float32")
    grid_coords = np.arange(len_grid, dtype="float32")[:, None]
    obs_coords = obs_locs.astype("float32")[:, None]
    return state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords


def exact_nb(worst, mult=4, floor=8):
    """The in-support maximum rounded up to a multiple of 4, at least 8
    (bench.py:exact_nb)."""
    return max(-(-worst // mult) * mult, floor)


def compare(out, ref, what):
    """max|out - ref| over finite entries, checked against TOL * max|ref|;
    NaN entries must coincide."""
    out, ref = out.double(), ref.double()
    nan_out, nan_ref = torch.isnan(out), torch.isnan(ref)
    check(torch.equal(nan_out, nan_ref), f"{what}: NaN entries differ")
    fin = ~nan_ref
    check(bool(torch.isfinite(out[fin]).all()), f"{what}: inf in output")
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((out[fin] - ref[fin]).abs().max())
    scale = float(ref[fin].abs().max())
    check(err <= TOL * scale,
          f"{what}: max abs err {err!r} > {TOL} * max|ref| {scale!r}")
    return err, err / scale


def window_inputs(w, dev, ns=1):
    """Kernel inputs of the fused1d analysis for workload ``w``."""
    state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = (
        torch.as_tensor(a, device=dev) for a in w)
    perts, innov = _normalized_obs_space(state[:, obs_idx.long()], obs_vals,
                                         obs_var)
    mean = state.mean(0)
    sp = state - mean
    if ns > 1:  # stacked slices: the member perturbations, shifted
        sp = torch.stack([torch.roll(sp, s, dims=1) for s in range(ns)])
        mean = torch.stack([mean + s for s in range(ns)])
    return [t.contiguous() for t in (perts, innov, obs_coords[:, 0],
                                     grid_coords[:, 0], sp, mean)]


def run_window(args, nb, taper="gc2", strict=True, plain=False):
    k = args[0].shape[0]
    reg = (k - 1) / INF
    if not plain:
        return k1.letkf_window_analysis_fused(
            *args, reg, RADIUS, k, nb=nb, degree=DEGREE, taper=taper,
            strict=strict)
    sp, mean = args[4], args[5]
    multi = sp.ndim == 3
    out = k1.window_analysis_plain(
        *args[:4], sp if multi else sp[None], mean if multi else mean[None],
        reg, RADIUS, ens_size=k, nb=nb, degree=DEGREE, epsilon=1e-5,
        taper=taper, strict=strict)
    return out if multi else out[0]


def median_ms(fn, reps=20, inner=10, warmup=3):
    """Median over ``reps`` samples of the time per call of ``inner``
    back-to-back calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def paired_ms(kernel_fn, plain_fn):
    """Per-call medians, 20 samples each, in turns plain, kernel, kernel,
    plain."""
    halves = [median_ms(plain_fn, 10), median_ms(kernel_fn, 10),
              median_ms(kernel_fn, 10), median_ms(plain_fn, 10)]
    return (halves[1] + halves[2]) / 2.0, (halves[0] + halves[3]) / 2.0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; "
                         "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gpu = card()
    kinds = {}

    # -- 1. device and build --------------------------------------------
    build_s = _build.build_all()
    for name, report in _build.BUILD_LOG.items():
        print(f"--- nvcc {name}.cu ---\n{report}", file=sys.stderr)
    log(1, f"card {gpu}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; tpu_assim_torch "
        f"{tpu_assim_torch.__version__}; kernels built and loaded in "
        f"{build_s:.2f} s")

    # -- 2. K2 against its plain version ---------------------------------
    w = build_workload(40, 10000, 1000)
    state = torch.as_tensor(w[0], device=dev)
    model, dt, n_steps = Lorenz96(), 0.05, 4
    before = k2.LAUNCHES["rk4_l96"]
    fc = k2.fused_rk4_steps(model, state, dt, n_steps)
    torch.cuda.synchronize()
    check(k2.LAUNCHES["rk4_l96"] == before + 1, "K2 launch not counted")
    err_k2, rel = compare(fc, k2.rk4_steps_plain(model, state, dt, n_steps),
                          "K2 vs plain")
    kinds["rk4_l96"] = {"max_abs_err": err_k2}
    log(2, f"K2 rk4_l96 [40, 10000] x {n_steps} steps: max abs err "
        f"{err_k2!r} (rel {rel!r})")

    # -- 3. K1 against its plain version ---------------------------------
    worst = k1.max_in_support_1d(w[5][:, 0], w[4][:, 0], RADIUS)
    check(worst <= NB, f"in-support maximum {worst} exceeds nb={NB}")
    nb = NB
    args = window_inputs(w, dev)
    before = k1.LAUNCHES["window1d"]
    out = run_window(args, nb)
    torch.cuda.synchronize()
    check(k1.LAUNCHES["window1d"] == before + 1, "K1 launch not counted")
    err_k1, rel = compare(out, run_window(args, nb, plain=True),
                          "K1 vs plain (headline)")
    kinds["window1d"] = {"max_abs_err": err_k1}
    notes = [f"headline err {err_k1!r} (rel {rel!r})"]
    for label, kw, a in (
        ("gcinf", {"taper": "gcinf"}, args),
        ("ns=3", {}, window_inputs(w, dev, ns=3)),
    ):
        e, r = compare(run_window(a, nb, **kw),
                       run_window(a, nb, plain=True, **kw), f"K1 {label}")
        notes.append(f"{label} {e!r}")
    # strict: 16 extra observations at x = 5000 overflow the nearby columns
    wc = list(w)
    wc[5] = np.sort(np.concatenate(
        [w[5][:, 0], np.full(16, 5000.25, np.float32)]))[:, None]
    wc[3] = np.rint(wc[5][:, 0]).astype(np.int32) % 10000
    wc[1] = np.random.RandomState(SEED + 1).normal(
        size=wc[5].shape[0]).astype(np.float32)
    wc[2] = np.ones(wc[5].shape[0], np.float32)
    a = window_inputs(wc, dev)
    out = run_window(a, nb)
    compare(out, run_window(a, nb, plain=True), "K1 strict overflow")
    n_nan = int(torch.isnan(out).any(0).sum())
    check(0 < n_nan < 10000, f"strict case poisons {n_nan} columns")
    notes.append(f"strict {n_nan} NaN columns identical")
    # o < nb: 5 observations for 12 slots; every observation counts once
    wf = build_workload(40, 10000, 5)
    a = window_inputs(wf, dev)
    e, _ = compare(run_window(a, nb), run_window(a, nb, plain=True),
                   "K1 o < nb")
    notes.append(f"o<nb {e!r}")
    # unsorted coordinates poison everything
    a = window_inputs(w, dev)
    a[2] = a[2].flip(0).contiguous()
    out = run_window(a, nb)
    compare(out, run_window(a, nb, plain=True), "K1 unsorted")
    check(bool(torch.isnan(out).all()), "unsorted obs must poison all")
    log(3, "K1 window1d [40, 10000], o=1000, nb=12, degree 12: "
        + "; ".join(notes))

    # -- 4. fused1d against the f64 eigh oracle --------------------------
    loc = GaspariCohn((RADIUS,), coord1_distance)
    wt = [torch.as_tensor(x, device=dev) for x in w]
    fused = make_letkf_analysis(loc, INF, method="fused1d", max_obs=nb,
                                cheb_degree=DEGREE)(*wt)
    w64 = [t.double() if t.is_floating_point() else t for t in wt]
    oracle = make_letkf_analysis(loc, INF, chunksize=1000,
                                 method="eigh")(*w64)
    _, rel_oracle = compare(fused, oracle, "fused1d vs f64 eigh")
    log(4, f"fused1d vs f64 eigh oracle: max rel err {rel_oracle!r} "
        f"(budget {TOL})")

    # -- 5. the cycle ------------------------------------------------------
    cycle = make_cycle_step(
        RK4Integrator(Lorenz96(), 0.05), 4, loc, inf_factor=INF,
        method="fused1d", max_obs=nb, cheb_degree=DEGREE,
        geometry=(w[3], w[4], w[5]))
    obs_rnd = np.random.RandomState(SEED + 2)
    obs_seq = torch.as_tensor(
        obs_rnd.normal(size=(10, w[1].shape[0])).astype(np.float32),
        device=dev)
    obs_var = wt[2]
    # plain-version cycle 1, on the card
    x_plain = k2.rk4_steps_plain(Lorenz96(), wt[0], 0.05, 4)
    plain_args = window_inputs(
        (x_plain, obs_seq[0], obs_var, w[3], w[4], w[5]), dev)
    ref1 = run_window(plain_args, nb, plain=True)
    torch.cuda.synchronize()
    k1.LAUNCHES["window1d"] = 0
    k2.LAUNCHES["rk4_l96"] = 0
    x = wt[0]
    for c in range(10):
        x = cycle(x, obs_seq[c], obs_var)
        if c == 0:
            first = x
    torch.cuda.synchronize()
    launches = {"window1d": k1.LAUNCHES["window1d"],
                "rk4_l96": k2.LAUNCHES["rk4_l96"]}
    check(launches == {"window1d": 10, "rk4_l96": 10},
          f"launches in 10 cycles: {launches}")
    check(bool(torch.isfinite(x).all()), "cycled state not finite")
    err_c1, rel = compare(first, ref1, "cycle 1 vs plain cycle")
    log(5, f"10 cycles (ens 40, grid 10000, obs 1000): finite, launches "
        f"{launches}; cycle 1 vs plain max abs err {err_c1!r}")

    # -- 6. large analysis -------------------------------------------------
    wl = build_workload(100, 1 << 20, 1 << 16)
    nb_l = exact_nb(k1.max_in_support_1d(wl[5][:, 0], wl[4][:, 0], RADIUS))
    big = make_letkf_analysis(loc, INF, method="fused1d", max_obs=nb_l,
                              cheb_degree=DEGREE,
                              geometry=(wl[3], wl[4], wl[5]))
    wlt = [torch.as_tensor(x, device=dev) for x in wl[:3]]
    out_l = big(*wlt)
    torch.cuda.synchronize()
    err_l, _ = compare(out_l, run_window(window_inputs(wl, dev), nb_l,
                                         plain=True), "large vs plain")
    del out_l
    log(6, f"large fused1d (ens 100, grid 2^20, obs 2^16, nb {nb_l}): "
        f"max abs err vs plain {err_l!r}")

    # -- 7. times ----------------------------------------------------------
    kinds["window1d"]["ms"], kinds["window1d"]["plain_ms"] = paired_ms(
        lambda: run_window(args, nb), lambda: run_window(args, nb,
                                                         plain=True))
    kinds["rk4_l96"]["ms"], kinds["rk4_l96"]["plain_ms"] = paired_ms(
        lambda: k2.fused_rk4_steps(model, state, dt, n_steps),
        lambda: k2.rk4_steps_plain(model, state, dt, n_steps))
    analyse = make_letkf_analysis(loc, INF, method="fused1d", max_obs=nb,
                                  cheb_degree=DEGREE,
                                  geometry=(w[3], w[4], w[5]))
    chain = [wt[0], wt[0]]

    def next_analysis():
        chain[0] = analyse(chain[0], *wt[1:3])

    def next_cycle():
        chain[1] = cycle(chain[1], obs_seq[0], obs_var)

    ms_analysis = median_ms(next_analysis)
    nb_bench = exact_nb(worst)
    ms_k1_bench = median_ms(lambda: run_window(args, nb_bench))
    ms_cycle = median_ms(next_cycle)
    for name, t in kinds.items():
        log(7, f"{name}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} ms "
            f"[{gpu}]")
    log(7, f"window1d at nb={nb_bench} (bench.py's exact_nb): kernel "
        f"{ms_k1_bench!r} ms [{gpu}]")
    log(7, f"fused1d analysis {ms_analysis!r} ms/analysis "
        f"({10000 / ms_analysis * 1e3!r} grid-points/s); cycle "
        f"{ms_cycle!r} ms ({1e3 / ms_cycle!r} cycles/s) [{gpu}]")

    sources = {
        "window1d": ("tpu_assim_torch/csrc/letkf_window1d.cu",
                     "tpu_assim/ops/pallas/letkf.py:831"),
        "rk4_l96": ("tpu_assim_torch/csrc/rk4_l96.cu",
                    "tpu_assim/models/pallas_forecast.py:59"),
    }
    print(gpu)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"]}
        for name, t in kinds.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke.py finished in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
