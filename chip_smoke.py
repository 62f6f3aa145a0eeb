"""
Smoke test of the PyTorch/CUDA port on one GPU: builds the hand-written
kernels, holds each against its plain PyTorch version, drives the cycled
Lorenz-96 LETKF (fused RK4 forecast + fused1d analysis), the driver entry
points (tpu_assim_torch.entry) and the cycle sharded over members x grid
on 8 virtual shards of the card and across two processes, the localized
IEnKS smoother (Jacobi SVD + fused RK4) as a step, grid-sharded over 8
virtual shards of the card and across two processes, and through its class
API, with its gradient through both kernels, the neighborhood solvers (cheb,
pallas), the LETKF class API, the 2-D LETKF (fused2d and its x-strips), the
localized kernelized ETKF (two-sided Jacobi eigh) and the obs-sharded halo
LETKF over 8 virtual shards of the card (halo exchange kernel K8), also
across two processes (K8 over CUDA IPC), and the TerrSysMP (COSMO/CLM)
adapters at COSMO-DE width at the reference benchmark shapes, checks them
against f64 oracles, and times the kernels.

    python3 chip_smoke.py

(With a worker flag, ``--phase30-worker``, ``--phase30-nccl`` or
``--loader-passes``, it is one of phase 30's children.)

Phases (one line each; any failure exits non-zero):
  1 device and kernel build     7 times (CUDA events around 10 chained
  2 K2 (RK4) against plain, bit    calls, median of 20 such samples)
    for bit: g 4 to 2^16 + 3,
    n_steps 0 to 9, a NaN; its
    gradient against plain's
  3 K1 (window) against plain,  8 K3 (Jacobi SVD) against plain
    nb 1 to 72                  9 eigh LETKF with max_obs through K3
  4 fused1d against f64 eigh
  5 the cycle, 10 cycles        10 the localized IEnKS (bench config 9)
     through both kernels          against its f64 step
  6 large analysis (ens 100,    11 times of K3 and of the IEnKS step, with
     2^20 columns)                 K3 and with LAPACK
 12 K4 (cheb) against plain,    15 the class API: LETKF.assimilate through
    nb 1 to 72                     K4 (filter, smoother) and K1 (smoother)
 13 K5 (Newton-Schulz) against     against f64 eigh
    plain, [10^4, 12, 40] and
    [256, nb, k], nb 1 to 48
 14 cheb and pallas analyses    16 times of K4, K5 and the class API
    against f64 eigh
 17 K6 (2-D window) against     19 bench config 8 (1024 x 1024, 10^5 obs,
    plain at bench config 7        16 strips): K6 against plain, the strip
    (128 x 128, 1024 obs)          analysis on sampled columns and the
 18 fused2d at config 7            class API (auto strips; smoother at
    against f64 eigh               config 7) against f64 eigh
 20 times of K6 and of the 2-D analyses
 21 K7 (two-sided Jacobi eigh)     23 the class API: LKETKF.assimilate
    against plain, bit for bit,       (twosided: 3 K7 launches), a cheb
    on [10^4, 40, 40] batches of      smoother, KETKF (config 4), and
    seven kinds
 22 bench config 11 (LKETKF,          MultiplicativeInflation around
    Gauss l=2, window): eigh via      LKETKF, against f64
    K3, via K7, Tanh via K7, cheb  24 times of K7 (also alone, and at
    against f64                       [4096, 40, 40]) and of the config-11
                                      analyses; a torch.profiler window
 25 K8 (halo exchange) against     26 the halo analyses on 8 virtual
    plain, bit for bit: config-3      shards: config 3 windowed (K1) and
    shape, rings of 2 and 3, f64,     top-k through K8 + K4 (rdma equal
    an unaligned row                  to ppermute), config 7 on a 2 x 4
 27 times of K8 (config 3 and         tile mesh (K6), against f64 eigh
    [103, 8192] x 8 shards) and
    of the halo analyses
 28 the smoother classes at config 9 (run after phase 11, with its f64
    oracle): LocalizedIEnKSTransform and LocalizedIEnKSBundle through K2
    and K3 (2 + 12 launches in chunks of 4096, 2 + 4 unchunked) against
    the functional step and its f64 oracle; K3's gradient against
    torch.linalg.svd's in f64; the class smoother's gradient through K2
    and K3 against f64; times of the class call and of its backward,
    torch.profiler windows of the class call and the functional step
 29 the differentiable path (after 27): K1, K4 and K6 through their
    autograd.Functions at the main path's shapes (the headline, config
    7), each gradient of sum(out * c) against the plain version's on the
    card (f32: the backward is its replay) and in f64, one launch a
    forward and none a backward, times; the learn-inflation loss
    (examples/torch_learn_inflation.py) at full width, 4 cycles through K2
    x 4 and K1 x 4: d loss / d log_rho against f64 central differences,
    the initial ensemble's gradient against f64, 5 descent steps, times,
    peak memory, a profiler window; eigh with max_obs through K3: its
    gradients against f64 (CPU); K5, K7 and K8 raise on a gradient
 30 the halo LETKF across processes (after 29): two children of this
    script share the card over gloo, 4 virtual shards each, and run
    phase 26's config-3 window (K1, 4 launches a process), top-k
    ppermute (K4, 4) and top-k rdma (K8 over CUDA IPC + K4, 1 + 4)
    analyses from their own blocks and from whole tensors, each bit for
    bit phase 26's, rdma ppermute's; a profiler window of each top-k call
    (no device-to-host copy in rdma's); K8's exchange alone across them
    at config 3 and [103, 8192] x 8 (device time, bound) and both calls
    and exchanges timed in turns between barriers; comm="rdma" raises on
    both once they claim two hosts; their
    DCP weight checkpoint loads whole equal to one process's; phase 32's
    sharded smoother over the 2 x 4 shards, both kinds, from blocks and
    from whole tensors, bit for bit phase 32's (K2 x 8, K3 x 16 a
    process), a step timed between barriers; phase 33(c)'s members x grid
    cycle over a 2 x 4 mesh whose owners split by grid half (the ring
    halo, the model equivalents and the re-split cross the processes),
    from blocks and from whole tensors, bit for bit phase 33's (K2 x 4,
    K3 x 4 a process), a step timed between barriers; a child's
    NCCL world of one (process_info, mesh, both analyses as phase 26's;
    by default the mesh and process_info keep every card it sees);
    the native obs loader (built, repaired) feeds 6 config-3 files at
    depth 3 through the window analysis, and a child makes 200 passes;
    each child under a hard time limit; times of 2 processes and of 1
 31 TerrSysMP at COSMO-DE width: 461 x 421 columns x vgrid 19 (11 levels,
    8 soil layers), ens 40, 500 T2m stations: preprocess_cosmo, the class
    LETKF (cheb, top-k, K4 once a chunk of 65536) with CosmoT2mOperator and
    a horizontal GC taper, postprocess_cosmo; NaN exactly at the vgrid
    padding, 4096 columns against f64 eigh, the COSMO and CLM round trips
    the identity; host times
 32 (after 29, before 30) the grid-sharded localized IEnKS at bench config
    9 over 8 virtual shards of the card (1250 columns each), transform and
    bundle: K2 x 16 and K3 x 32 a step, against phase 10's unsharded step
    (1e-6 of max, the same NaN columns; whether bit for bit) and the
    transform against its f64 step (1e-5); times in turns with the
    unsharded step, torch.profiler windows of both and the host's launches
    a step; whether a batched matrix-vector product of the inner step's
    shape is the same in 8 batches of 1250 as in one of 10^4, through
    cuBLAS's gemv (printed) and through ienks._matvec (checked)
 33 (after 32, before 30) the driver entry points: (a) entry() on the
    card (K2 x 1, K3 x 1) against its f64 step; (b) dryrun_multichip(8)
    over 8 virtual shards of the card, every check of it (the members x
    grid step against the unsharded one, top-k rdma (K8) bit for bit
    ppermute, the window (K1) within 1e-3 of top-k, the sharded IEnKS,
    the 2-D halo); (c) bench config 6's workload through the members x
    grid sharded cycle over a 2 x 4 mesh of virtual shards (K2 x 8 on
    [20, 2500 + 48] segments, K3 x 8 on [1250, 40, 40]) against the
    unsharded make_cycle_step (1e-6 of max, the same NaN columns; whether
    bit for bit) and its f64 step (1e-5); times in turns with the
    unsharded step, torch.profiler windows and the host's launches a step
Phase 1 also prints each K1, K2, K3, K4, K5, K6 and K7 kernel's
registers, shared memory and spills (nvcc -Xptxas -v) and fails on a
spill of K1's or K4's register route, of K2, of K5, of K6's register
route or of any K7 instance; phases 3, 12 and 13 run K1, K4 and K5 on both of their routes
(register, shared) and at every packing of their warps, each case with a
NaN column among healthy packed ones, phase 17 K6 on both of its routes,
each case with its route; phases 7 and 16 also give K1's, K2's and K4's
device time by torch.profiler and torch.profiler windows of the fused1d
analysis, the cycle and the pallas analysis.
Then the card's name and power limit, one JSON line with each kernel's
launches, error, times and bound, and last {"ok": true, "device": {...}}.
In that line ``ms`` is the time a call between CUDA events (phases 7, 11,
16, 20, 24; K8's is its device time, phase 27), and ``device_ms`` the
kernel's own device time by torch.profiler where it is taken (K1, K2,
K4, K8), else null.
Imports nothing of JAX.
"""

import json
import os
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import tpu_assim_torch
from tpu_assim_torch import _build
from tpu_assim_torch import entry as driver
from tpu_assim_torch.analysis import (
    _forecast,
    _normalized_obs_space,
    _strip_inputs_2d,
    _strip_plan_2d,
    _with_time,
    make_cycle_step,
    make_letkf_analysis,
    make_lienks_step,
    make_strip_letkf_2d,
)
from tpu_assim_torch import (
    KETKF,
    LETKF,
    LKETKF,
    EnsembleState,
    LocalizedIEnKSBundle,
    LocalizedIEnKSTransform,
    Observation,
)
from tpu_assim_torch.convert import coord1_distance
from tpu_assim_torch.interface import lketkf as lk
from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.obs_ops import IdentityOperator
from tpu_assim_torch.models import cuda_forecast as k2
from tpu_assim_torch.ops import ienks
from tpu_assim_torch.ops.cuda import jacobi as k7
from tpu_assim_torch.ops.cuda import letkf as k1
from tpu_assim_torch.ops.cuda import svd as k3
from tpu_assim_torch.ops.kernels import GaussKernel, TanhKernel
from tpu_assim_torch.ops.ketkf import center_gram
from tpu_assim_torch.ops.linalg import (
    rev_evd,
    rev_svd,
    set_jacobi_dispatch,
    svd,
)
from tpu_assim_torch.ops.localization import (
    GaspariCohn,
    neighborhood_select_window,
    safe_sqrt_keep_nan,
)
from tpu_assim_torch.models.terrsysmp import (
    postprocess_clm,
    postprocess_cosmo,
    preprocess_clm,
    preprocess_cosmo,
)
from tpu_assim_torch.obs_ops.terrsysmp import CosmoT2mOperator
from tpu_assim_torch.ops.etkf import letkf_weights_dense
from tpu_assim_torch.parallel import cuda_halo as k8
from tpu_assim_torch.parallel import (
    make_forecast_analysis_mesh,
    make_grid_mesh,
    multihost,
)
from tpu_assim_torch.parallel.forecast import sharded_cycle_step
from tpu_assim_torch.parallel import (
    sharded_letkf_weights,
    sharded_lienks_step,
)
from tpu_assim_torch.parallel.halo import (
    _halo_max_in_support,
    halo_letkf_analysis,
    halo_letkf_analysis_2d,
    halo_width_for,
    shard_observations,
    shard_observations_2d,
)
from tpu_assim_torch.parallel.mesh import Mesh
from tpu_assim_torch.runtime import native, obs_pipeline
from tpu_assim_torch.transform import MultiplicativeInflation
from tpu_assim_torch.utils.checkpoint import (
    load_weights_sharded,
    save_weights_sharded,
)

SEED = 42
TOL = 1e-5          # f32 budget, relative to max|reference|
RADIUS, INF, DEGREE = 20.0, 1.1, 12
NB = 12             # window of the headline cell: exact, as it is >= the
                    # workload's in-support maximum of 8
FACTOR_TOL = 1e-4   # K3: reconstruction (relative to max|A|) and
                    # orthogonality max|Q^T Q - I|
PALLAS_TOL = 2e-4   # method="pallas" against the f64 oracle: the JAX
                    # package's bound for K5 (tests/test_etkf_core.py:363)
NS_ITERS = 25       # make_letkf_analysis's default newton_iters
R2 = 4.0            # GC radius in x and in y of bench configs 7 and 8
L11 = 2.0           # Gauss kernel lengthscale of bench configs 4 and 11
SWEEPS = 7          # K7's sweep cap in eigh_psd's twosided dispatch
GRAD_TOL = 1e-4     # K3's gradient against f64 on a spread spectrum,
                    # relative to max|reference| (f32 rounding: ~7e-6)
SMOOTHER_GRAD_TOL = 1e-3  # the class smoother's f32 gradient against f64,
                          # relative to max|reference|
K1_KERNELS = ("window1d", "check_sorted")  # the kernels of a K1 call
# The least time of a kernel's work on an H100 SXM (its published peak
# rates): its bytes at the HBM rate, its FLOPs at the f32 rate outside the
# tensor cores (the kernels compute in f32 without them).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound(n_bytes, flops):
    """``(ms, "bytes" or "operations")``: the larger of ``n_bytes`` at the
    HBM rate and ``flops`` at the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cheb_flops(k, nb, ns, degree):
    """FLOPs of one column's Chebyshev solve and apply
    (csrc/cheb_core.cuh): the symmetric Gram matrix (nb (nb + 1) / 2
    entries of k multiply-adds), u_i = Zh sp_i, the degree + 1 Clenshaw
    steps over 1 + ns operands (a matvec and 5 FLOPs per entry), the
    apply."""
    return (nb * (nb + 1) * k + 2 * ns * nb * k
            + (degree + 1) * (1 + ns) * nb * (2 * nb + 5)
            + ns * k * (4 * nb + 4))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def resources_note():
    """Registers, static shared memory and spills of every kernel that the
    K1, K2, K3, K4, K5, K6 and K7 sources built, as nvcc -Xptxas -v reports
    them; for K6's register route and K5's at nb = NB also the warps an SM
    holds at that register count (4 warps a block); K1's and K4's register
    routes (NBC = 4..64), K5's (NB = 1..32) and K7's 32 instances (Kp =
    2..64) as registers by size, K1 and K4 at NBC = NB, K5 at NB and
    K7 at Kp = 40 in full; K2 with the warps an SM holds (blocks of 4
    warps). Fails on any spill of K1's or K4's register route, of K2, of
    K5, of K6's register route or of K7."""
    notes = []
    for src in ("rk4_l96", "letkf_window1d", "letkf_nbh_cheb", "svd_jacobi",
                "letkf_nbh_ns", "letkf_window2d", "eigh_jacobi"):
        by_size = {}
        for name, regs, smem, st, ld in _build.kernel_resources(
                _build.ptxas_report(src)):
            note = (f"{name} {regs} registers, {smem} B static smem, spills "
                    f"{st} B stored / {ld} B loaded")
            if name.startswith(("window1d_reg_kernel", "nbh_cheb_reg_kernel")):
                check(st == 0 and ld == 0,
                      f"K1/K4 register route spills: {note}")
                by_size[int(name.split("<")[1].rstrip(">"))] = regs
                if not name.endswith(f"<{NB}>"):
                    continue
                blocks = 65536 // (-(-regs // 8) * 8 * 32 * k1.CHEB_MAX_WARPS)
                note += (f" ({blocks * k1.CHEB_MAX_WARPS} warps/SM by "
                         f"registers)")
            if name.startswith("rk4_l96_kernel"):
                check(st == 0 and ld == 0, f"K2 spills: {note}")
                note += (f" ({min(65536 // (-(-regs // 8) * 8 * 32), 64)} "
                         f"warps/SM by registers)")
            if name.startswith("window2d_reg_kernel"):
                check(st == 0 and ld == 0,
                      f"K6 register route spills: {note}")
                blocks = 65536 // (-(-regs // 8) * 8 * 32 * k1.K6_REG_WARPS)
                note += f" ({blocks * k1.K6_REG_WARPS} warps/SM by registers)"
            if name.startswith("nbh_ns_"):
                check(st == 0 and ld == 0, f"K5 spills: {note}")
            if name.startswith("nbh_ns_reg_kernel"):
                by_size[int(name.split("<")[1].rstrip(">"))] = regs
                if name != f"nbh_ns_reg_kernel<{NB}>":
                    continue
                blocks = 65536 // (-(-regs // 8) * 8 * 32 * k1.K5_MAX_WARPS)
                note += (f" ({min(blocks * k1.K5_MAX_WARPS, 64)} warps/SM by "
                         f"registers)")
            if name.startswith("eigh_jacobi_kernel"):
                check(st == 0 and ld == 0, f"K7 spills: {note}")
                by_size[int(name.split("<")[1].rstrip(">"))] = regs
                if name != "eigh_jacobi_kernel<40>":
                    continue
                note += (f" ({65536 // (-(-regs // 8) * 8 * 32)} warps/SM by "
                         f"registers)")
            notes.append(note)
        if by_size:
            label = {"letkf_window1d": "K1 registers by NBC ",
                     "letkf_nbh_cheb": "K4 registers by NBC ",
                     "letkf_nbh_ns": "K5 registers by NB "}.get(
                         src, "K7 registers by Kp ")
            notes.append(label + ", ".join(
                f"{n}: {r}" for n, r in sorted(by_size.items()))
                + " (no spill)")
    return "; ".join(notes)


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


def same_bits(out, ref, what):
    """Checks that ``out`` equals ``ref`` wherever ``ref`` is not NaN and
    is NaN where it is; returns max|out - ref| there (0.0)."""
    nan = torch.isnan(ref)
    check(torch.equal(torch.isnan(out), nan), f"{what}: NaN entries differ")
    check(torch.equal(out[~nan], ref[~nan]), f"{what}: not bit for bit")
    return float((out[~nan].double() - ref[~nan].double()).abs().max()) \
        if bool((~nan).any()) else 0.0


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


def nbh_inputs(loc, wt, nb, ns=1):
    """K4's inputs for workload tensors ``wt``: the strict window
    neighborhoods of ``nb`` observations, sqrt-weight scaled as
    ``make_letkf_analysis(method="cheb")`` scales them, and ``ns`` stacked
    state slices (the member perturbations, shifted)."""
    state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = wt
    perts, innov = _normalized_obs_space(state[:, obs_idx.long()], obs_vals,
                                         obs_var)
    idx, w_nbh = neighborhood_select_window(
        loc, _with_time(grid_coords), _with_time(obs_coords), nb)
    sw = safe_sqrt_keep_nan(w_nbh)
    zh = perts[:, idx].permute(2, 0, 1) * sw.T[:, None, :]      # [nb, k, g]
    yh = innov[idx].T * sw.T                                    # [nb, g]
    mean = state.mean(0)
    sp = state - mean
    sp = torch.stack([torch.roll(sp, s, dims=1) for s in range(ns)])
    mean = torch.stack([mean + s for s in range(ns)])
    return [t.contiguous() for t in (zh, yh, sp, mean)]


def ns_inputs(args):
    """K5's layout [g, nb, k], [g, nb], [g, k], [g] of K4's inputs (first
    state slice)."""
    zh, yh, sp, mean = args
    return [t.contiguous() for t in (zh.permute(2, 0, 1), yh.T, sp[0].T,
                                     mean[0])]


def ns_random(dev, g, nb, seed, k=40):
    """K5's inputs [g, nb, k], [g, nb], [g, k], [g] from a seed: weights
    uniform in [0, 1), perturbations and innovations standard normal."""
    rng = np.random.RandomState(seed)
    sw = np.sqrt(rng.rand(g, nb))
    arrays = (rng.normal(size=(g, nb, k)) * sw[:, :, None],
              rng.normal(size=(g, nb)) * sw, rng.normal(size=(g, k)),
              rng.normal(size=g))
    return [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in arrays]


def window_random(dev, g, o, seed, k=40):
    """K1's inputs on a grid of ``g`` columns from a seed: ``o`` sorted
    observation coordinates uniform on [0, g), perturbations, innovations,
    state perturbations [k, g] and means standard normal."""
    rng = np.random.RandomState(seed)
    arrays = (rng.normal(size=(k, o)), rng.normal(size=o),
              np.sort(rng.uniform(0, g, size=o)), np.arange(g),
              rng.normal(size=(k, g)), rng.normal(size=g))
    return [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in arrays]


def with_nans(args, col, obs):
    """K1's inputs with one column's state perturbation and one
    observation's perturbations NaN: the first reaches that column's u and
    analysis alone, the second the Gram matrix of every column whose window
    holds it."""
    out = [a.clone() for a in args]
    out[4][0, col] = float("nan")
    out[0][:, obs] = float("nan")
    return out


def cheb_random(dev, g, nb, ns, seed, k=40):
    """K4's inputs [nb, k, g], [nb, g], [ns, k, g], [ns, g] from a seed:
    weights uniform in [0, 1), perturbations and innovations standard
    normal."""
    rng = np.random.RandomState(seed)
    sw = np.sqrt(rng.rand(nb, g))
    arrays = (rng.normal(size=(nb, k, g)) * sw[:, None, :],
              rng.normal(size=(nb, g)) * sw, rng.normal(size=(ns, k, g)),
              rng.normal(size=(ns, g)))
    return [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in arrays]


def nan_columns(out):
    """Whether each column [g] of an analysis [.., k, g] holds a NaN."""
    return torch.isnan(out).reshape(-1, out.shape[-1]).any(0)


def run_cheb(args, degree, plain=False):
    k = args[0].shape[1]
    fn = k1.nbh_cheb_plain if plain else k1.letkf_nbh_analysis_cheb
    return fn(*args, (k - 1) / INF, k, degree)


def run_ns(args, iters, plain=False):
    k = args[0].shape[2]
    fn = k1.nbh_fused_plain if plain else k1.letkf_nbh_analysis_fused
    return fn(*args, (k - 1) / INF, k, iters)


def jacobi_sweeps(a):
    """The sweeps K3 runs on ``a`` before no matrix rotates any more: the
    smallest cap whose singular values equal those under the cap of 20."""
    full = k3.svd_jacobi(a)[1]
    for sweeps in range(1, 21):
        if torch.equal(k3.svd_jacobi(a, sweeps)[1], full):
            return sweeps
    return 20


def counted(fn, *args):
    """``fn(*args)`` with every kernel's launch count set to 0 just before;
    returns the result and the counts read just after, those of 0
    left out."""
    tables = (k1.LAUNCHES, k2.LAUNCHES, k3.LAUNCHES, k7.LAUNCHES,
              k8.LAUNCHES)
    for table in tables:
        for name in table:
            table[name] = 0
    out = fn(*args)
    torch.cuda.synchronize()
    counts = {n: c for table in tables for n, c in table.items()}
    return out, {n: c for n, c in counts.items() if c}


def svd_vs_plain(a, label):
    """K3 against its plain version on one batch: exactly one counted
    launch, identical NaN entries, s within TOL of max|s_plain|; on the
    matrices without NaN, reconstruction and orthogonality of U and V
    within FACTOR_TOL. Returns (max abs error of s, kernel factors, plain
    factors)."""
    before = k3.LAUNCHES["svd_jacobi"]
    out = k3.svd_jacobi(a)
    torch.cuda.synchronize()
    check(k3.LAUNCHES["svd_jacobi"] == before + 1,
          f"{label}: K3 launches {k3.LAUNCHES['svd_jacobi'] - before}")
    ref = k3.svd_jacobi_plain(a)
    for x, y, name in zip(out, ref, "usv"):
        check(torch.equal(torch.isnan(x), torch.isnan(y)),
              f"{label}: NaN entries of {name} differ")
    err_s, _ = compare(out[1], ref[1], f"{label}: s")
    u, s, v = (x[torch.isfinite(out[1]).all(-1)] for x in out)
    a_ok = a[torch.isfinite(out[1]).all(-1)]
    rec = float((rev_svd(u, s, v) - a_ok).abs().max() / a_ok.abs().max())
    eye = torch.eye(a.shape[-1], device=a.device)
    orth = max(float((q.mT @ q - eye).abs().max()) for q in (u, v))
    check(rec <= FACTOR_TOL and orth <= FACTOR_TOL,
          f"{label}: reconstruction {rec!r}, orthogonality {orth!r}")
    return err_s, out, ref


def ienks_compositions(u, s, v, k):
    """The sign-invariant compositions the IEnKS steps take of an SVD
    (ops/ienks.py): W'^{-T}, the precision, the covariance and the
    square-root weights."""
    return (rev_svd(u, 1.0 / s, v), rev_svd(u, 1.0 / (s * s), u),
            rev_svd(u, torch.sqrt((k - 1) / s), v))


def svd_inputs(step, args):
    """The batches one call of ``step`` hands to the IEnKS steps' SVD, in
    order (two per outer iteration)."""
    seen = []
    svd = ienks.svd

    def spy(t, *rest, **kw):
        seen.append(t.clone())
        return svd(t, *rest, **kw)

    ienks.svd = spy
    try:
        step(*args)
    finally:
        ienks.svd = svd
    return seen


def sigma_span_batch(rng, b, k, span):
    """``b`` random K x K matrices with singular values log-spaced over
    ``span``."""
    q1 = np.linalg.qr(rng.normal(size=(b, k, k)))[0]
    q2 = np.linalg.qr(rng.normal(size=(b, k, k)))[0]
    return np.einsum("bik,k,bjk->bij", q1, np.logspace(0, -np.log10(span), k),
                     q2).astype(np.float32)


def event_ms(fn, reps=3, warmup=1):
    """Median of ``reps`` single calls between two CUDA events, after
    ``warmup`` calls: for calls that take a second or more."""
    return median_ms(fn, reps=reps, inner=1, warmup=warmup)


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


def device_profile(fn, calls=5, retakes=2):
    """One torch.profiler window (CUDA activity) over ``calls`` calls of
    ``fn`` after a warm-up call: ``(wall ms per call, device ms per call,
    [(kernel, device ms per call, launches recorded), ...] largest
    first)``. The device time is the sum of the kernels' own times, so 1 -
    device / wall is the device's idle share in the window. A window that
    records no device activity at all (torch.profiler has returned one
    after many others) is taken again, up to ``retakes`` times (0 where
    ``fn`` is a collective of several processes, which must call it
    alike); one that records fewer launches than were made (it has, late
    in a long run) shows in the counts."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(1 + retakes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / calls
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            rows.append((e.key, us / 1e3 / calls, e.count))
        if rows:
            break
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows


def profile_note(label, fn, calls=5):
    wall, busy, rows = device_profile(fn, calls)
    check(busy > 0, f"profile {label}: no device time recorded")
    top = ", ".join(f"{name[:48]} {ms!r}" for name, ms, _ in rows[:5])
    return (f"{label}: wall {wall!r} ms/call, device {busy!r} ms/call (idle "
            f"{1 - busy / wall:.1%}); kernels, ms/call: {top}")


def kernel_profile(label, fn, keys, calls=5, wall_ms=None):
    """One torch.profiler window of ``fn`` (``device_profile``): the note
    of its wall and device time per call, idle share and the time and share
    of the kernels whose names hold one of ``keys`` (a tuple of names),
    each launched once a call; and that kernel time a call, from the mean
    time of the launches recorded (the window may miss some). With
    ``wall_ms``, the call's time measured without the profiler (whose
    tracing lengthens short calls several times), the note also gives the
    idle share against it."""
    wall, busy, rows = device_profile(fn, calls)
    check(busy > 0, f"profile of {label}: no device time")
    own = [(ms * calls / n, n) for name, ms, n in rows
           if any(key in name for key in keys)]
    mine = sum(ms for ms, _ in own)
    check(mine > 0, f"profile of {label}: no {keys} kernel")
    recorded = "/".join(str(n) for _, n in own)
    top = ", ".join(f"{name[:48]} {ms!r}" for name, ms, _ in rows[:5])
    unprofiled = ("" if wall_ms is None else
                  f"; {1 - busy / wall_ms:.1%} of the {wall_ms!r} ms a call "
                  f"takes unprofiled")
    return (f"{label} (torch.profiler, {calls} calls): wall {wall!r} ms/call, "
            f"device {busy!r} ms/call (idle {1 - busy / wall:.1%}"
            f"{unprofiled}), "
            f"{'/'.join(keys)} {mine!r} ms/call ({mine / busy:.1%} of device "
            f"time; launches recorded {recorded} of {calls}); kernels, "
            f"ms/call: {top}"), mine


def paired_ms(kernel_fn, plain_fn, plain_time=None, kernel_time=None):
    """Per-call medians, 20 samples each, in turns plain, kernel, kernel,
    plain; ``plain_time`` and ``kernel_time`` (default ``median_ms`` over
    10 samples) time a half."""
    plain_time = plain_time or (lambda fn: median_ms(fn, 10))
    kernel_time = kernel_time or (lambda fn: median_ms(fn, 10))
    halves = [plain_time(plain_fn), kernel_time(kernel_fn),
              kernel_time(kernel_fn), plain_time(plain_fn)]
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
    log(1, "nvcc -Xptxas -v: " + resources_note())

    # -- 2. K2 against its plain version, bit for bit --------------------
    w = build_workload(40, 10000, 1000)
    state = torch.as_tensor(w[0], device=dev)
    model, dt, n_steps = Lorenz96(), 0.05, 4
    rng2 = np.random.RandomState(SEED + 30)
    # (shape, steps, a NaN in row 7): the headline, rows shorter than a
    # tile and at its edges, longer than the old kernel's shared-memory
    # cap, a stacked state, launches of n_steps beyond MAX_STEPS
    cases = [((40, 10000), n_steps, False)] + [
        ((rows, g), n_steps, False)
        for g in (4, 5, 37, 208, 209, 19371, 2 ** 16 + 3)
        for rows in (40, 1)] + [((2, 3, 40, 256), n_steps, False)] + [
        ((40, 10000), n, False) for n in (0, 1, 5, 9)] + [
        ((40, 10000), n_steps, True)]
    notes, err_k2 = [], 0.0
    for shape, n, nan in cases:
        x = (state if shape == (40, 10000) and not nan else torch.as_tensor(
            rng2.normal(size=shape).astype(np.float32), device=dev))
        if nan:
            x[7, 1234] = float("nan")
        plan = k2.rk4_plan(shape[-1], n)
        before = k2.LAUNCHES["rk4_l96"]
        out = k2.fused_rk4_steps(model, x, dt, n)
        torch.cuda.synchronize()
        check(k2.LAUNCHES["rk4_l96"] == before + plan.launches,
              f"K2 {shape} x {n}: {k2.LAUNCHES['rk4_l96'] - before} "
              f"launches counted, the plan makes {plan.launches}")
        err_k2 = max(err_k2, same_bits(
            out, k2.rk4_steps_plain(model, x, dt, n), f"K2 {shape} x {n}"))
        if nan:
            bad = int(torch.isnan(out).sum())
            check(1 < bad < 10000, f"K2: the NaN spread to {bad} points")
            notes.append(f"a NaN in row 7: {bad} NaN points, as plain")
        else:
            notes.append(f"{list(shape)} x {n} ({plan.launches} launches, "
                         f"{plan.tiles} tiles a row)")
    kinds["rk4_l96"] = {"max_abs_err": err_k2}
    xg = state.clone().requires_grad_()
    ct = torch.as_tensor(rng2.normal(size=(40, 10000)).astype(np.float32),
                         device=dev)
    before = k2.LAUNCHES["rk4_l96"]
    (grad_k2,) = torch.autograd.grad(
        k2.fused_rk4_steps(model, xg, dt, n_steps), xg, ct)
    torch.cuda.synchronize()
    check(k2.LAUNCHES["rk4_l96"] == before + 1,
          "K2's Function launched no kernel")
    (grad_plain,) = torch.autograd.grad(
        k2.rk4_steps_plain(model, xg, dt, n_steps), xg, ct)
    same_bits(grad_k2, grad_plain, "K2 gradient")
    log(2, f"K2 rk4_l96 bit for bit its plain version (max abs err "
        f"{err_k2!r}): " + "; ".join(notes) + f"; the gradient through its "
        f"Function at [40, 10000] x {n_steps}: bit for bit the plain "
        f"version's")

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
    # both routes and every packing (window1d_plan's columns a warp),
    # truncating windows; column 5's NaN state perturbation sits
    # packed beside healthy columns, and the NaN perturbations of one
    # observation poison the Gram matrices of a run of columns
    cases = (("[40, 10^4]", with_nans(args, 5, 500), RADIUS),
             ("[40, 45] o 96", with_nans(
                 window_random(dev, 45, 96, SEED + 20), 5, 95), 1.5))
    for nb_c in (1, 4, 8, 12, 16, 17, 32, 36, 64, 72):
        plan = k1.window1d_plan(40, nb_c, 1, DEGREE, 10000)
        errs, most_nan = [], 0
        for label, a, radius in cases:
            sp, mean = a[4][None], a[5][None]
            kw = dict(nb=nb_c, degree=DEGREE, strict=False)
            before = k1.LAUNCHES["window1d"]
            out = k1.letkf_window_analysis_fused(*a[:4], sp, mean, 39 / INF,
                                                 radius, 40, **kw)
            torch.cuda.synchronize()
            check(k1.LAUNCHES["window1d"] == before + 1,
                  "K1 launch not counted")
            e, rel = compare(out, k1.window_analysis_plain(
                *a[:4], sp, mean, 39 / INF, radius, ens_size=40,
                epsilon=1e-5, taper="gc2", **kw), f"K1 {label} nb {nb_c}")
            bad = nan_columns(out)
            check(bool(bad[5]) and not bool(bad[4]) and not bool(bad[6])
                  and int(bad.sum()) < bad.numel(),
                  f"K1 {label} nb {nb_c}: {int(bad.sum())} NaN columns, "
                  f"columns 4-6 {bad[4:7].tolist()}")
            most_nan = max(most_nan, int(bad.sum()))
            err_k1 = max(err_k1, e)
            errs.append(f"{label} {e!r} (rel {rel!r}, {int(bad.sum())} NaN "
                        f"columns)")
        check(most_nan > 1, f"K1 nb {nb_c}: no window held the NaN "
              f"observation")
        notes.append(f"nb {nb_c} ({plan['route']}, {plan['cols_per_warp']} a "
                     f"warp): " + ", ".join(errs))
    kinds["window1d"]["max_abs_err"] = err_k1
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
    # inputs read once, the output (the size of sp) written once
    kinds["window1d"]["bound"] = bound(
        nbytes(*args) + nbytes(args[4]),
        args[3].numel() * cheb_flops(40, nb, 1, DEGREE))
    kinds["rk4_l96"]["bound"] = bound(2 * nbytes(state),
                                      n_steps * state.numel() * 31)
    for name, t in kinds.items():
        log(7, f"{name}: kernel {t['ms']!r} ms (CUDA events), plain "
            f"{t['plain_ms']!r} ms, bound {t['bound'][0]!r} ms "
            f"({t['bound'][1]}), {t['ms'] / t['bound'][0]:.1f}x [{gpu}]")
    bound_bench = bound(nbytes(*args) + nbytes(args[4]),
                        args[3].numel() * cheb_flops(40, nb_bench, 1, DEGREE))
    log(7, f"window1d at nb={nb_bench} (bench.py's exact_nb): kernel "
        f"{ms_k1_bench!r} ms (CUDA events), bound {bound_bench[0]!r} ms "
        f"({bound_bench[1]}), {ms_k1_bench / bound_bench[0]:.1f}x [{gpu}]")
    # K1's own device time, its sortedness check included: its calls
    # between CUDA events carry the wrapper's host time, which can be
    # longer; the kernels line gives it as device_ms beside ms
    for nb_t, b in ((nb, kinds["window1d"]["bound"]),
                    (nb_bench, bound_bench)):
        _, dev_ms = kernel_profile(f"K1 nb {nb_t}",
                                   lambda: run_window(args, nb_t),
                                   K1_KERNELS, calls=20)
        log(7, f"window1d at nb={nb_t}: {dev_ms!r} ms of device time a call "
            f"(torch.profiler, 20 calls; {K1_KERNELS}), {dev_ms / b[0]:.1f}x "
            f"its bound [{gpu}]")
        if nb_t == nb:
            kinds["window1d"]["device_ms"] = dev_ms
    _, dev_k2 = kernel_profile(
        "K2", lambda: k2.fused_rk4_steps(model, state, dt, n_steps),
        ("rk4_l96",), calls=20)
    kinds["rk4_l96"]["device_ms"] = dev_k2
    log(7, f"rk4_l96 [40, 10000] x {n_steps} steps: {dev_k2!r} ms of device "
        f"time a call (torch.profiler, 20 calls), "
        f"{dev_k2 / kinds['rk4_l96']['bound'][0]:.1f}x its bound [{gpu}]")
    log(7, f"fused1d analysis {ms_analysis!r} ms/analysis "
        f"({10000 / ms_analysis * 1e3!r} grid-points/s); cycle "
        f"{ms_cycle!r} ms ({1e3 / ms_cycle!r} cycles/s) [{gpu}]")
    log(7, kernel_profile("fused1d analysis", next_analysis, K1_KERNELS,
                          wall_ms=ms_analysis)[0] + f" [{gpu}]")
    log(7, kernel_profile("cycle", next_cycle, K1_KERNELS,
                          wall_ms=ms_cycle)[0] + f" [{gpu}]")

    # -- 8. K3 against its plain version ---------------------------------
    rng = np.random.RandomState(SEED + 3)

    def on_card(x):
        return torch.as_tensor(x.astype(np.float32), device=dev)

    gauss = on_card(rng.normal(size=(10000, 40, 40)))
    lienks = make_lienks_step(loc, RK4Integrator(Lorenz96(), 0.05), 4,
                              n_outer=2, tau=1.0, max_obs=exact_nb(worst),
                              selection="window")
    ienks_batches = svd_inputs(lienks, wt)
    check(len(ienks_batches) == 4,
          f"the IEnKS step took {len(ienks_batches)} SVDs, not 4")
    batches = [
        ("gaussian [10^4, 40, 40]", gauss),
        ("sigma span 1e4 [2048, 40, 40]",
         on_card(sigma_span_batch(rng, 2048, 40, 1e4))),
        ("K=13 [512]", on_card(rng.normal(size=(512, 13, 13)))),
        ("K=64 [512]", on_card(rng.normal(size=(512, 64, 64)))),
    ] + [(f"IEnKS step {i // 2 + 1} "
          + ("weight perturbations" if i % 2 == 0 else "updated precision"),
          t) for i, t in enumerate(ienks_batches)]
    notes = []
    err_k3 = 0.0
    for label, a in batches:
        e, out, ref = svd_vs_plain(a, label)
        err_k3 = max(err_k3, e)
        if label.startswith("IEnKS"):
            for x, y in zip(ienks_compositions(*out, 40),
                            ienks_compositions(*ref, 40)):
                compare(x, y, f"{label}: composition")
        notes.append(f"{label} {e!r}")
    nan_batch = on_card(rng.normal(size=(512, 40, 40)))
    nan_batch[3, 5, 7] = float("nan")
    _, out, _ = svd_vs_plain(nan_batch, "NaN batch")
    bad = torch.isnan(out[1]).any(-1)
    check(bool(bad[3]) and int(bad.sum()) == 1,
          f"the NaN spread to {int(bad.sum())} matrices")
    notes.append("NaN batch: NaN entries identical, 511 others finite")
    # the SPD Gram batch of the eigh analysis with max_obs (phase 9)
    idx, w_nbh = neighborhood_select_window(loc, _with_time(wt[4]),
                                            _with_time(wt[5]), NB)
    perts9, _ = _normalized_obs_space(wt[0][:, wt[3].long()], wt[1], wt[2])
    z = perts9[:, idx]
    grams = torch.einsum("kgn,gn,mgn->gkm", z, w_nbh, z).contiguous()
    before = k3.LAUNCHES["svd_jacobi"]
    ev, evec = k3.eigh_svd_jacobi(grams)
    torch.cuda.synchronize()
    check(k3.LAUNCHES["svd_jacobi"] == before + 1, "eigh launch not counted")
    ev_p, _ = k3.eigh_from_svd(*k3.svd_jacobi_plain(grams))
    e, _ = compare(ev, ev_p, "eigh_svd_jacobi: eigenvalues")
    rec = float((torch.einsum("bik,bk,bjk->bij", evec, ev, evec)
                 - grams).abs().max() / grams.abs().max())
    orth = float((evec.mT @ evec - torch.eye(40, device=dev)).abs().max())
    check(rec <= FACTOR_TOL and orth <= FACTOR_TOL,
          f"eigh_svd_jacobi: reconstruction {rec!r}, orthogonality {orth!r}")
    notes.append(f"eigh of the phase-9 Grams [10^4, 40, 40]: eigenvalues "
                 f"{e!r}, reconstruction {rec!r}, orthogonality {orth!r}")
    kinds["svd_jacobi"] = {"max_abs_err": err_k3}
    log(8, "K3 svd_jacobi against plain, max abs err of s: "
        + "; ".join(notes))

    # -- 9. eigh LETKF with max_obs, f32, through K3 ---------------------
    k3.LAUNCHES["svd_jacobi"] = 0
    eigh9 = make_letkf_analysis(loc, INF, method="eigh", max_obs=NB,
                                selection="window")
    eigh_nbh = eigh9(*wt)
    torch.cuda.synchronize()
    check(k3.LAUNCHES["svd_jacobi"] == 1,
          f"eigh max_obs: {k3.LAUNCHES['svd_jacobi']} K3 launches, not 1")
    _, rel9 = compare(eigh_nbh, oracle, "eigh max_obs f32 vs f64 eigh")
    log(9, f"eigh LETKF, max_obs={NB} window, f32 through K3 (1 launch) vs "
        f"the f64 eigh oracle: max rel err {rel9!r} (budget {TOL})")

    # -- 10. the localized IEnKS at bench config 9 -------------------------
    expected = {"rk4_l96": 2, "svd_jacobi": 4}
    out10, launches10 = counted(lienks, *wt)
    check(launches10 == expected, f"IEnKS step launches {launches10}")
    check(bool(torch.isfinite(out10).all()), "IEnKS step not finite")
    launches["svd_jacobi"] = launches10["svd_jacobi"]
    t0 = time.perf_counter()
    oracle10, launches64 = counted(lienks, *w64)
    s64 = time.perf_counter() - t0
    check(launches64 == {},
          f"the f64 step launched kernels: {launches64}")
    _, rel10 = compare(out10, oracle10, "IEnKS f32 vs f64")
    bundle = make_lienks_step(loc, RK4Integrator(Lorenz96(), 0.05), 4,
                              n_outer=2, kind="bundle", tau=1.0,
                              max_obs=exact_nb(worst), selection="window")
    out_b, launches_b = counted(bundle, *wt)
    check(launches_b == expected, f"IEnKS bundle launches {launches_b}")
    check(bool(torch.isfinite(out_b).all()), "IEnKS bundle not finite")
    log(10, f"IEnKS transform (ens 40, grid 10000, obs 1000, GC r=20, 2 "
        f"outer, 4xRK4, max_obs {exact_nb(worst)} window): launches "
        f"{launches10}, finite; vs the f64 step (torch.linalg.svd, "
        f"{s64:.1f} s) max rel err {rel10!r} (budget {TOL}); bundle finite, "
        f"launches {launches_b}")

    # -- 11. times ---------------------------------------------------------
    kinds["svd_jacobi"]["ms"], kinds["svd_jacobi"]["plain_ms"] = paired_ms(
        lambda: k3.svd_jacobi(gauss), lambda: k3.svd_jacobi_plain(gauss),
        plain_time=event_ms)
    # cuSOLVER was set up by the f64 step: one call each, no warm-up
    ms_lapack = event_ms(lambda: torch.linalg.svd(gauss), reps=1, warmup=0)
    kinds["svd_jacobi"]["library_ms"] = ms_lapack
    sweeps = jacobi_sweeps(gauss)
    b, kk = gauss.shape[0], gauss.shape[-1]
    kp = kk + kk % 2
    # per sweep and matrix: Kp - 1 rounds of Kp/2 pairs, each three dot
    # products and two rotations of a column pair of A and of V
    kinds["svd_jacobi"]["bound"] = bound(
        3 * nbytes(gauss) + b * kk * 4,
        sweeps * b * (kp - 1) * (kp // 2) * 18 * kk)
    ms_step = median_ms(lambda: lienks(*wt), reps=10, inner=3)
    ms_eigh9 = median_ms(lambda: eigh9(*wt), reps=10, inner=3)
    set_jacobi_dispatch(False)
    try:
        ms_step_lapack = event_ms(lambda: lienks(*wt), reps=1, warmup=0)
    finally:
        set_jacobi_dispatch(None)
    log(11, f"svd_jacobi [10^4, 40, 40] f32: kernel "
        f"{kinds['svd_jacobi']['ms']!r} ms, plain "
        f"{kinds['svd_jacobi']['plain_ms']!r} ms, torch.linalg.svd "
        f"{ms_lapack!r} ms (one call), bound "
        f"{kinds['svd_jacobi']['bound'][0]!r} ms at {sweeps} sweeps [{gpu}]")
    log(11, f"IEnKS step (config 9): {ms_step!r} ms = "
        f"{10000 / ms_step * 1e3!r} grid-points/s with K3; "
        f"{ms_step_lapack!r} ms = {10000 / ms_step_lapack * 1e3!r} "
        f"grid-points/s with torch.linalg.svd (one call); eigh LETKF with "
        f"max_obs {NB} (phase 9, 1 K3 launch) {ms_eigh9!r} ms [{gpu}]")

    smoother_phases(dev, gpu, loc, w, exact_nb(worst), oracle10, out10,
                    out_b, ienks_batches, ms_step, lambda: lienks(*wt))
    nbh_phases(dev, gpu, loc, w, wt, w64, wc, kinds, launches)
    window2d_phases(dev, gpu, kinds, launches)
    kernelized_phases(dev, gpu, loc, w, kinds, launches)
    ref26 = halo_phases(dev, gpu, kinds, launches)
    autograd_phase(dev, gpu, loc, w)
    ref32 = sharded_smoother_phase(dev, gpu, loc, w, exact_nb(worst), out10,
                                   out_b, oracle10, ms_step)
    ref33 = entry_phase(dev, gpu, loc, w)
    multiprocess_phase(dev, gpu, ref26, ref32, ref33)
    terrsysmp_phase(dev, gpu)

    sources = {
        "window1d": ("tpu_assim_torch/csrc/letkf_window1d.cu",
                     "tpu_assim/ops/pallas/letkf.py:831"),
        "rk4_l96": ("tpu_assim_torch/csrc/rk4_l96.cu",
                    "tpu_assim/models/pallas_forecast.py:59"),
        "svd_jacobi": ("tpu_assim_torch/csrc/svd_jacobi.cu",
                       "tpu_assim/ops/pallas/svd.py:123"),
        "nbh_cheb": ("tpu_assim_torch/csrc/letkf_nbh_cheb.cu",
                     "tpu_assim/ops/pallas/letkf.py:668"),
        "nbh_ns": ("tpu_assim_torch/csrc/letkf_nbh_ns.cu",
                   "tpu_assim/ops/pallas/letkf.py:322"),
        "window2d": ("tpu_assim_torch/csrc/letkf_window2d.cu",
                     "tpu_assim/ops/pallas/letkf.py:1353"),
        "eigh_jacobi": ("tpu_assim_torch/csrc/eigh_jacobi.cu",
                        "tpu_assim/ops/pallas/jacobi.py:146"),
        "halo_ring": ("tpu_assim_torch/csrc/halo_ring.cu",
                      "tpu_assim/parallel/halo.py:308"),
    }
    print(gpu)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
         "bound_by": t["bound"][1], "library_ms": t.get("library_ms"),
         "device_ms": t.get("device_ms")}
        for name, t in kinds.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# -- 29. the differentiable path ----------------------------------------------

F64_GRAD_TOL = 2e-5  # an f32 kernel path's gradient against f64, relative
                     # to max|f64 gradient| (tests/test_differentiable.py:287)
FD_RTOL = 1e-3       # d loss / d rho against central differences
                     # (tests/test_differentiable.py:313)


def load_example(name):
    """The module of ``examples/<name>.py`` beside this script."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cotangent(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def function_grads(label, kernel_fn, plain_fn, inputs, names, seed, dev):
    """One kernel Function on the card: the gradients of sum(out * c) in
    every input that requires one (``names``), through the Function (its
    launches counted: one forward, the backward), through the plain
    version in f32 on the card (the backward is its replay: 0.0 expected)
    and in f64 (within F64_GRAD_TOL of max|f64 gradient|); the time of a
    forward and of a forward and backward (CUDA events, median of 5).
    Returns the note."""
    xs = [t.detach().clone().requires_grad_(t.is_floating_point())
          for t in inputs]
    wanted = [x for x in xs if x.requires_grad]
    out, fwd = counted(kernel_fn, *xs)
    ct = cotangent(out.shape, seed, dev)
    grads, bwd = counted(torch.autograd.grad, (out * ct).sum(), wanted)
    check(sum(fwd.values()) == 1 and not bwd,
          f"{label}: launches forward {fwd}, backward {bwd}")
    plain = torch.autograd.grad((plain_fn(*xs) * ct).sum(), wanted)
    x64 = [t.detach().double().requires_grad_() if t.is_floating_point()
           else t for t in inputs]
    g64 = torch.autograd.grad((plain_fn(*x64) * ct.double()).sum(),
                              [x for x in x64 if x.requires_grad])
    notes = []
    for name, g, gp, gd in zip(names, grads, plain, g64):
        check(bool(torch.isfinite(g).all()), f"{label}: d/d{name} not finite")
        scale = float(gd.abs().max())
        d_plain = float((g.double() - gp.double()).abs().max())
        d64 = float((g.double() - gd).abs().max())
        check(d64 <= F64_GRAD_TOL * scale,
              f"{label}: d/d{name} {d64!r} from f64 > {F64_GRAD_TOL} * "
              f"{scale!r}")
        check(d_plain <= 1e-6 * scale,
              f"{label}: d/d{name} {d_plain!r} from the plain version's")
        notes.append(f"d/d{name} plain {d_plain!r}, f64 {d64 / scale:.3e}")
    ms_f = event_ms(lambda: kernel_fn(*xs), reps=5)
    ms_fb = event_ms(lambda: torch.autograd.grad(
        (kernel_fn(*xs) * ct).sum(), wanted), reps=5)
    return (f"{label}: launches forward {fwd}, backward none; "
            + "; ".join(notes) + f" (relative to max|f64|); forward "
            f"{ms_f!r} ms, forward+backward {ms_fb!r} ms")


def learn_inflation_f64(twin, nb, degree, radius):
    """The learn-inflation loss in f64 through the plain versions of K2 and
    K1 (strict window as the kernel path's), on the twin's tensors:
    ``loss64(log_rho, ens0)``."""
    model, dt, n_int = twin["integ"].model, twin["integ"].dt, twin["n_int"]
    ox = twin["obs_coords"][:, 0].double()
    gx = twin["grid_coords"][:, 0].double()
    idx = twin["obs_idx"].long()

    def loss64(log_rho, ens0):
        reg = (ens0.shape[0] - 1) / torch.exp(log_rho)
        x, errs = ens0, []
        for c in range(twin["truths"].shape[0]):
            x = k2.rk4_steps_plain(model, x, dt, n_int)
            perts, innov = _normalized_obs_space(
                x[:, idx], twin["obs_seq"][c].double(),
                twin["obs_var"].double())
            mean = x.mean(0)
            x = k1.window_analysis_plain(
                perts, innov, ox, gx, (x - mean)[None], mean[None], reg,
                radius, ens_size=x.shape[0], nb=nb, degree=degree,
                epsilon=1e-5, taper="gc2", strict=True)[0]
            errs.append(torch.mean((x.mean(0) - twin["truths"][c].double())
                                   ** 2))
        return torch.stack(errs).mean()

    return loss64


def autograd_phase(dev, gpu, loc, w):
    """Phase 29: the differentiable path. (a) K1, K4 and K6 through their
    autograd.Functions at the main path's shapes against the plain
    versions' gradients (f32 and f64); (b) the learn-inflation loss at full
    width through K2 and K1 (launches, d loss / d log_rho against f64
    central differences, the initial ensemble's gradient against f64,
    descent, times, memory, a profiler window); (c) the eigh route's
    gradient through K3; (d) K5, K7 and K8 raise on a gradient."""
    t_phase = time.perf_counter()
    # -- (a) each Function at the main path's shapes ----------------------
    args = window_inputs(w, dev)
    reg = torch.tensor(39 / INF, device=dev)
    k1_in = args[:4] + [args[4][None], args[5][None], reg]
    log(29, function_grads(
        f"K1 _Window1D (ens 40, grid 10^4, obs 1000, GC r={RADIUS:g}, nb "
        f"{NB}, degree {DEGREE})",
        lambda *a: k1.letkf_window_analysis_fused(
            *a[:6], a[6], RADIUS, 40, nb=NB, degree=DEGREE),
        lambda *a: k1.window_analysis_plain(
            *a[:6], a[6], RADIUS, ens_size=40, nb=NB, degree=DEGREE,
            epsilon=1e-5, taper="gc2", strict=False),
        k1_in, ("perts", "innov", "obs_x", "grid_x", "sp", "mean", "reg"),
        SEED + 90, dev) + f" [{gpu}]")
    wt = [torch.as_tensor(x, device=dev) for x in w]
    k4_in = nbh_inputs(loc, wt, NB) + [reg]
    log(29, function_grads(
        f"K4 _NbhCheb (headline cheb, nb {NB}, degree {DEGREE}, ns 1)",
        lambda *a: k1.letkf_nbh_analysis_cheb(*a[:4], a[4], 40, DEGREE),
        lambda *a: k1.nbh_cheb_plain(*a[:4], a[4], 40, DEGREE),
        k4_in, ("zh", "yh", "sp", "mean", "reg"), SEED + 91, dev)
        + f" [{gpu}]")
    w7 = workload_2d(128, 1024, sort_cells=False)
    nb7 = exact_nb(k1.max_in_support_2d(w7[5], w7[4], R2, R2))
    blk7 = k1.required_obs_block_2d(w7[5][:, 1], w7[4][:, 1], R2)
    wt7 = [torch.as_tensor(a, device=dev) for a in w7]
    perts7, innov7 = _normalized_obs_space(wt7[0][:, wt7[3].long()], wt7[1],
                                           wt7[2])
    mean7 = wt7[0].mean(0)
    args7, width7 = k1.window2d_inputs(perts7, innov7, wt7[5], wt7[4],
                                       (wt7[0] - mean7)[None], mean7[None],
                                       39 / INF, R2, R2, blk7)
    kw7 = dict(width=width7, ens_size=40, nb=nb7, degree=DEGREE,
               epsilon=1e-5, taper="gc2")
    log(29, function_grads(
        f"K6 _Window2D (bench config 7: 128x128, obs 1024, nb {nb7}, block "
        f"{blk7}, degree {DEGREE})",
        lambda *a: k1.window2d_banded(*a, **kw7),
        lambda *a: k1.window2d_plain(*a, strict=False, **kw7),
        list(args7), ("table", "grid", "sp", "mean", "scal"), SEED + 92,
        dev) + f" [{gpu}]")

    # -- (b) the learn-inflation loss at full width -------------------------
    example = load_example("torch_learn_inflation")
    t0 = time.perf_counter()
    loss = example.make_loss(cycles=4, ens=40, grid=10000, device=dev,
                             radius=RADIUS, max_obs=NB, cheb_degree=DEGREE,
                             obs_every=10, n_int=4)
    s_twin = time.perf_counter() - t0
    twin = loss.twin
    check(twin["obs_idx"].numel() == 1000, "the twin's observations")
    log_rho = torch.zeros((), device=dev, requires_grad=True)
    val, fwd = counted(loss, log_rho)
    (g_rho,), bwd = counted(torch.autograd.grad, val, log_rho)
    check(fwd == {"rk4_l96": 4, "window1d": 4} and not bwd,
          f"learn-inflation launches: forward {fwd}, backward {bwd}")
    loss64 = learn_inflation_f64(twin, NB, DEGREE, RADIUS)
    x64 = twin["ens0"].double()
    eps = 1e-3
    with torch.no_grad():
        fd = float((loss64(torch.tensor(eps, dtype=torch.float64,
                                        device=dev), x64)
                    - loss64(torch.tensor(-eps, dtype=torch.float64,
                                          device=dev), x64)) / (2 * eps))
    rel_rho = abs(float(g_rho) - fd) / abs(fd)
    check(rel_rho <= FD_RTOL, f"d loss / d log_rho {float(g_rho)!r} vs f64 "
          f"central difference {fd!r}: {rel_rho!r} > {FD_RTOL}")
    x0 = twin["ens0"].float().requires_grad_()
    (g_x0,) = torch.autograd.grad(loss(log_rho, x0), x0)
    x0_64 = x64.clone().requires_grad_()
    (g_x64,) = torch.autograd.grad(
        loss64(torch.zeros((), dtype=torch.float64, device=dev), x0_64),
        x0_64)
    scale = float(g_x64.abs().max())
    err_x0 = float((g_x0.double() - g_x64).abs().max())
    check(err_x0 <= F64_GRAD_TOL * scale, f"the initial ensemble's gradient "
          f"{err_x0!r} from f64 > {F64_GRAD_TOL} * {scale!r}")
    history = example.descend(loss, 5, 0.5, dev)

    def forward():
        return loss(log_rho)

    def forward_backward():
        return torch.autograd.grad(loss(log_rho), log_rho)

    ms_f = event_ms(forward, reps=5)
    ms_fb = event_ms(forward_backward, reps=5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    forward_backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    wall, busy, rows = device_profile(forward_backward, calls=3)
    check(busy > 0, "learn-inflation profile: no device time")
    top = ", ".join(f"{name[:40]} {ms!r}" for name, ms, _ in rows[:5])
    log(29, f"learn inflation at full width (ens 40, grid 10^4, 1000 obs "
        f"every 10th point, variance 0.5, GC r={RADIUS:g}, 4 cycles of 4 "
        f"RK4 steps dt 0.05, fused1d nb {NB} degree {DEGREE}; twin built in "
        f"{s_twin:.2f} s): loss {float(val.detach())!r}; launches forward "
        f"{fwd}, "
        f"backward none; d loss / d log_rho {float(g_rho)!r} vs f64 central "
        f"difference (plain path, eps {eps}) {fd!r}: rel {rel_rho!r} (bound "
        f"{FD_RTOL}); d loss / d ens0 {err_x0 / scale:.3e} of max|f64| "
        f"(bound {F64_GRAD_TOL}); descent (lr 0.5): " + ", ".join(
            f"step {i} loss {v:.6f} rho {r:.6f}"
            for i, (v, r) in enumerate(history))
        + f"; forward {ms_f!r} ms, forward+backward {ms_fb!r} ms (CUDA "
        f"events, median of 5); memory {base / 2**20:.1f} MiB before, peak "
        f"{peak / 2**20:.1f} MiB in forward+backward; profiler (3 calls): "
        f"wall {wall!r} ms, device {busy!r} ms/call, idle "
        f"{1 - busy / wall:.1%} profiled, {1 - busy / ms_fb:.1%} of the "
        f"unprofiled {ms_fb!r} ms; kernels ms/call: {top} [{gpu}]")

    # -- (c) the eigh route's gradient through K3 ----------------------------
    ct = cotangent(tuple(w[0].shape), SEED + 93, dev)
    ct_cpu = ct.double().cpu()
    w64_cpu = [torch.as_tensor(a).double() if a.dtype.kind == "f"
               else torch.as_tensor(a) for a in w]

    def eigh_loss(x, rho, rest, c):
        analyse = make_letkf_analysis(loc, rho, method="eigh", max_obs=NB,
                                      selection="window")
        return (analyse(x, *rest) * c).sum()

    x = wt[0].clone().requires_grad_()
    rho = torch.tensor(INF, device=dev, requires_grad=True)
    val, fwd = counted(eigh_loss, x, rho, wt[1:], ct)
    check(fwd.get("svd_jacobi", 0) >= 1, f"eigh route launches {fwd}")
    gx, g_rho = torch.autograd.grad(val, (x, rho))
    t0 = time.perf_counter()
    x64 = w64_cpu[0].clone().requires_grad_()
    rho64 = torch.tensor(INF, dtype=torch.float64, requires_grad=True)
    gx64, _ = torch.autograd.grad(eigh_loss(x64, rho64, w64_cpu[1:], ct_cpu),
                                  (x64, rho64))
    with torch.no_grad():
        fd = float((eigh_loss(w64_cpu[0], INF + eps, w64_cpu[1:], ct_cpu)
                    - eigh_loss(w64_cpu[0], INF - eps, w64_cpu[1:], ct_cpu))
                   / (2 * eps))
    s64 = time.perf_counter() - t0
    scale = float(gx64.abs().max())
    err_x = float((gx.double().cpu() - gx64).abs().max())
    rel_rho = abs(float(g_rho) - fd) / abs(fd)
    check(err_x <= F64_GRAD_TOL * scale, f"eigh route: d/dstate {err_x!r} "
          f"from f64 > {F64_GRAD_TOL} * {scale!r}")
    check(rel_rho <= FD_RTOL, f"eigh route: d/drho {float(g_rho)!r} vs "
          f"{fd!r}: {rel_rho!r}")
    log(29, f"eigh with max_obs {NB} (window) through K3 (forward launches "
        f"{fwd}): d/dstate {err_x / scale:.3e} of max|f64| (bound "
        f"{F64_GRAD_TOL}; f64 on the CPU, {s64:.1f} s), d/drho "
        f"{float(g_rho)!r} vs f64 central difference {fd!r}: rel "
        f"{rel_rho!r} (bound {FD_RTOL}) [{gpu}]")

    # -- (d) the kernels without a VJP raise on a gradient ------------------
    def raises(label, fn):
        try:
            fn()
        except NotImplementedError as err:
            return f"{label}: {err}"
        raise AssertionError(f"{label} computed on an input that requires "
                             "a gradient instead of raising")

    zh, yh, sp, mean = ns_random(dev, 256, NB, SEED + 94)
    sym = cotangent((16, 40, 40), SEED + 95, dev)
    blocks = [cotangent((43, 128), SEED + 96 + i, dev) for i in range(8)]
    notes = [
        raises("K5", lambda: k1.letkf_nbh_analysis_fused(
            zh.requires_grad_(), yh, sp, mean, 39 / INF, 40, NS_ITERS)),
        raises("K7", lambda: k7.eigh_jacobi(
            (sym + sym.mT).requires_grad_())),
        raises("K8", lambda: k8.ring_halo_rdma(
            [b.requires_grad_() for b in blocks], 8, 1)),
    ]
    log(29, "raise on a gradient: " + "; ".join(notes))
    log(29, f"phase 29 took {time.perf_counter() - t_phase:.1f} s")


def smoother_inputs(w, dev, dtype):
    """Bench config 9 as the class smoother takes it: the [40, 10^4]
    ensemble as an EnsembleState [1, 1, 40, 10^4] at time 0, and its 1000
    point observations (IdentityOperator), in ``dtype`` on ``dev``."""
    data = torch.as_tensor(w[0], device=dev).to(dtype)
    state = EnsembleState(data[None, None],
                          times=torch.zeros(1, dtype=dtype, device=dev),
                          grid_coords=torch.as_tensor(w[4], device=dev).to(
                              dtype))
    obs = Observation(
        torch.as_tensor(w[1], device=dev).to(dtype)[None],
        torch.as_tensor(w[2], device=dev).to(dtype),
        obs_coords=torch.as_tensor(w[5], device=dev).to(dtype),
        times=torch.zeros(1, dtype=dtype, device=dev),
        operator=IdentityOperator(obs_points=w[3], len_grid=w[0].shape[1]))
    return state, obs


def l96_forward(state, iter_num=0):
    """The smoother's forward model: 4 RK4 steps of Lorenz-96 (dt 0.05) of
    every member, through ``analysis._forecast`` (K2 on the card in
    f32)."""
    state = state.replace(data=_forecast(RK4Integrator(Lorenz96(), 0.05), 4,
                                         state.data))
    return state, state


def smoother_grad(alg, state, obs):
    """``(analysis [40, g], d sum(analysis^2) / d state [40, g])`` of one
    class call."""
    x = state.data.detach().clone().requires_grad_(True)
    out = alg.assimilate(state.replace(data=x), obs).data
    torch.sum(out * out).backward()
    return out.detach()[0, 0], x.grad[0, 0]


def smoother_phases(dev, gpu, loc, w, nb, oracle10, out10, out_b,
                    ienks_batches, ms_step, step_fn):
    """Phase 28: the smoother classes at bench config 9, their launches,
    their error against the functional step and its f64 oracle, K3's
    gradient and the smoother's gradient through K2 and K3, and times."""
    # -- 28. the smoother classes -------------------------------------------
    state, obs = smoother_inputs(w, dev, torch.float32)
    opts = dict(forward_model=l96_forward, localization=loc, tau=1.0,
                max_iter=2, max_obs=nb, selection="window")
    expected = {4096: {"rk4_l96": 2, "svd_jacobi": 12},
                None: {"rk4_l96": 2, "svd_jacobi": 4}}
    outs = {}
    for cls in (LocalizedIEnKSTransform, LocalizedIEnKSBundle):
        for chunk in (4096, None):
            alg = cls(chunksize=chunk, **opts)
            out, counts = counted(lambda: alg.assimilate(state, obs).data)
            name = f"{cls.__name__} chunksize={chunk}"
            check(counts == expected[chunk], f"{name} launches {counts}")
            check(bool(torch.isfinite(out).all()), f"{name} not finite")
            outs[name] = out[0, 0]
    # the bundle's f64 step on the CPU (no kernel): the yardstick of its
    # f32 conditioning, which divides rounding of the propagated
    # ensemble by epsilon = 1e-4
    w64 = [torch.as_tensor(a) for a in w]
    w64 = [t.double() if t.is_floating_point() else t for t in w64]
    bundle64 = make_lienks_step(
        loc, RK4Integrator(Lorenz96(), 0.05), 4, n_outer=2, kind="bundle",
        tau=1.0, max_obs=nb, selection="window")(*w64).to(dev)

    def rel(out, ref):
        return float((out.double() - ref.double()).abs().max()
                     / ref.double().abs().max())

    rel_b64 = rel(out_b, bundle64)
    errs = {name: (rel(out, out10 if "Transform" in name else out_b),
                   rel(out, oracle10 if "Transform" in name else bundle64))
            for name, out in outs.items()}
    log(28, f"class smoothers (config 9: ens 40, grid 10000, obs 1000, GC "
        f"r={RADIUS}, 2 outer, 4xRK4, max_obs {nb} window; launches "
        f"{expected[4096]} in chunks of 4096, {expected[None]} unchunked), "
        f"max rel err against the f32 functional step and the f64 step: "
        + "; ".join(f"{name} {a!r}, {b!r}" for name, (a, b) in errs.items())
        + f"; the f32 functional bundle against the f64 one {rel_b64!r}")
    # every class call against its functional twin (a column's inner step
    # does not depend on its chunk: ops/ienks.py:_matvec); the transform
    # also against f64, where the bundle's f32 conditioning (it divides
    # rounding by epsilon) sets its distance, printed above
    for name, (to_twin, to_f64) in errs.items():
        check(to_twin <= TOL, f"{name} vs its functional step {to_twin!r} "
              f"> {TOL}")
        if "Transform" in name:
            check(to_f64 <= TOL, f"{name} vs f64 {to_f64!r} > {TOL}")

    # K3's gradient: sign-invariant compositions of the kernel's f32
    # factors against torch.linalg.svd's autograd in f64 on the CPU
    rng = np.random.RandomState(SEED + 28)

    def composition_grad(a, svd_fn, cot):
        x = a.detach().clone().requires_grad_(True)
        loss = sum(torch.sum(c * m) for c, m in zip(
            cot, ienks_compositions(*svd_fn(x), a.shape[-1])))
        loss.backward()
        return x.grad.double().cpu()

    def lapack(x):
        u, s, vh = torch.linalg.svd(x)
        return u, s, vh.mT

    def k3_grad_err(a, ref_svd):
        cot = [torch.as_tensor(rng.normal(size=tuple(a.shape)))
               for _ in range(3)]
        g32 = composition_grad(a, k3.svd_jacobi,
                               [c.to(device=dev, dtype=a.dtype) for c in cot])
        g64 = composition_grad(a.double().cpu(), ref_svd, cot)
        check(bool(torch.isfinite(g32).all()), "K3 gradient not finite")
        return float((g32 - g64).abs().max() / g64.abs().max())

    spread = torch.as_tensor(sigma_span_batch(rng, 10000, 40, 10.0),
                             device=dev)
    err_grad = k3_grad_err(spread, lapack)
    check(err_grad <= GRAD_TOL,
          f"K3 gradient vs torch.linalg.svd f64: {err_grad!r} > {GRAD_TOL}")
    notes = []
    for i, a in enumerate(ienks_batches[1:], 2):
        s64 = torch.linalg.svdvals(a.double().cpu())
        gap = float((s64[..., :-1] - s64[..., 1:]).min())
        err = k3_grad_err(a, lambda x: svd(x, use_jacobi=False))
        notes.append(f"batch {i} {err!r} (smallest singular-value gap "
                     f"{gap!r})")
    log(28, f"K3 gradient (f32, its autograd.Function) of the IEnKS "
        f"compositions W'^-T, U S^-2 U^T, U (K-1)^1/2 S^-1/2 V^T: on "
        f"[10^4, 40, 40] with singular values log-spaced over 10, against "
        f"torch.linalg.svd's autograd in f64 (CPU), max rel err "
        f"{err_grad!r} (budget {GRAD_TOL}); on the IEnKS step's batches "
        f"2-4 against the f64 LAPACK route, not checked: the rank-{nb} "
        f"update of (K-1) I ties K - {nb} singular values to rounding, "
        f"where the pullback of an arbitrary cotangent is ill-posed in any "
        f"precision: " + "; ".join(notes))

    # the smoother's gradient through K2 and K3, against f64 on the CPU
    alg = LocalizedIEnKSTransform(chunksize=4096, **opts)
    (out32, g32), counts = counted(smoother_grad, alg, state, obs)
    check(counts == expected[4096], f"class gradient launches {counts}")
    check(bool(torch.isfinite(g32).all()), "class gradient not finite")
    state64, obs64 = smoother_inputs(w, "cpu", torch.float64)
    out64, g64 = smoother_grad(alg, state64, obs64)
    _, rel_out64 = compare(out64.to(dev), oracle10,
                           "f64 class (CPU) vs f64 step")
    scale = float(g64.abs().max())
    err_g = float((g32.double().cpu() - g64).abs().max()) / scale
    state_p, obs_p = smoother_inputs(w, "cpu", torch.float32)
    _, g32_plain = smoother_grad(alg, state_p, obs_p)
    err_plain = float((g32_plain.double() - g64).abs().max()) / scale
    log(28, f"class smoother gradient d sum(out^2)/d state, f32 through K2 "
        f"and K3 ({counts}) vs f64 on the CPU (no kernel; its analysis vs "
        f"the f64 step {rel_out64!r}): max rel err {err_g!r} (budget "
        f"{SMOOTHER_GRAD_TOL}); the f32 plain route on the CPU (LAPACK, "
        f"plain RK4): {err_plain!r}")
    check(err_g <= SMOOTHER_GRAD_TOL,
          f"class smoother gradient {err_g!r} > {SMOOTHER_GRAD_TOL}")

    # -- times --------------------------------------------------------------
    times, profiles = [], []
    for chunk in (4096, None):
        alg = LocalizedIEnKSTransform(chunksize=chunk, **opts)
        ms = median_ms(lambda: alg.assimilate(state, obs), reps=10, inner=3)
        times.append(f"chunksize={chunk} {ms!r} ms = "
                     f"{10000 / ms * 1e3!r} grid-points/s")
        profiles.append(profile_note(f"class call chunksize={chunk}",
                                     lambda: alg.assimilate(state, obs)))
    profiles.append(profile_note("the functional step", step_fn))
    alg = LocalizedIEnKSTransform(chunksize=4096, **opts)
    ms_fb = median_ms(lambda: smoother_grad(alg, state, obs), reps=5,
                      inner=1)
    log(28, f"LocalizedIEnKSTransform.assimilate (config 9, CUDA events, "
        f"median of 10 x 3 calls): " + "; ".join(times)
        + f"; the functional step (phase 11) {ms_step!r} ms = "
        f"{10000 / ms_step * 1e3!r} grid-points/s; forward and backward of "
        f"one chunksize=4096 call {ms_fb!r} ms (median of 5) [{gpu}]")
    log(28, "torch.profiler, 5 calls each: " + "; ".join(profiles)
        + f" [{gpu}]")


def class_api_inputs(data, w, n_times):
    """An EnsembleState of ``data`` [v, t, k, g] on the headline grid (vars
    "x", "y"), and one Observation of variable "x" at the headline obs
    points at every one of its ``n_times`` times, by IdentityOperator."""
    dev = data.device
    rnd = np.random.RandomState(SEED + 4)
    times = torch.arange(n_times, dtype=data.dtype, device=dev)
    state = EnsembleState(data, times=times,
                          grid_coords=torch.as_tensor(w[4], device=dev),
                          var_names=("x", "y")[:data.shape[0]])
    n_obs = w[1].shape[0]
    vals = rnd.normal(size=(n_times, n_obs))
    obs = Observation(
        torch.as_tensor(vals, dtype=data.dtype, device=dev),
        torch.ones(n_obs, dtype=data.dtype, device=dev),
        obs_coords=torch.as_tensor(w[5], dtype=data.dtype, device=dev),
        times=times,
        operator=IdentityOperator(obs_points=w[3], len_grid=data.shape[-1]))
    return state, obs


def nbh_phases(dev, gpu, loc, w, wt, w64, wc, kinds, launches):
    """Phases 12-16: K4 and K5 against their plain versions, the cheb and
    pallas analyses and the class API against f64 oracles, and times."""
    g = w[0].shape[1]
    # -- 12. K4 against its plain version ---------------------------------
    a12 = nbh_inputs(loc, wt, NB)
    before = k1.LAUNCHES["nbh_cheb"]
    out = run_cheb(a12, DEGREE)
    torch.cuda.synchronize()
    check(k1.LAUNCHES["nbh_cheb"] == before + 1, "K4 launch not counted")
    err_k4, rel = compare(out, run_cheb(a12, DEGREE, plain=True),
                          "K4 vs plain (headline)")
    notes = [f"headline (nb {NB}, ns 1, degree {DEGREE}) {err_k4!r} "
             f"(rel {rel!r})"]
    a6 = nbh_inputs(loc, wt, 36, ns=6)
    e, rel = compare(run_cheb(a6, 48), run_cheb(a6, 48, plain=True),
                     "K4 ns=6 nb=36 degree 48")
    notes.append(f"ns 6, nb 36, degree 48 {e!r} (rel {rel!r})")
    err_k4 = max(err_k4, e)
    zero = [torch.zeros_like(a12[0]), torch.zeros_like(a12[1])] + a12[2:]
    out = run_cheb(zero, DEGREE)
    e, _ = compare(out, run_cheb(zero, DEGREE, plain=True), "K4 zero weights")
    err_k4 = max(err_k4, e)
    e_prior, _ = compare(out, a12[3][:, None, :] + INF ** 0.5 * a12[2],
                         "K4 zero weights vs mean + sqrt(rho) sp")
    notes.append(f"zero weights {e!r}, against mean + sqrt(rho) sp "
                 f"{e_prior!r}")
    wct = [torch.as_tensor(x, device=dev) for x in wc]
    a_nan = nbh_inputs(loc, wct, NB)
    out = run_cheb(a_nan, DEGREE)
    e, _ = compare(out, run_cheb(a_nan, DEGREE, plain=True), "K4 NaN batch")
    err_k4 = max(err_k4, e)
    n_nan = int(torch.isnan(out).any(1).any(0).sum())
    check(0 < n_nan < g, f"K4 NaN batch poisons {n_nan} columns")
    notes.append(f"strict overflow {n_nan} NaN columns identical, others "
                 f"{e!r}")
    # both routes and every packing (nbh_cheb_plan's columns a warp), the
    # class smoother's nb 24 and the nb 36 of phase 16 at ns 6,
    # on the headline grid and a small one, column 5 NaN among healthy
    # packed columns
    for nb_c, ns_c, deg in ((1, 1, DEGREE), (8, 1, DEGREE), (12, 1, DEGREE),
                            (16, 1, DEGREE), (24, 6, 24), (36, 6, 48),
                            (64, 1, DEGREE), (72, 1, DEGREE)):
        plan = k1.nbh_cheb_plan(40, nb_c, ns_c, deg, g)
        errs = []
        for g_c in (g, 45):
            a = cheb_random(dev, g_c, nb_c, ns_c, SEED + 30 + nb_c)
            a[0][:, :, 5] = float("nan")
            before = k1.LAUNCHES["nbh_cheb"]
            out = run_cheb(a, deg)
            torch.cuda.synchronize()
            check(k1.LAUNCHES["nbh_cheb"] == before + 1,
                  "K4 launch not counted")
            e, rel = compare(out, run_cheb(a, deg, plain=True),
                             f"K4 [40, {g_c}] nb {nb_c}")
            bad = nan_columns(out)
            check(bool(bad[5]) and int(bad.sum()) == 1,
                  f"K4 [40, {g_c}] nb {nb_c}: {int(bad.sum())} NaN columns")
            err_k4 = max(err_k4, e)
            errs.append(f"[40, {g_c}] {e!r} (rel {rel!r})")
        notes.append(f"nb {nb_c} ns {ns_c} degree {deg} ({plan['route']}, "
                     f"{plan['cols_per_warp']} a warp, 1 NaN column): "
                     + ", ".join(errs))
    kinds["nbh_cheb"] = {"max_abs_err": err_k4}
    log(12, f"K4 nbh_cheb [40, {g}] against plain, max abs err: "
        + "; ".join(notes))

    # -- 13. K5 against its plain version ---------------------------------
    a13 = ns_inputs(a12)
    check(tuple(a13[0].shape) == (g, NB, 40), f"K5 zh {a13[0].shape}")
    notes = []
    err_k5 = 0.0
    for iters in (NS_ITERS, 10):
        before = k1.LAUNCHES["nbh_ns"]
        out = run_ns(a13, iters)
        torch.cuda.synchronize()
        check(k1.LAUNCHES["nbh_ns"] == before + 1, "K5 launch not counted")
        e, rel = compare(out, run_ns(a13, iters, plain=True),
                         f"K5 vs plain, {iters} iterations")
        err_k5 = max(err_k5, e)
        notes.append(f"{iters} iterations {e!r} (rel {rel!r})")
    a_nan5 = ns_inputs(a_nan)
    out = run_ns(a_nan5, NS_ITERS)
    e, _ = compare(out, run_ns(a_nan5, NS_ITERS, plain=True), "K5 NaN batch")
    err_k5 = max(err_k5, e)
    n_nan5 = int(torch.isnan(out).any(1).sum())
    check(n_nan5 == n_nan, f"K5 NaN batch: {n_nan5} NaN columns, K4 {n_nan}")
    notes.append(f"strict overflow {n_nan5} NaN columns identical")
    # both routes and every packing of a warp (32 // nb columns up to nb
    # 32), a NaN column among the packed ones; two other ensemble sizes
    for nb, k in ((1, 40), (5, 40), (8, 40), (16, 40), (17, 40), (32, 40),
                  (33, 40), (48, 40), (3, 9), (32, 64)):
        a = ns_random(dev, 256, nb, SEED + 10 + nb, k)
        a[0][3] = float("nan")
        plan = k1.nbh_ns_plan(k, nb, 256)
        before = k1.LAUNCHES["nbh_ns"]
        out = run_ns(a, NS_ITERS)
        torch.cuda.synchronize()
        check(k1.LAUNCHES["nbh_ns"] == before + 1, "K5 launch not counted")
        e, rel = compare(out, run_ns(a, NS_ITERS, plain=True),
                         f"K5 [256, {nb}, {k}]")
        n_bad = int(torch.isnan(out).any(1).sum())
        check(n_bad == 1, f"K5 [256, {nb}, {k}]: {n_bad} NaN columns, not 1")
        err_k5 = max(err_k5, e)
        notes.append(f"[256, {nb}, {k}] ({plan['route']}, "
                     f"{plan['cols_per_warp']} a warp) {e!r} (rel {rel!r})")
    kinds["nbh_ns"] = {"max_abs_err": err_k5}
    log(13, f"K5 nbh_ns [{g}, {NB}, 40] and [256, nb, k] against plain, "
        f"{NS_ITERS} iterations unless said, max abs err (each with 1 NaN "
        "column, identical): " + "; ".join(notes))

    # -- 14. cheb and pallas analyses against the f64 oracle --------------
    t0 = time.perf_counter()
    oracle = make_letkf_analysis(loc, INF, method="eigh", max_obs=NB)(*w64)
    s_oracle = time.perf_counter() - t0
    cheb = make_letkf_analysis(loc, INF, method="cheb", selection="window",
                               max_obs=NB, cheb_degree=DEGREE)
    out, counts = counted(cheb, *wt)
    check(counts == {"nbh_cheb": 1}, f"cheb analysis launches {counts}")
    _, rel_cheb = compare(out, oracle, "cheb vs f64 eigh")
    pallas = make_letkf_analysis(loc, INF, method="pallas", max_obs=NB,
                                 newton_iters=NS_ITERS)
    out, counts = counted(pallas, *wt)
    check(counts == {"nbh_ns": 1}, f"pallas analysis launches {counts}")
    launches["nbh_ns"] = counts.get("nbh_ns", 0)
    out, ref = out.double(), oracle.double()
    check(bool(torch.isfinite(out).all()), "pallas analysis not finite")
    rel_pallas = float((out - ref).abs().max() / ref.abs().max())
    check(rel_pallas <= PALLAS_TOL,
          f"pallas vs f64 eigh: {rel_pallas!r} > {PALLAS_TOL}")
    log(14, f"max_obs {NB} against the f64 eigh oracle ({s_oracle:.1f} s): "
        f"cheb (window, degree {DEGREE}, 1 K4 launch) max rel err "
        f"{rel_cheb!r} (budget {TOL}); pallas (topk, {NS_ITERS} iterations, "
        f"1 K5 launch) {rel_pallas!r} (bound {PALLAS_TOL})")

    # -- 15. the class API -------------------------------------------------
    state, obs = class_api_inputs(wt[0][None, None], w, 1)
    obs = obs.replace(observations=wt[1][None])
    letkf = LETKF(loc, INF, max_obs=NB, method="cheb", selection="window",
                  cheb_degree=DEGREE)
    out, counts = counted(letkf.assimilate, state, obs)
    check(counts == {"nbh_cheb": 2}, f"class cheb launches {counts}")
    launches["nbh_cheb"] = counts.get("nbh_cheb", 0)
    check(out.shape == state.shape and out.dtype == torch.float32,
          f"class cheb analysis {tuple(out.shape)} {out.dtype}")
    _, rel_class = compare(out.data[0, 0], oracle, "class cheb vs f64 eigh")
    notes = [f"filter [1, 1, 40, {g}] cheb (2 K4 launches) {rel_class!r}"]

    rnd = np.random.RandomState(SEED + 5)
    data = torch.as_tensor(rnd.normal(size=(2, 3, 40, g)).astype(np.float32),
                           device=dev)
    state, obs = class_api_inputs(data, w, 3)
    state64, obs64 = class_api_inputs(data.double(), w, 3)
    stacked_x = np.sort(np.tile(w[5][:, 0], 3))
    nb_s = exact_nb(k1.max_in_support_1d(stacked_x, w[4][:, 0], RADIUS))
    t0 = time.perf_counter()
    oracle_s = LETKF(loc, INF, max_obs=nb_s, smoother=True).assimilate(
        state64, obs64)
    s_oracle_s = time.perf_counter() - t0
    for method, kernel in (("cheb", "nbh_cheb"), ("fused1d", "window1d")):
        alg = LETKF(loc, INF, max_obs=nb_s, method=method, smoother=True)
        ens_obs, filtered = alg._apply_obs_operator(state, [obs])
        _, perts, obs_info = alg._get_obs_space_variables(ens_obs, filtered)
        degree = alg._auto_cheb_degree(perts, obs_info, state.grid_info())
        out, counts = counted(alg.assimilate, state, obs)
        n_chunks = -(-g // alg.chunksize) if method == "cheb" else 1
        check(counts == {kernel: n_chunks},
              f"class smoother {method} launches {counts}")
        _, rel = compare(out.data, oracle_s.data,
                         f"class smoother {method} vs f64 eigh")
        notes.append(f"smoother [2, 3, 40, {g}] {method} (nb {nb_s}, auto "
                     f"degree {degree}, {counts}) {rel!r}")
    log(15, "LETKF.assimilate against f64 eigh (smoother oracle "
        f"{s_oracle_s:.1f} s): " + "; ".join(notes) + f" (budget {TOL})")

    # -- 16. times ---------------------------------------------------------
    kinds["nbh_cheb"]["ms"], kinds["nbh_cheb"]["plain_ms"] = paired_ms(
        lambda: run_cheb(a12, DEGREE), lambda: run_cheb(a12, DEGREE,
                                                        plain=True))
    kinds["nbh_ns"]["ms"], kinds["nbh_ns"]["plain_ms"] = paired_ms(
        lambda: run_ns(a13, NS_ITERS), lambda: run_ns(a13, NS_ITERS,
                                                      plain=True))
    kinds["nbh_cheb"]["bound"] = bound(
        nbytes(*a12) + nbytes(a12[2]), g * cheb_flops(40, NB, 1, DEGREE))
    kinds["nbh_ns"]["bound"] = bound(
        nbytes(*a13) + nbytes(a13[2]),
        g * (NB * (NB + 1) * 40 + (5 * NS_ITERS + 2) * 2 * NB ** 3
             + 4 * NB * 40 + 4 * NB * NB))
    ms_k4_s = median_ms(lambda: run_cheb(a6, 48))
    a24 = nbh_inputs(loc, wt, 24, ns=6)
    ms_k4_c = median_ms(lambda: run_cheb(a24, 24))
    state1, obs1 = class_api_inputs(wt[0][None, None], w, 1)
    obs1 = obs1.replace(observations=wt[1][None])
    ms_class = median_ms(lambda: letkf.assimilate(state1, obs1), reps=10,
                         inner=3)
    ms_cheb = median_ms(lambda: cheb(*wt), reps=10, inner=3)
    ms_pallas = median_ms(lambda: pallas(*wt), reps=10, inner=3)
    for name in ("nbh_cheb", "nbh_ns"):
        t = kinds[name]
        log(16, f"{name}: kernel {t['ms']!r} ms (CUDA events), plain "
            f"{t['plain_ms']!r} ms, bound {t['bound'][0]!r} ms "
            f"({t['bound'][1]}), {t['ms'] / t['bound'][0]:.1f}x [{gpu}]")
    t = kinds["nbh_ns"]
    ns_product = t["ms"] * 1e6 / (g * (5 * NS_ITERS + 2))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(16, f"nbh_ns [{g}, {NB}, 40] x {NS_ITERS}: {ns_product!r} ns a "
        f"column-product (an nb x nb product of one column, 5 n + 2 a "
        f"column) over the card, {ns_product * sms!r} ns on one of {sms} "
        f"SMs [{gpu}]")
    bound_k4_s = bound(nbytes(*a6) + nbytes(a6[2]),
                       g * cheb_flops(40, 36, 6, 48))
    log(16, f"nbh_cheb at ns 6, nb 36, degree 48: {ms_k4_s!r} ms (CUDA "
        f"events), bound "
        f"{bound_k4_s[0]!r} ms ({bound_k4_s[1]}), "
        f"{ms_k4_s / bound_k4_s[0]:.1f}x [{gpu}]")
    bound_k4_c = bound(nbytes(*a24) + nbytes(a24[2]),
                       g * cheb_flops(40, 24, 6, 24))
    log(16, f"nbh_cheb at the class smoother's ns 6, nb 24, degree 24: "
        f"{ms_k4_c!r} ms (CUDA events), bound {bound_k4_c[0]!r} ms "
        f"({bound_k4_c[1]}), "
        f"{ms_k4_c / bound_k4_c[0]:.1f}x [{gpu}]")
    # K4's own device time: its headline calls between CUDA events carry
    # the wrapper's host time, which can be longer; the kernels line gives
    # it as device_ms beside ms
    for label, a, deg, b in (
            ("nb 12, ns 1, degree 12", a12, DEGREE,
             kinds["nbh_cheb"]["bound"]),
            ("nb 24, ns 6, degree 24", a24, 24, bound_k4_c),
            ("nb 36, ns 6, degree 48", a6, 48, bound_k4_s)):
        _, dev_ms = kernel_profile(label, lambda: run_cheb(a, deg),
                                   ("nbh_cheb",), calls=20)
        log(16, f"nbh_cheb at {label}: {dev_ms!r} ms of device time a "
            f"launch (torch.profiler, 20 calls), {dev_ms / b[0]:.1f}x its "
            f"bound [{gpu}]")
        if a is a12:
            kinds["nbh_cheb"]["device_ms"] = dev_ms
    note, _ = kernel_profile("pallas analysis", lambda: pallas(*wt),
                             ("nbh_ns",))
    log(16, note + f" [{gpu}]")
    log(16, f"per call: LETKF(cheb).assimilate [1, 1, 40, {g}] {ms_class!r} "
        f"ms; make_letkf_analysis cheb {ms_cheb!r} ms, pallas {ms_pallas!r} "
        f"ms [{gpu}]")


def workload_2d(n, n_obs, sort_cells):
    """The workload of bench.py configs 7 and 8: a row-major n x n grid,
    ``n_obs`` observed cells drawn without replacement (sorted for config
    8), a random ensemble of 40, random observations of unit variance."""
    rnd = np.random.RandomState(SEED)
    yy, xx = np.meshgrid(np.arange(n, dtype="f4"), np.arange(n, dtype="f4"),
                         indexing="ij")
    grid = np.stack([xx.ravel(), yy.ravel()], 1)
    cells = rnd.choice(n * n, size=n_obs, replace=False)
    if sort_cells:
        cells = np.sort(cells)
    state = rnd.normal(size=(40, n * n)).astype(np.float32)
    vals = rnd.normal(size=n_obs).astype(np.float32)
    return (state, vals, np.ones(n_obs, np.float32),
            cells.astype(np.int32), grid, grid[cells])


def dist2(grid_coord, obs_coords):
    """Per-dimension distances in x and y (columns 1 and 2 of the
    localization info rows)."""
    return torch.stack([torch.abs(obs_coords[:, 1] - grid_coord[1]),
                        torch.abs(obs_coords[:, 2] - grid_coord[2])], 0)


def k6_vs_plain(args, kw, label):
    """K6 through ``window2d_banded`` (one counted launch) against
    ``window2d_plain`` on the same inputs; returns the kernel's output, the
    max abs error and the number of NaN columns."""
    before = k1.LAUNCHES["window2d"]
    out = k1.window2d_banded(*args, **kw)
    torch.cuda.synchronize()
    check(k1.LAUNCHES["window2d"] == before + 1, f"{label}: K6 launches")
    err, _ = compare(out, k1.window2d_plain(*args, **kw), label)
    return out, err, int(torch.isnan(out).any(1).any(0).sum())


def k6_plan(args, kw):
    """K6's launch plan (route, warps, blocks per tile) for these inputs."""
    tile = kw.get("tile", 128)
    return k1.window2d_plan(kw["ens_size"], kw["nb"], args[3].shape[0],
                            kw["degree"], kw["width"],
                            args[2].shape[1] // tile, tile)


def plan_note(plan):
    return (f"{plan['route']} route, {plan['warps']} warps a block, "
            f"{plan['splits']} blocks a tile")


def sampled_oracle(loc, w8, cols, dev):
    """The f64 eigh analysis of the config-8 columns ``cols`` of each strip
    of ``plan`` (a list of index arrays): per strip, over the observations
    within 2 rx + 1 of its columns in x (every one with a nonzero taper
    weight), as the dense f64 analysis of the whole grid would give them."""
    state, vals, var, cells, grid, obs = w8
    ens_obs = torch.as_tensor(state[:, cells], dtype=torch.float64,
                              device=dev)
    outs = []
    for c in cols:
        gx = grid[c, 0]
        sel = np.nonzero((obs[:, 0] > gx.min() - 2 * R2 - 1)
                         & (obs[:, 0] < gx.max() + 2 * R2 + 1))[0]
        sel_t = torch.as_tensor(sel, device=dev)
        analyse = make_letkf_analysis(
            loc, INF, method="eigh",
            obs_operator=lambda _, sel_t=sel_t: ens_obs[:, sel_t])
        f64 = [torch.as_tensor(a, dtype=torch.float64, device=dev)
               for a in (state[:, c], vals[sel], var[sel], grid[c],
                         obs[sel])]
        outs.append(analyse(*f64[:3], None, *f64[3:]))
    return torch.cat(outs, dim=1)


def class_2d_inputs(data, grid, cells, obs, vals):
    """An EnsembleState of ``data`` [v, t, 40, g] on ``grid`` and one
    Observation of variable "x" at ``cells`` at every one of its times
    (``vals`` [t, o]), by IdentityOperator."""
    dev = data.device
    times = torch.arange(data.shape[1], dtype=data.dtype, device=dev)
    state = EnsembleState(data, times=times,
                          grid_coords=torch.as_tensor(grid, device=dev),
                          var_names=("x", "y")[:data.shape[0]])
    observation = Observation(
        torch.as_tensor(vals, dtype=data.dtype, device=dev),
        torch.ones(vals.shape[-1], dtype=data.dtype, device=dev),
        obs_coords=torch.as_tensor(obs, dtype=data.dtype, device=dev),
        times=times,
        operator=IdentityOperator(obs_points=cells, len_grid=grid.shape[0]))
    return state, observation


def window2d_phases(dev, gpu, kinds, launches):
    """Phases 17-20: K6 against its plain version at bench config 7, the
    fused2d analysis at config 7, config 8 through the strips and the
    class API against f64 oracles, and times."""
    loc = GaspariCohn((R2, R2), dist2)
    reg = 39 / INF
    # -- 17. K6 against its plain version at config 7 ----------------------
    w7 = workload_2d(128, 1024, sort_cells=False)
    g7, o7 = w7[4].shape[0], w7[5].shape[0]
    nb7 = exact_nb(k1.max_in_support_2d(w7[5], w7[4], R2, R2))
    blk7 = k1.required_obs_block_2d(w7[5][:, 1], w7[4][:, 1], R2)
    wt7 = [torch.as_tensor(a, device=dev) for a in w7]
    perts7, innov7 = _normalized_obs_space(wt7[0][:, wt7[3].long()], wt7[1],
                                           wt7[2])
    mean7 = wt7[0].mean(0)
    sp7 = wt7[0] - mean7
    # a third coordinate for the extra-radius case: a level per cell
    z = torch.remainder(wt7[4][:, 0] + 2 * wt7[4][:, 1], 3.0)[:, None]
    grid3, obs3 = torch.cat([wt7[4], z], 1), torch.cat([wt7[5], z[wt7[3]]], 1)
    # the window of phase 19's class smoother (two stacked obs times), past
    # the register route
    nb_s = exact_nb(k1.max_in_support_2d(np.tile(w7[5], (2, 1)), w7[4], R2,
                                         R2))
    check(nb_s > k1.K6_REG_MAX_NB, f"smoother window {nb_s} takes the "
          "register route")
    cases = (
        ("banded", blk7, nb7, 1, (), True),
        ("whole table, not strict", o7, nb7, 1, (), False),
        ("whole table, strict", o7, nb7, 1, (), True),
        ("ns 3", blk7, nb7, 3, (), True),
        ("3 coords, extra radius 1.5", blk7, nb7, 1, (1.5,), True),
        (f"strict, nb {nb7 // 2}", blk7, nb7 // 2, 1, (), True),
        (f"nb {nb_s}", blk7, nb_s, 1, (), True),
    )
    notes = []
    err_k6 = 0.0
    routes = set()
    for label, block, nb, ns, extra, strict in cases:
        sp = torch.stack([torch.roll(sp7, s, dims=1) for s in range(ns)])
        mean = torch.stack([mean7 + s for s in range(ns)])
        coords = (obs3, grid3) if extra else (wt7[5], wt7[4])
        args, width = k1.window2d_inputs(perts7, innov7, *coords, sp, mean,
                                         reg, R2, R2, block,
                                         extra_radii=extra)
        kw = dict(width=width, ens_size=40, nb=nb, degree=DEGREE,
                  epsilon=1e-5, taper="gc2", strict=strict)
        _, e, n_nan = k6_vs_plain(args, kw, f"K6 config 7 {label}")
        err_k6 = max(err_k6, e)
        if label.startswith("strict"):
            check(0 < n_nan < g7, f"{label}: {n_nan} NaN columns")
        elif label != "whole table, strict":
            check(n_nan == 0, f"{label}: {n_nan} NaN columns")
        plan = k6_plan(args, kw)
        routes.add(plan["route"])
        notes.append(f"{label} {e!r} ({n_nan} NaN columns; "
                     f"{plan_note(plan)})")
        if label == "banded":
            args7, kw7 = args, kw
    check(routes == set(k1.K6_ROUTES), f"K6 routes taken: {routes}")
    log(17, f"K6 window2d, bench config 7 (128x128, ens 40, obs 1024, GC "
        f"r=4, nb {nb7}, block {blk7}, degree {DEGREE}) against plain, max "
        f"abs err: " + "; ".join(notes))

    # -- 18. fused2d at config 7 against the f64 eigh oracle ---------------
    fused7 = make_letkf_analysis(loc, INF, method="fused2d", max_obs=nb7,
                                 cheb_degree=DEGREE, obs_block=blk7)
    out7, counts = counted(fused7, *wt7)
    check(counts == {"window2d": 1}, f"fused2d launches {counts}")
    w64_7 = [t.double() if t.is_floating_point() else t for t in wt7]
    t0 = time.perf_counter()
    oracle7 = make_letkf_analysis(loc, INF, chunksize=4096,
                                  method="eigh")(*w64_7)
    s_oracle = time.perf_counter() - t0
    _, rel7 = compare(out7, oracle7, "fused2d config 7 vs f64 eigh")
    log(18, f"fused2d config 7 (1 K6 launch) vs the f64 eigh oracle "
        f"({s_oracle:.1f} s): max rel err {rel7!r} (budget {TOL})")

    # -- 19. config 8 through the strips and the class API -----------------
    w8 = workload_2d(1024, 100_000, sort_cells=True)
    g8 = w8[4].shape[0]
    wt8 = [torch.as_tensor(a, device=dev) for a in w8[:3]]
    t0 = time.perf_counter()
    plan = _strip_plan_2d(loc, w8[4], w8[5], 16, None, True)
    s_plan = time.perf_counter() - t0
    perts8, innov8 = _normalized_obs_space(
        wt8[0][:, torch.as_tensor(w8[3], device=dev).long()], wt8[1], wt8[2])
    mean8 = wt8[0].mean(0)
    args8, kw8 = _strip_inputs_2d(plan, perts8, innov8,
                                  (wt8[0] - mean8)[None], mean8[None], reg,
                                  16)
    _, e8, n_nan = k6_vs_plain(args8, kw8, "K6 config 8 strips")
    check(n_nan == 0, f"config 8: {n_nan} NaN columns")
    kinds["window2d"] = {"max_abs_err": max(err_k6, e8)}
    strips = make_strip_letkf_2d(loc, (w8[3], w8[4], w8[5]), n_strips=16,
                                 inf_factor=INF, cheb_degree=16)
    out8, counts = counted(strips, *wt8)
    check(counts == {"window2d": 1}, f"strip analysis launches {counts}")
    launches["window2d"] = counts["window2d"]
    check(tuple(out8.shape) == (40, g8) and bool(torch.isfinite(out8).all()),
          "strip analysis not finite")
    rnd = np.random.RandomState(SEED + 6)
    gs = plan["perm"].shape[0] // 16
    cols = [rnd.choice(np.unique(plan["perm"][s * gs:(s + 1) * gs]), 256,
                       replace=False) for s in range(16)]
    t0 = time.perf_counter()
    oracle8 = sampled_oracle(loc, w8, cols, dev)
    s_oracle8 = time.perf_counter() - t0
    flat = torch.as_tensor(np.concatenate(cols), device=dev)
    _, rel8 = compare(out8[:, flat], oracle8, "strips config 8 vs f64 eigh")
    notes = [f"strips (16, max_obs {plan['max_obs']}, slice {plan['o_bd']}, "
             f"1 K6 launch) on {flat.numel()} columns, 256 per strip: "
             f"{rel8!r}"]
    state8, obs8 = class_2d_inputs(wt8[0][None, None], w8[4], w8[3], w8[5],
                                   w8[1][None])
    letkf8 = LETKF(loc, INF, max_obs=plan["max_obs"], method="fused2d",
                   cheb_degree=16)
    t0 = time.perf_counter()
    out, counts = counted(letkf8.assimilate, state8, obs8)
    s_first = time.perf_counter() - t0
    geometry = letkf8._geometry_cache[1]
    check(counts == {"window2d": 1}, f"class config 8 launches {counts}")
    check(geometry["plan"] is not None
          and geometry["plan"]["n_strips"] == 4, "class auto strips: not 4")
    out, counts = counted(letkf8.assimilate, state8, obs8)
    check(letkf8._geometry_cache[1] is geometry and counts == {"window2d": 1},
          "class config 8: the strip plan was not reused")
    _, rel = compare(out.data[0, 0][:, flat], oracle8,
                     "class config 8 vs f64 eigh")
    notes.append(f"LETKF.assimilate [1, 1, 40, {g8}] auto strips 4 (first "
                 f"call {s_first:.1f} s, then cached), 1 K6 launch: {rel!r}")
    rnd = np.random.RandomState(SEED + 7)
    data = torch.as_tensor(rnd.normal(size=(2, 2, 40, g7)).astype(np.float32),
                           device=dev)
    vals = rnd.normal(size=(2, o7))
    nb_s = exact_nb(k1.max_in_support_2d(np.tile(w7[5], (2, 1)), w7[4], R2,
                                         R2))
    state, obs = class_2d_inputs(data, w7[4], w7[3], w7[5], vals)
    state64, obs64 = class_2d_inputs(data.double(), w7[4], w7[3], w7[5], vals)
    alg = LETKF(loc, INF, max_obs=nb_s, method="fused2d", smoother=True)
    out, counts = counted(alg.assimilate, state, obs)
    check(counts == {"window2d": 1} and alg._geometry_cache[1]["plan"] is None,
          f"class smoother launches {counts}")
    oracle_s = LETKF(loc, INF, smoother=True).assimilate(state64, obs64)
    _, rel = compare(out.data, oracle_s.data, "class smoother vs f64 eigh")
    notes.append(f"smoother [2, 2, 40, {g7}] single kernel (nb {nb_s}, "
                 f"shared route): {rel!r}")
    log(19, f"bench config 8 (1024x1024, ens 40, obs 10^5, 16 strips, "
        f"degree 16; plan {s_plan:.2f} s on the host): K6 vs plain max abs "
        f"err {e8!r} on all {g8} columns ({plan_note(k6_plan(args8, kw8))}); "
        f"against f64 eigh (sampled oracle {s_oracle8:.1f} s): "
        + "; ".join(notes) + f" (budget {TOL})")

    # -- 20. times ---------------------------------------------------------
    def k6(args, kw):
        return lambda: k1.window2d_banded(*args, **kw)

    def plain(args, kw):
        return lambda: k1.window2d_plain(*args, **kw)

    def few(fn):
        return median_ms(fn, reps=5, inner=2, warmup=1)

    ms7, plain7 = paired_ms(k6(args7, kw7), plain(args7, kw7),
                            plain_time=few)
    kinds["window2d"]["ms"], kinds["window2d"]["plain_ms"] = paired_ms(
        k6(args8, kw8), plain(args8, kw8), plain_time=event_ms,
        kernel_time=few)
    kinds["window2d"]["bound"] = bound(
        nbytes(*args8) + nbytes(args8[3]),
        args8[3].shape[-1] * cheb_flops(40, plan["max_obs"], 1, 16))
    bound7 = bound(nbytes(*args7) + nbytes(args7[3]),
                   args7[3].shape[-1] * cheb_flops(40, nb7, 1, DEGREE))
    ms_fused7 = median_ms(lambda: fused7(*wt7), reps=10, inner=3)
    ms_strips = median_ms(lambda: strips(*wt8), reps=5, inner=1, warmup=1)
    ms_class8 = event_ms(lambda: letkf8.assimilate(state8, obs8))
    t = kinds["window2d"]
    log(20, f"window2d config 7 (banded, nb {nb7}): kernel {ms7!r} ms, plain "
        f"{plain7!r} ms, bound {bound7[0]!r} ms ({bound7[1]}); config 8 "
        f"strips (nb {plan['max_obs']}): kernel {t['ms']!r} ms, plain "
        f"{t['plain_ms']!r} ms, bound {t['bound'][0]!r} ms ({t['bound'][1]}) "
        f"[{gpu}]")
    log(20, f"per call: fused2d config 7 {ms_fused7!r} ms = "
        f"{g7 / ms_fused7 * 1e3!r} grid-points/s; strips config 8 "
        f"{ms_strips!r} ms = {g8 / ms_strips * 1e3!r} grid-points/s; "
        f"LETKF.assimilate config 8 {ms_class8!r} ms; the config-8 plan "
        f"{s_plan * 1e3!r} ms on the host [{gpu}]")
    # the class layer's cached geometry: a hit compares the coordinates on
    # the card
    info8 = (state8.grid_info(), obs8.stacked_coords())
    hits = []
    for _ in range(20):
        t0 = time.perf_counter()
        hit = letkf8._fused2d_geometry(*info8)
        hits.append((time.perf_counter() - t0) * 1e3)
        check(hit is geometry, "class config 8: the geometry cache missed")
    notes = [profile_note("fused2d config 7", lambda: fused7(*wt7)),
             profile_note("LETKF.assimilate config 8",
                          lambda: letkf8.assimilate(state8, obs8))]
    log(20, "torch.profiler, 5 calls each: " + "; ".join(notes)
        + f"; geometry cache hit at config 8 {statistics.median(hits)!r} ms "
        f"on the host [{gpu}]")


def twosided(fn, *args):
    """``fn(*args)`` with ``TPU_ASSIM_EIGH_KERNEL=twosided``, restored
    after."""
    old = os.environ.get("TPU_ASSIM_EIGH_KERNEL")
    os.environ["TPU_ASSIM_EIGH_KERNEL"] = "twosided"
    try:
        return fn(*args)
    finally:
        if old is None:
            del os.environ["TPU_ASSIM_EIGH_KERNEL"]
        else:
            os.environ["TPU_ASSIM_EIGH_KERNEL"] = old


def config11_inputs(w, dev, dtype):
    """bench.py config 11's inputs from the headline workload ``w``:
    normalized obs-space perturbations [40, o] and innovations [o], the
    grid and obs info rows, and the state [40, g], in ``dtype`` on
    ``dev``."""
    wt = [torch.as_tensor(x, device=dev) for x in w]
    wt = [t.to(dtype) if t.is_floating_point() else t for t in wt]
    perts, innov = _normalized_obs_space(wt[0][:, wt[3].long()], wt[1], wt[2])
    return perts, innov, _with_time(wt[4]), _with_time(wt[5]), wt[0]


def analysis11(loc, nb, kernel, inputs):
    """The config-11 analysis [40, g]: the LKETKF weights over strict
    window neighborhoods of ``nb`` observations (one eigh of a [g, 40, 40]
    batch), applied to the state, as bench.py's step11."""
    perts, innov, gi, oi, state = inputs
    weights = lk._lketkf_solve(loc, None, "eigh", NS_ITERS, nb, "window",
                               True, kernel, perts, innov, gi, oi, INF)
    mean = state.mean(0)
    return mean + torch.einsum("kg,gkm->mg", state - mean, weights)


def cheb11(loc, nb, kernel, inputs, degree=10):
    """The config-11 analysis [40, g] by the fused Chebyshev solve, as
    bench.py's step11c."""
    perts, innov, gi, oi, state = inputs
    return lk._lketkf_cheb_analysis(loc, None, nb, "window", True, degree,
                                    kernel, perts, innov, gi, oi, INF,
                                    state[None, None])[0, 0]


def config11_grams(loc, nb, kernel, inputs):
    """The double-centred kernel Grams [g, 40, 40] that the config-11
    analysis hands to eigh_psd, and their centred obs vectors [g, 40, 1]."""
    perts, innov, gi, oi, _ = inputs
    idx, sqrt_w = lk._sqrt_taper(loc, nb, "window", True, gi, oi,
                                 perts.dtype)
    scaled = lk._scaled(perts, idx, sqrt_w)
    scaled_obs = lk._scaled(innov[None], idx, sqrt_w)
    gram, qc = center_gram(kernel(scaled, scaled), kernel(scaled, scaled_obs))
    return gram.contiguous(), qc


def analysis_from_evd(qc, ev, vec, state):
    """The config-11 analysis [40, g] from an eigendecomposition ``(ev,
    vec)`` of its Grams, in any order, composed as the eigh route of
    ``ops/etkf.py:etkf_weights_from_gram`` composes it."""
    k = state.shape[0]
    h = torch.clamp(ev, min=0.0) + (k - 1) / INF
    weights = (rev_evd(1.0 / h, vec) @ qc
               + (k - 1) ** 0.5 * rev_evd(1.0 / torch.sqrt(h), vec))
    mean = state.mean(0)
    return mean + torch.einsum("kg,gkm->mg", state - mean, weights)


def with_spectrum(rng, b, evals):
    """``b`` random symmetric matrices with the spectrum ``evals``, f32."""
    k = len(evals)
    q = np.linalg.qr(rng.normal(size=(b, k, k)))[0]
    return np.einsum("bik,k,bjk->bij", q, np.asarray(evals), q).astype(
        np.float32)


def eigh_factors(a, ev, vec):
    """Reconstruction (relative to max|A|) and orthogonality of an
    eigendecomposition, over the matrices without NaN."""
    fin = torch.isfinite(ev).all(-1)
    a, ev, vec = a[fin], ev[fin], vec[fin]
    rec = float((torch.einsum("bik,bk,bjk->bij", vec, ev, vec) - a).abs().max()
                / a.abs().max())
    eye = torch.eye(a.shape[-1], device=a.device)
    return rec, float((vec.mT @ vec - eye).abs().max())


def eigh_vs_plain(a, label, factors=True):
    """K7 through ``eigh_jacobi`` (one counted launch) against its plain
    version on one batch: identical NaN entries in the eigenvalues, and bit
    for bit the same eigenvalues, eigenvectors (of the matrices without NaN)
    and sweeps run; on the matrices without NaN the reconstruction and the
    orthogonality, checked against FACTOR_TOL where ``factors``. Returns a
    dict of the figures and the kernel's output."""
    before = k7.LAUNCHES["eigh_jacobi"]
    ev, vec, run = k7.eigh_jacobi(a, SWEEPS, with_sweeps=True)
    torch.cuda.synchronize()
    check(k7.LAUNCHES["eigh_jacobi"] == before + 1,
          f"{label}: K7 launches {k7.LAUNCHES['eigh_jacobi'] - before}")
    ev_p, vec_p, run_p = k7.eigh_jacobi_plain(a, SWEEPS, with_sweeps=True)
    err, rel = compare(ev, ev_p, f"{label}: eigenvalues")
    fin = torch.isfinite(ev).all(-1)
    rec, orth = eigh_factors(a, ev, vec)
    if factors:
        check(rec <= FACTOR_TOL and orth <= FACTOR_TOL,
              f"{label}: reconstruction {rec!r}, orthogonality {orth!r}")
    f = {"err": err, "rel": rel, "rec": rec, "orth": orth,
         "sweeps": int(torch.clamp(run, max=SWEEPS).max()),
         "capped": int((run > SWEEPS).sum()),
         "same_sweeps": bool(torch.equal(run, run_p)),
         "vec_diff": float((vec[fin] - vec_p[fin]).abs().max()),
         "out": (ev, vec, run)}
    check(f["err"] == 0 and f["vec_diff"] == 0 and f["same_sweeps"],
          f"{label}: K7 not bit for bit its plain version: eigenvalues "
          f"{f['err']!r}, eigenvectors {f['vec_diff']!r}, sweeps identical "
          f"{f['same_sweeps']}")
    return f


def eigh_note(label, f):
    return (f"{label}: eigenvalues {f['err']!r} (rel {f['rel']!r}), "
            f"reconstruction {f['rec']!r}, orthogonality {f['orth']!r}, "
            f"sweeps {f['sweeps']}, {f['capped']} still rotating at the cap; "
            f"vs plain: sweeps identical {f['same_sweeps']}, eigenvectors "
            f"{f['vec_diff']!r}")


def freezes(kp):
    """K7's freeze test and the JAX kernel's, as (name, multiple of eps)."""
    return (("8 eps", k7.FREEZE), ("8 Kp eps", k7.FREEZE * kp))


def freeze_note(a):
    """K7 on one batch at its own freeze test and at the JAX kernel's: mean
    sweeps run, matrices still rotating at the cap, time per launch and
    reconstruction."""
    a = k7._pad_odd(a).contiguous()
    out = []
    for name, freeze in freezes(a.shape[-1]):
        ev, vec, run = k7._launch_eigh(a, SWEEPS, freeze)
        ms = event_ms(lambda: k7._launch_eigh(a, SWEEPS, freeze))
        rec, _ = eigh_factors(a, ev, vec)
        mean = float(torch.clamp(run, max=SWEEPS).float().mean())
        out.append(f"at {name} {mean!r} sweeps, {int((run > SWEEPS).sum())} "
                   f"capped, {ms!r} ms, reconstruction {rec!r}")
    return "freeze test " + " / ".join(out)


def kernelized_phases(dev, gpu, loc, w, kinds, launches):
    """Phases 21-24: K7 against its plain version on [10^4, 40, 40]
    batches, bench config 11 through K3, K7 and cheb and the class API
    against f64 oracles, and times."""
    g = w[0].shape[1]
    nb = exact_nb(k1.max_in_support_1d(w[5][:, 0], w[4][:, 0], RADIUS))
    gauss, tanh = GaussKernel(L11), TanhKernel()
    x32 = config11_inputs(w, dev, torch.float32)

    # -- 21. K7 against its plain version ----------------------------------
    rng = np.random.RandomState(SEED + 8)

    def on_card(x):
        return torch.as_tensor(x, device=dev)

    z = on_card(rng.normal(size=(g, 40, 40)).astype(np.float32)) / 40 ** 0.5
    ties = np.linspace(0.5, 4.0, 20)
    grams, _ = config11_grams(loc, nb, gauss, x32)
    # The cap of 7 sweeps stops the Gauss Grams (a graded spectrum) and the
    # sigma-span batch short of FACTOR_TOL, as it stops the JAX kernel.
    # Their figures at the cap are printed, not checked: that acceptance
    # criterion is not met (PERF.md). Their factors are checked at 12
    # sweeps instead, where the kernel converges.
    batches = [
        ("config-11 Gauss Grams", grams, False),
        ("random SPD", (z @ z.mT).contiguous(), True),
        ("24-fold cluster", on_card(with_spectrum(
            rng, g, np.r_[np.full(24, 2.5), np.linspace(0.1, 9.0, 16)])),
         True),
        ("sigma span 1e4", on_card(with_spectrum(
            rng, g, np.logspace(0, -4, 40))), False),
        ("+-lambda ties", on_card(with_spectrum(rng, g, np.r_[-ties, ties])),
         True),
        ("K=39 SPD", (z[:, :39, :] @ z[:, :39, :].mT).contiguous(), True),
    ]
    notes, err_k7 = [], 0.0
    for label, a, factors in batches:
        f = eigh_vs_plain(a, label, factors)
        err_k7 = max(err_k7, f["err"])
        if not factors:
            ev12, vec12 = k7.eigh_jacobi(a, 12)
            rec12, orth12 = eigh_factors(a, ev12, vec12)
            check(rec12 <= FACTOR_TOL and orth12 <= FACTOR_TOL,
                  f"{label}, 12 sweeps: reconstruction {rec12!r}, "
                  f"orthogonality {orth12!r}")
            f["sweeps"] = (f"{f['sweeps']} (factors at the cap over "
                           f"{FACTOR_TOL}: {f['rec'] > FACTOR_TOL}; at 12 "
                           f"sweeps: reconstruction {rec12!r}, orthogonality "
                           f"{orth12!r})")
        if label == "+-lambda ties":
            e, rel = compare(f["out"][0], torch.as_tensor(
                np.sort(np.r_[-ties, ties]), dtype=torch.float32,
                device=dev).expand(g, 40), "+-lambda ties: spectrum")
            notes.append(eigh_note(label, f)
                         + f", against the exact spectrum {e!r}")
        else:
            notes.append(eigh_note(label, f))
        if label == "config-11 Gauss Grams":
            gram_run = f["out"][2]
            lapack = torch.linalg.eigvalsh(a.double().cpu()).to(dev)
            rel7, rel12 = (float((ev.double() - lapack).abs().max()
                                 / lapack.abs().max())
                           for ev in (f["out"][0], ev12))
            notes[-1] += (f", eigenvalues against f64 LAPACK (not checked) "
                          f"{rel7!r} at the cap, {rel12!r} at 12 sweeps")
        notes[-1] += "; " + freeze_note(a)
    nan_batch = on_card(with_spectrum(rng, 512, np.linspace(-3.0, 5.0, 40)))
    nan_batch[3, 5, 7] = nan_batch[3, 7, 5] = float("nan")
    f = eigh_vs_plain(nan_batch, "NaN batch")
    bad = torch.isnan(f["out"][0]).any(-1)
    check(bool(bad[3]) and int(bad.sum()) == 1,
          f"K7: the NaN spread to {int(bad.sum())} matrices")
    notes.append(f"NaN batch [512]: NaN confined to its matrix, the other "
                 f"511 {f['err']!r} from plain")
    # K7's other layouts (eigh_jacobi_plan): Kp <= 32 (V^T in registers),
    # 32 < Kp <= 42 (V^T's columns past 32 in A's rows), Kp > 42 (two V^T
    # columns a lane); bit for bit its plain version on each
    sizes = (2, 31, 34, 42, 44, 64)
    for k in sizes:
        a = on_card(rng.normal(size=(256, k, k)).astype(np.float32))
        a = (a + a.mT) / 2
        out = k7.eigh_jacobi(a, SWEEPS, with_sweeps=True)
        ref = k7.eigh_jacobi_plain(a, SWEEPS, with_sweeps=True)
        check(all(torch.equal(x, y) for x, y in zip(out, ref)),
              f"K7 at K = {k}: not bit for bit its plain version")
    notes.append(f"K = {', '.join(map(str, sizes))} ([256, K, K] "
                 f"symmetric): bit for bit")
    kinds["eigh_jacobi"] = {"max_abs_err": err_k7}
    log(21, f"K7 eigh_jacobi against plain, [{g}, 40, 40] f32, cap "
        f"{SWEEPS}, every batch bit for bit its plain version (eigenvalues, "
        f"eigenvectors, sweeps run; checked): " + "; ".join(notes))

    # -- 22. config 11 at full width ---------------------------------------
    t0 = time.perf_counter()
    x64 = config11_inputs(w, "cpu", torch.float64)
    oracle = {name: analysis11(loc, nb, kern, x64)
              for name, kern in (("gauss", gauss), ("tanh", tanh))}
    cheb64 = cheb11(loc, nb, gauss, x64)
    s_oracle = time.perf_counter() - t0
    runs = [("eigh via K3", analysis11, gauss, "gauss", {"svd_jacobi": 1},
             False),
            ("eigh via K7", analysis11, gauss, "gauss", {"eigh_jacobi": 1},
             True),
            ("Tanh eigh via K7", analysis11, tanh, "tanh", {"eigh_jacobi": 1},
             True)]
    notes = []
    for label, fn, kern, ref, expected, two in runs:
        args = (fn, loc, nb, kern, x32)
        out, counts = (counted(twosided, *args) if two
                       else counted(*args))
        check(counts == expected, f"config 11 {label}: launches {counts}")
        if label == "eigh via K7":
            launches["eigh_jacobi"] = counts["eigh_jacobi"]
        _, rel = compare(out, oracle[ref].to(dev), f"config 11 {label}")
        notes.append(f"{label} ({counts}) {rel!r}")
    # why K7 freezes at 8 eps, not at the JAX kernel's 8 Kp eps: the Tanh
    # analysis composed from K7's factors of its Grams at each threshold
    # (not checked: the first is the route above)
    tgram, tq = config11_grams(loc, nb, tanh, x32)
    for name, freeze in freezes(tgram.shape[-1]):
        ev, vec, _ = k7._launch_eigh(tgram, SWEEPS, freeze)
        out = analysis_from_evd(tq, ev, vec, x32[4])
        rel = float((out.double().cpu() - oracle["tanh"]).abs().max()
                    / oracle["tanh"].abs().max())
        notes.append(f"Tanh from K7's factors at {name} {rel!r}")
    out, counts = counted(cheb11, loc, nb, gauss, x32)
    check(counts == {}, f"config 11 cheb launched {counts}")
    _, rel = compare(out, cheb64.to(dev), "config 11 cheb vs its f64 run")
    trunc = float((out.double().cpu() - oracle["gauss"]).abs().max()
                  / oracle["gauss"].abs().max())
    notes.append(f"cheb degree 10 against its f64 run {rel!r}, against the "
                 f"exact f64 analysis {trunc!r} (truncation)")
    log(22, f"bench config 11 (ens 40, grid {g}, obs {w[1].shape[0]}, GC "
        f"r={RADIUS}, window nb {nb}, Gauss l={L11}, rho {INF}) against f64 "
        f"on the CPU ({s_oracle:.1f} s): " + "; ".join(notes)
        + f" (budget {TOL})")

    # -- 23. the class API -------------------------------------------------
    state, obs = class_api_inputs(x32[4][None, None], w, 1)
    obs = obs.replace(observations=torch.as_tensor(w[1], device=dev)[None])
    state64, obs64 = class_api_inputs(x64[4][None, None], w, 1)
    obs64 = obs64.replace(observations=torch.as_tensor(
        w[1], dtype=torch.float64)[None])
    notes = []
    alg = LKETKF(loc, gauss, INF, max_obs=nb, selection="window")
    n_chunks = -(-g // alg.chunksize)   # 3 at the chunksize of 4096
    out, counts = counted(twosided, alg.assimilate, state, obs)
    check(counts == {"eigh_jacobi": n_chunks},
          f"class LKETKF launches {counts}")
    ref = LKETKF(loc, gauss, INF, max_obs=nb, selection="window").assimilate(
        state64, obs64)
    _, rel = compare(out.data, ref.data.to(dev), "class LKETKF vs f64")
    notes.append(f"LKETKF.assimilate [1, 1, 40, {g}] twosided, chunks of "
                 f"{alg.chunksize} ({counts}) {rel!r}")
    rnd = np.random.RandomState(SEED + 9)
    data = torch.as_tensor(rnd.normal(size=(2, 3, 40, g)).astype(np.float32),
                           device=dev)
    state_s, obs_s = class_api_inputs(data, w, 3)
    state_s64, obs_s64 = class_api_inputs(data.double().cpu(), w, 3)
    stacked_x = np.sort(np.tile(w[5][:, 0], 3))
    nb_s = exact_nb(k1.max_in_support_1d(stacked_x, w[4][:, 0], RADIUS))
    alg = LKETKF(loc, gauss, INF, smoother=True, method="cheb", max_obs=nb_s)
    ens_obs, filtered = alg._apply_obs_operator(state_s, [obs_s])
    _, perts_s, info_s = alg._get_obs_space_variables(ens_obs, filtered)
    degree = alg._auto_cheb_degree(perts_s, state_s.grid_info(), info_s)
    out, counts = counted(alg.assimilate, state_s, obs_s)
    ref = LKETKF(loc, gauss, INF, smoother=True, method="cheb", max_obs=nb_s,
                 cheb_degree=degree).assimilate(state_s64, obs_s64)
    _, rel = compare(out.data, ref.data.to(dev), "class LKETKF smoother cheb")
    notes.append(f"smoother [2, 3, 40, {g}] cheb (topk nb {nb_s}, auto "
                 f"degree {degree}, {counts or 'no kernel'}) against its f64 "
                 f"run {rel!r}")
    out, counts = counted(KETKF(gauss, INF).assimilate, state, obs)
    ref = KETKF(gauss, INF).assimilate(state64, obs64)
    _, rel = compare(out.data, ref.data.to(dev), "class KETKF config 4")
    notes.append(f"KETKF.assimilate (config 4, global) {rel!r}")
    pre, post = [MultiplicativeInflation(1.2)], [MultiplicativeInflation(1.05)]
    alg = LKETKF(loc, gauss, INF, max_obs=nb, selection="window",
                 pre_transform=pre, post_transform=post)
    out, counts = counted(twosided, alg.assimilate, state, obs)
    check(counts == {"eigh_jacobi": n_chunks},
          f"class inflation launches {counts}")
    ref = LKETKF(loc, gauss, INF, max_obs=nb, selection="window",
                 pre_transform=pre, post_transform=post).assimilate(
        state64, obs64)
    _, rel = compare(out.data, ref.data.to(dev), "class inflation vs f64")
    notes.append(f"LKETKF with MultiplicativeInflation 1.2 pre, 1.05 post "
                 f"({counts}) {rel!r}")
    log(23, "the class API against f64 on the CPU: " + "; ".join(notes)
        + f" (budget {TOL})")

    # -- 24. times ---------------------------------------------------------
    t = kinds["eigh_jacobi"]
    t["ms"], t["plain_ms"] = paired_ms(
        lambda: k7.eigh_jacobi(grams, SWEEPS),
        lambda: k7.eigh_jacobi_plain(grams, SWEEPS), plain_time=event_ms)
    t["library_ms"] = event_ms(lambda: torch.linalg.eigh(grams), reps=1,
                               warmup=0)
    kp = grams.shape[-1] + grams.shape[-1] % 2
    m = kp // 2
    # per round, A symmetric: the two-sided rotation of the 2 x 2 blocks
    # between two pairs in its upper triangle (24 FLOPs each) and of each
    # pair's own block, which it diagonalizes (4); V's two columns per pair
    # (3 Kp^2). Kp - 1 rounds a sweep, the sweeps each matrix ran (the
    # cap's extra count is no sweep).
    per_round = 24 * m * (m - 1) // 2 + 4 * m + 3 * kp * kp
    sweeps_run = int(torch.clamp(gram_run, max=SWEEPS).sum())
    t["bound"] = bound(nbytes(grams) * 2 + grams.shape[0] * kp * 4,
                       sweeps_run * (kp - 1) * per_round)
    # the kernel alone (no sort) on the Grams and on the class API's chunk
    # shape, [4096, 40, 40] (the first 4096 Grams): time per matrix-round
    # (sweeps each matrix ran x (Kp - 1) rounds) over the card and per SM,
    # and the factor over the bound
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    notes = []
    for a, a_run in ((grams, gram_run),
                     (grams[:4096].contiguous(), gram_run[:4096])):
        rounds = int(torch.clamp(a_run, max=SWEEPS).sum()) * (kp - 1)
        b_ms, by = bound(nbytes(a) * 2 + a.shape[0] * kp * 4,
                         rounds * per_round)
        alone = median_ms(lambda: k7._launch_eigh(a, SWEEPS))
        notes.append(
            f"[{a.shape[0]}, 40, 40]: kernel alone {alone!r} ms = "
            f"{alone * 1e6 / rounds!r} ns a matrix-round over the card, "
            f"{alone * 1e6 * sms / rounds!r} ns on one of {sms} SMs; "
            f"{alone / b_ms!r} x its bound {b_ms!r} ms ({by})")
    per_call = {}
    for label, fn in (
            ("eigh via K3", lambda: analysis11(loc, nb, gauss, x32)),
            ("eigh via K7", lambda: twosided(analysis11, loc, nb, gauss,
                                             x32)),
            ("cheb", lambda: cheb11(loc, nb, gauss, x32)),
            ("LKETKF.assimilate via K7 (3 chunks)", lambda: twosided(
                LKETKF(loc, gauss, INF, max_obs=nb,
                       selection="window").assimilate, state, obs))):
        per_call[label] = median_ms(fn, reps=10, inner=3)
    log(24, f"eigh_jacobi [{g}, 40, 40] config-11 Grams: kernel {t['ms']!r} "
        f"ms, plain {t['plain_ms']!r} ms, torch.linalg.eigh "
        f"{t['library_ms']!r} ms (one call), bound {t['bound'][0]!r} ms "
        f"({t['bound'][1]}) at {sweeps_run / grams.shape[0]!r} sweeps per "
        f"matrix on average [{gpu}]")
    log(24, "K7 on the config-11 Grams: " + "; ".join(notes) + f" [{gpu}]")
    log(24, "config-11 analysis per call: " + "; ".join(
        f"{k} {v!r} ms = {g / v * 1e3!r} grid-points/s"
        for k, v in per_call.items()) + f" [{gpu}]")
    wall, busy, rows = device_profile(
        lambda: twosided(analysis11, loc, nb, gauss, x32))
    check(busy > 0, "profile config 11: no device time recorded")
    k7_ms = sum(ms for name, ms, _ in rows if "eigh_jacobi" in name)
    top = ", ".join(f"{name[:48]} {ms!r}" for name, ms, _ in rows[:5])
    log(24, f"torch.profiler, 5 calls of the config-11 analysis via K7: wall "
        f"{wall!r} ms/call, device {busy!r} ms/call (idle "
        f"{1 - busy / wall:.1%}), K7 {k7_ms!r} ms/call = "
        f"{k7_ms / busy:.1%} of device time; kernels, ms/call: {top} [{gpu}]")


N_SHARDS = 8        # virtual shards of the one card
G3, O3 = 10240, 1024  # bench config 3: grid columns and observations


def k8_vs_plain(rng, dev, n, rows, cols, halo, dtype=torch.float32):
    """K8 through ``ring_halo_rdma`` (one counted launch) against
    ``ring_halo_plain`` on ``n`` random blocks [rows, cols] on the card,
    bit for bit; returns the blocks."""
    blocks = [torch.as_tensor(rng.normal(size=(rows, cols)), dtype=dtype,
                              device=dev) for _ in range(n)]
    before = k8.LAUNCHES["halo_ring"]
    out = k8.ring_halo_rdma(blocks, n, halo)
    torch.cuda.synchronize()
    check(k8.LAUNCHES["halo_ring"] == before + 1,
          f"K8 n={n} halo={halo}: {k8.LAUNCHES['halo_ring'] - before} "
          "launches, not 1")
    ref = k8.ring_halo_plain(blocks, n, halo)
    check(all(torch.equal(a, b) for a, b in zip(out, ref)),
          f"K8 n={n} rows={rows} cols={cols} halo={halo} {dtype}: not bit "
          "for bit its plain version")
    return blocks


def halo2d_sizes(obs, valid, grid, m_rows, m_cols, halo, radius):
    """The window size and obs block of the 2-D halo window analysis: per
    tile, over the valid obs of its tile neighbourhood (wrapped tiles are
    masked out) and its local grid, the in-support maximum (``exact_nb``
    of it) and the y-band width of its 128-column tiles."""
    tr, tc = grid.shape[0] // m_rows, grid.shape[1] // m_cols
    p = obs.shape[0] // (m_rows * m_cols)
    worst, block = 0, 8
    for i in range(m_rows):
        for j in range(m_cols):
            tiles = [si * m_cols + sj
                     for si in range(max(i - halo, 0),
                                     min(i + halo + 1, m_rows))
                     for sj in range(max(j - halo, 0),
                                     min(j + halo + 1, m_cols))]
            cxy = np.concatenate([obs[t * p:(t + 1) * p][
                valid[t * p:(t + 1) * p] > 0] for t in tiles])
            gloc = grid[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc].reshape(
                tr * tc, -1)
            worst = max(worst, k1.max_in_support_2d(cxy, gloc, radius,
                                                    radius))
            block = max(block, k1.required_obs_block_2d(cxy[:, 1],
                                                        gloc[:, 1], radius))
    return exact_nb(worst), block


def k8_times(blocks, halo):
    """K8 and its plain version per call: the device time of their kernels
    (torch.profiler windows of 20 calls, in turns plain, kernel, kernel,
    plain; a call's host work takes longer than K8 at these sizes, so CUDA
    events around back-to-back calls time the host), the time per call
    between CUDA events, and the bound: each input read once, each output
    written once. Returns ``(kernel ms, plain ms, kernel event ms, plain
    event ms, bound, bytes)``."""
    n = len(blocks)
    n_slots = 1 + len(k8._halo_offsets(n, halo))
    kernel = (lambda: k8.ring_halo_rdma(blocks, n, halo))
    plain = (lambda: k8.ring_halo_plain(blocks, n, halo))
    busy = {kernel: [], plain: []}
    for fn in (plain, kernel, kernel, plain):
        _, ms, rows = device_profile(fn, calls=20)
        if fn is kernel:
            ms = sum(t for name, t, _ in rows if "halo_ring" in name)
            check(ms > 0, f"K8 profile: no halo_ring kernel in {rows}")
        busy[fn].append(ms)
    ev_kernel, ev_plain = paired_ms(kernel, plain)
    moved = nbytes(*blocks) * (1 + n_slots)
    return (statistics.mean(busy[kernel]), statistics.mean(busy[plain]),
            ev_kernel, ev_plain, bound(moved, 0), moved)


def config3():
    """Bench config 3 for the halo analyses: the workload (ens 40, grid
    10 240, 1 024 obs), the halo analysis's whole arguments over 8 shards
    (numpy) and its options (the exact window, halo, degree)."""
    w3 = build_workload(40, G3, O3)
    sh = shard_observations(w3[1], w3[2], w3[3], w3[5], G3, N_SHARDS)
    nb3 = exact_nb(_halo_max_in_support(sh[3], sh[4], N_SHARDS, RADIUS,
                                        "gc2", 1e-5, 1))
    opts = dict(max_obs=nb3, inf_factor=INF, cheb_degree=DEGREE,
                halo_width=halo_width_for(RADIUS, G3 / N_SHARDS))
    return w3, (w3[0],) + sh[:5] + (w3[4],), opts


def halo_phases(dev, gpu, kinds, launches):
    """Phases 25-27: K8 against its plain version, the obs-sharded halo
    analyses over 8 virtual shards of the card (bench configs 3 and 7)
    against f64 oracles, and times. Returns phase 26's config-3 window and
    top-k (ppermute) analyses, their functions and arguments."""
    rng = np.random.RandomState(SEED + 10)
    # -- 25. K8 against its plain version ----------------------------------
    # bench config 3: 8 shards of 128 obs, packed rows k + 3 = 43
    cases = [(N_SHARDS, 43, 128, 1, torch.float32),
             (N_SHARDS, 43, 128, 2, torch.float32),
             (2, 43, 128, 1, torch.float32),          # +1 and -1 alias
             (3, 43, 128, 2, torch.float32),          # +-1 and -+2 alias
             (N_SHARDS, 43, 128, 1, torch.float64),
             (N_SHARDS, 43, 125, 2, torch.float32)]   # 4-byte route
    blocks3 = k8_vs_plain(rng, dev, *cases[0])
    for case in cases[1:]:
        k8_vs_plain(rng, dev, *case)
    kinds["halo_ring"] = {"max_abs_err": 0.0}
    log(25, "K8 halo_ring against plain, bit for bit (torch.equal), one "
        "launch each: " + "; ".join(
            f"{n} shards [{rows}, {cols}] halo {halo} "
            f"{str(dtype).split('.')[-1]}"
            for n, rows, cols, halo, dtype in cases))

    # -- 26. the halo analyses on 8 virtual shards -------------------------
    g3, o3 = G3, O3
    w3, whole3, opts = config3()
    nb3, hw = opts["max_obs"], opts["halo_width"]
    mesh = make_grid_mesh(N_SHARDS, devices=[dev] * N_SHARDS)
    args3 = [torch.as_tensor(a, device=dev) for a in whole3]
    loc = GaspariCohn((RADIUS,), coord1_distance)
    window3 = halo_letkf_analysis(mesh, loc, local_method="window", **opts)
    rdma3 = halo_letkf_analysis(mesh, loc, use_pallas=True, comm="rdma",
                                **opts)
    ppermute3 = halo_letkf_analysis(mesh, loc, use_pallas=True, **opts)
    wt3 = [torch.as_tensor(a, device=dev) for a in w3]
    w64_3 = [t.double() if t.is_floating_point() else t for t in wt3]
    t0 = time.perf_counter()
    oracle3 = make_letkf_analysis(loc, INF, chunksize=1024,
                                  method="eigh")(*w64_3)
    s_oracle3 = time.perf_counter() - t0
    notes = []
    out_w, counts = counted(window3, *args3)
    check(counts == {"window1d": N_SHARDS}, f"halo window launches {counts}")
    _, rel_w = compare(out_w, oracle3, "halo window config 3 vs f64 eigh")
    fused = make_letkf_analysis(loc, INF, method="fused1d", max_obs=nb3,
                                cheb_degree=DEGREE)(*wt3)
    d_fused = float((out_w - fused).abs().max() / fused.abs().max())
    notes.append(f"window (nb {nb3}, {counts}) {rel_w!r}; against the "
                 f"unsharded fused1d {d_fused!r}")
    out_r, counts = counted(rdma3, *args3)
    check(counts == {"halo_ring": 1, "nbh_cheb": N_SHARDS},
          f"halo rdma launches {counts}")
    launches["halo_ring"] = counts.get("halo_ring", 0)
    out_p, counts_p = counted(ppermute3, *args3)
    check(counts_p == {"nbh_cheb": N_SHARDS},
          f"halo ppermute launches {counts_p}")
    check(torch.equal(out_r, out_p), "halo rdma differs from ppermute")
    _, rel_r = compare(out_r, oracle3, "halo rdma config 3 vs f64 eigh")
    notes.append(f"top-k use_pallas comm=rdma ({counts}) {rel_r!r}, equal "
                 f"to comm=ppermute ({counts_p})")
    # bench config 7 on a 2 x 4 tile mesh: cell (row, col), coords (x, y)
    w7 = workload_2d(128, 1024, sort_cells=False)
    n7, m_rows, m_cols = 128, 2, 4
    obs_ij = np.stack([w7[3] // n7, w7[3] % n7], 1).astype(np.int32)
    grid7 = w7[4].reshape(n7, n7, 2)
    sh7 = shard_observations_2d(w7[1], w7[2], obs_ij, w7[5], (n7, n7),
                                (m_rows, m_cols))
    nb7, blk7 = halo2d_sizes(sh7[3], sh7[4], grid7, m_rows, m_cols, 1, R2)
    mesh7 = Mesh(np.asarray([dev] * N_SHARDS, dtype=object).reshape(
        m_rows, m_cols), ("row", "col"))
    loc2 = GaspariCohn((R2, R2), dist2)
    window7 = halo_letkf_analysis_2d(
        mesh7, loc2, max_obs=nb7, grid_shape=(n7, n7), halo=(1, 1),
        inf_factor=INF, cheb_degree=DEGREE, local_method="window",
        obs_block=blk7)
    args7 = [torch.as_tensor(a, device=dev) for a in (
        w7[0].reshape(40, n7, n7),) + sh7[:5] + (grid7,)]
    out7, counts = counted(window7, *args7)
    check(counts == {"window2d": N_SHARDS}, f"halo 2-D launches {counts}")
    wt7 = [torch.as_tensor(a, device=dev) for a in w7]
    w64_7 = [t.double() if t.is_floating_point() else t for t in wt7]
    t0 = time.perf_counter()
    oracle7 = make_letkf_analysis(loc2, INF, chunksize=4096,
                                  method="eigh")(*w64_7)
    s_oracle7 = time.perf_counter() - t0
    _, rel7 = compare(out7.reshape(40, -1), oracle7,
                      "halo 2-D window config 7 vs f64 eigh")
    notes.append(f"config 7 on a 2 x 4 tile mesh, window (nb {nb7}, obs "
                 f"block {blk7}, {counts}) {rel7!r}")
    log(26, f"halo analyses on {N_SHARDS} virtual shards of one card, "
        f"config 3 (ens 40, grid {g3}, obs {o3}, GC r={RADIUS}, halo {hw}, "
        f"degree {DEGREE}; f64 oracle {s_oracle3:.1f} s) and config 7 (f64 "
        f"oracle {s_oracle7:.1f} s) against f64 eigh: " + "; ".join(notes)
        + f" (budget {TOL})")

    # -- 27. times -----------------------------------------------------------
    big = [torch.as_tensor(rng.normal(size=(103, 8192)), dtype=torch.float32,
                           device=dev) for _ in range(N_SHARDS)]
    notes = []
    for label, blocks, halo in (("config 3 [43, 128] x 8", blocks3, hw),
                                ("[103, 8192] x 8", big, 1),
                                ("[103, 8192] x 8", big, 2)):
        ms, plain, ev, ev_plain, b, moved = k8_times(blocks, halo)
        if blocks is blocks3:
            kinds["halo_ring"].update(ms=ms, plain_ms=plain, bound=b,
                                      device_ms=ms)
        notes.append(
            f"{label} halo {halo}: device time kernel {ms!r} ms "
            f"({moved / ms / 1e9!r} TB/s), plain {plain!r} ms; per call "
            f"(CUDA events) kernel {ev!r} ms, plain {ev_plain!r} ms; bound "
            f"{b[0]!r} ms ({moved} bytes)")
    log(27, "halo_ring: " + "; ".join(notes) + f" [{gpu}]")
    per_call = []
    for label, fn, args, g in (
            ("config 3 window (K1)", window3, args3, g3),
            ("config 3 top-k rdma (K8 + K4)", rdma3, args3, g3),
            ("config 3 top-k ppermute (K4)", ppermute3, args3, g3),
            ("config 7 2 x 4 window (K6)", window7, args7, n7 * n7)):
        ms = median_ms(lambda: fn(*args), reps=10, inner=3)
        per_call.append(f"{label} {ms!r} ms = {g / ms * 1e3!r} grid-points/s")
    log(27, f"halo analyses per call, {N_SHARDS} virtual shards on one card "
        "(not a multi-GPU figure): " + "; ".join(per_call) + f" [{gpu}]")
    notes = [profile_note("config 3 window", lambda: window3(*args3)),
             profile_note("config 3 top-k rdma", lambda: rdma3(*args3)),
             profile_note("config 7 2 x 4 window", lambda: window7(*args7))]
    _, _, rows = device_profile(lambda: window7(*args7))
    k6_ms = sum(ms for name, ms, _ in rows if "window2d" in name)
    check(k6_ms > 0, f"profile config 7 tiles: no K6 kernel in {rows}")
    notes.append(f"K6 over the 8 tiles of config 7 {k6_ms!r} ms of device "
                 f"time per call")
    log(27, "torch.profiler, 5 calls each: " + "; ".join(notes) + f" [{gpu}]")
    return {"window": out_w, "pallas": out_p, "rdma": out_r,
            "window_fn": window3, "pallas_fn": ppermute3, "args": args3}


# -- 32. the grid-sharded localized IEnKS -------------------------------------

SHARD_TOL = 1e-6    # the sharded step against the unsharded one, of max
SHARDS32 = 8        # virtual shards of the card in phase 32
L96_DT, L96_STEPS = 0.05, 4


def config9_step(mesh, loc, nb, kind):
    """The sharded localized IEnKS at bench config 9: 4 RK4 steps of
    Lorenz-96, 2 outer iterations, tau 1, the exact window ``nb``."""
    return sharded_lienks_step(mesh, loc, RK4Integrator(Lorenz96(), L96_DT),
                               L96_STEPS, n_outer=2, kind=kind, tau=1.0,
                               max_obs=nb, selection="window")


def batch_invariance(dev):
    """Whether a batched matrix-vector product [10^4, 40, 8] x [10^4, 1,
    8]^T, the shape of the IEnKS inner step's gradient, computed as 8
    batches of 1250 equals it computed at once, bit for bit: through
    cuBLAS's batched gemv (an einsum) and through ``ienks._matvec``."""
    rng = np.random.RandomState(SEED + 32)
    x, y = (torch.as_tensor(rng.normal(size=(10000, rows, 8)).astype(
        np.float32), device=dev) for rows in (40, 1))
    gemv = lambda a, b: torch.einsum("...kl,...ml->...km", a, b)  # noqa
    same = []
    for fn in (gemv, ienks._matvec):
        parts = [fn(x[i:i + 1250], y[i:i + 1250])
                 for i in range(0, 10000, 1250)]
        same.append(bool(torch.equal(torch.cat(parts), fn(x, y))))
    return same


def host_calls(fn, calls=3):
    """Per call of ``fn``, under torch.profiler's CPU activity: the kernel
    launches the host made and the host ms of each K3 call (its
    ``autograd.Function``, ``_SVDJacobi``), None without one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key.startswith("cudaLaunchKernel"))
    k3_ms = [e.cpu_time_total / e.count / 1e3 for e in events
             if e.key == "_SVDJacobi"]
    return launches / calls, (k3_ms[0] if k3_ms else None)


def sharded_smoother_phase(dev, gpu, loc, w, nb, out10, out_b, oracle10,
                           ms_step):
    """Phase 32: bench config 9 through the grid-sharded step over 8
    virtual shards of the card, both kinds: K2 and K3 on every shard
    (launches checked), against phase 10's unsharded step (1e-6 of max,
    the same NaN columns) and the transform against its f64 step (1e-5);
    times beside the unsharded step's, profiler windows, the host's
    launches; whether the inner step's matrix-vector product depends on the
    batch (cuBLAS's gemv, and ``ienks._matvec``, which must not). Returns
    the two results, which phase 30's processes must equal bit for bit."""
    t_phase = time.perf_counter()
    wt = [torch.as_tensor(x, device=dev) for x in w]
    mesh = make_grid_mesh(SHARDS32, devices=[dev] * SHARDS32)
    expected = {"rk4_l96": 2 * SHARDS32, "svd_jacobi": 4 * SHARDS32}
    refs, notes = {}, []
    for kind, unsharded in (("transform", out10), ("bundle", out_b)):
        step = config9_step(mesh, loc, nb, kind)
        out, counts = counted(step, *wt)
        check(counts == expected, f"sharded {kind} launches {counts}")
        check(torch.equal(torch.isnan(out), torch.isnan(unsharded)),
              f"sharded {kind}: NaN entries differ from the unsharded step")
        ok = ~torch.isnan(unsharded)
        err = float((out[ok] - unsharded[ok]).abs().max()
                    / unsharded[ok].abs().max())
        check(err <= SHARD_TOL, f"sharded {kind} against the unsharded step "
              f"{err!r} > {SHARD_TOL}")
        bits = "" if torch.equal(out[ok], unsharded[ok]) else "not "
        note = (f"{kind}: launches {counts}, against the unsharded step "
                f"{err!r} of max ({bits}bit for bit), "
                f"{int(torch.isnan(out).any(0).sum())} NaN columns as it")
        if kind == "transform":
            _, rel64 = compare(out, oracle10, "sharded transform vs f64 step")
            note += f"; against the f64 step {rel64!r} (budget {TOL})"
        notes.append(note)
        refs[kind] = out
    g = wt[0].shape[1]
    log(32, f"the grid-sharded localized IEnKS (config 9: ens 40, grid {g}, "
        f"obs {wt[1].shape[0]}, GC r={RADIUS}, 2 outer, {L96_STEPS}xRK4, "
        f"max_obs {nb} window) over {SHARDS32} virtual shards of the card, "
        f"{g // SHARDS32} columns each: " + "; ".join(notes))
    step = config9_step(mesh, loc, nb, "transform")
    local = make_lienks_step(loc, RK4Integrator(Lorenz96(), L96_DT),
                             L96_STEPS, n_outer=2, tau=1.0, max_obs=nb,
                             selection="window")
    three = lambda fn: median_ms(fn, reps=10, inner=3)       # noqa: E731
    ms_sharded, ms_unsharded = paired_ms(
        lambda: step(*wt), lambda: local(*wt), plain_time=three,
        kernel_time=three)
    log(32, f"transform step, CUDA events around 3 back-to-back steps, "
        f"median of 10, in turns: sharded {ms_sharded!r} ms = "
        f"{g / ms_sharded * 1e3!r} grid-points/s, unsharded "
        f"{ms_unsharded!r} ms (phase 11: {ms_step!r} ms) [{gpu}]")
    hosts = {name: host_calls(fn) for name, fn in (
        ("sharded", lambda: step(*wt)), ("unsharded", lambda: local(*wt)))}
    gemv_same, matvec_same = batch_invariance(dev)
    check(matvec_same, "ienks._matvec: 8 batches of 1250 differ from one "
          "of 10^4")
    log(32, "torch.profiler, 5 calls each: "
        + profile_note("sharded step", lambda: step(*wt)) + "; "
        + profile_note("unsharded step", lambda: local(*wt))
        + "; host (torch.profiler CPU activity, 3 calls): " + "; ".join(
            f"{name} {n!r} kernel launches a step, {k3!r} ms a K3 call"
            for name, (n, k3) in hosts.items())
        + f"; [10^4, 40, 8] x [10^4, 1, 8]^T in 8 batches of 1250 equal to "
        f"one of 10^4: cuBLAS's batched gemv {gemv_same}, ienks._matvec "
        f"{matvec_same}; phase {time.perf_counter() - t_phase:.1f} s "
        f"[{gpu}]")
    return refs


# -- 33. the driver entry points and the members x grid cycle ----------------

ENS33, GRID33 = 2, 4    # the (ens, grid) mesh of phase 33(c), virtual shards


def config6_cycle(mesh, loc):
    """Bench config 6's cycle step (4 RK4 steps of Lorenz-96, dt 0.05, the
    dense localized analysis, inflation 1.1) with the forecast sharded
    over members x grid and the analysis over both mesh axes."""
    return sharded_cycle_step(mesh, RK4Integrator(Lorenz96(), L96_DT),
                              L96_STEPS, loc, INF)


def entry_phase(dev, gpu, loc, w):
    """Phase 33: (a) ``entry()`` on the card, {rk4_l96: 1, svd_jacobi: 1},
    against its f64 step; (b) ``dryrun_multichip(8)`` over 8 virtual shards
    of the card, every check of it, with its launches; (c) config 6's
    workload through the members x grid sharded cycle over a 2 x 4 mesh of
    virtual shards (K2 on each position's [20, 2500 + 48] segment, K3 on
    each analysis shard's [1250, 40, 40]), against the unsharded
    ``make_cycle_step`` (the same NaN columns, 1e-6 of max; whether bit
    for bit) and its f64 step (1e-5), times in turns with the unsharded
    step, profiler windows and the host's launches a step. Returns 33(c)'s
    result, which phase 30's processes must equal bit for bit."""
    t_phase = time.perf_counter()
    step, args = driver.entry()
    out, counts = counted(step, *args)
    check(counts == {"rk4_l96": 1, "svd_jacobi": 1},
          f"entry() launches {counts}")
    step64, args64 = driver.entry(dtype="float64")
    ref, counts64 = counted(step64, *args64)
    check(counts64 == {}, f"entry()'s f64 step launched {counts64}")
    err_a, rel_a = compare(out, ref, "entry() against its f64 step")
    t0 = time.perf_counter()
    _, counts_b = counted(driver.dryrun_multichip, 8)
    s_dry = time.perf_counter() - t0
    check(all(counts_b.get(n) for n in ("rk4_l96", "window1d", "halo_ring")),
          f"dryrun_multichip(8) launches {counts_b}")
    log(33, f"(a) entry() (ens 20, grid 256, 64 obs, GC r=8, 4xRK4, "
        f"inflation 1.1) on the card: launches {counts}, {tuple(out.shape)}, "
        f"against its f64 step {err_a!r} ({rel_a!r} of max, budget {TOL}); "
        f"(b) dryrun_multichip(8) over 8 virtual shards of the card "
        f"(members x grid step on 2 x 4, halo top-k ppermute and rdma bit "
        f"for bit, window within 1e-3 of top-k, sharded IEnKS within 1e-5, "
        f"2-D halo on 2 x 4 tiles): every check held in {s_dry:.2f} s, "
        f"launches {counts_b} [{gpu}]")

    wt = [torch.as_tensor(x, device=dev) for x in w]
    mesh = make_forecast_analysis_mesh(ENS33, GRID33,
                                       devices=[dev] * (ENS33 * GRID33))
    step = config6_cycle(mesh, loc)
    out, counts = counted(step, *wt)
    n = ENS33 * GRID33
    check(counts == {"rk4_l96": n, "svd_jacobi": n},
          f"sharded cycle launches {counts}")
    local = make_cycle_step(RK4Integrator(Lorenz96(), L96_DT), L96_STEPS,
                            loc, inf_factor=INF)
    ref, counts_l = counted(local, *wt)
    check(counts_l == {"rk4_l96": 1, "svd_jacobi": 1},
          f"unsharded cycle launches {counts_l}")
    check(torch.equal(torch.isnan(out), torch.isnan(ref)),
          "sharded cycle: NaN entries differ from the unsharded step")
    ok = ~torch.isnan(ref)
    err = float((out[ok] - ref[ok]).abs().max() / ref[ok].abs().max())
    check(err <= SHARD_TOL, f"sharded cycle against the unsharded step "
          f"{err!r} > {SHARD_TOL}")
    bits = "" if torch.equal(out[ok], ref[ok]) else "not "
    w64 = [t.double() if t.is_floating_point() else t for t in wt]
    oracle, counts64 = counted(local, *w64)
    check(counts64 == {}, f"the f64 cycle launched {counts64}")
    _, rel64 = compare(out, oracle, "sharded cycle vs f64 step")
    g, k = wt[0].shape[1], wt[0].shape[0]
    log(33, f"(c) config 6's workload (ens {k}, grid {g}, obs "
        f"{wt[1].shape[0]}, GC r={RADIUS}, {L96_STEPS}xRK4 dt {L96_DT}, "
        f"inflation {INF}, dense analysis) through the members x grid cycle "
        f"over a {ENS33} x {GRID33} mesh of virtual shards of the card (K2 "
        f"on [{k // ENS33}, {g // GRID33} + {12 * L96_STEPS}] a position, "
        f"K3 on [{g // n}, {k}, {k}] an analysis shard): launches {counts} "
        f"(unsharded {counts_l}); against the unsharded step {err!r} of max "
        f"({bits}bit for bit), {int(torch.isnan(out).any(0).sum())} NaN "
        f"columns as it; against the f64 step {rel64!r} (budget {TOL}) "
        f"[{gpu}]")
    three = lambda fn: median_ms(fn, reps=10, inner=3)       # noqa: E731
    ms_sharded, ms_unsharded = paired_ms(
        lambda: step(*wt), lambda: local(*wt), plain_time=three,
        kernel_time=three)
    hosts = {name: host_calls(fn)[0] for name, fn in (
        ("sharded", lambda: step(*wt)), ("unsharded", lambda: local(*wt)))}
    log(33, f"(c) cycle step, CUDA events around 3 back-to-back steps, "
        f"median of 10, in turns: sharded {ms_sharded!r} ms = "
        f"{g / ms_sharded * 1e3!r} grid-points/s, unsharded {ms_unsharded!r} "
        f"ms = {g / ms_unsharded * 1e3!r} grid-points/s; torch.profiler, 5 "
        f"calls each: " + profile_note("sharded step", lambda: step(*wt))
        + "; " + profile_note("unsharded step", lambda: local(*wt))
        + "; host (torch.profiler CPU activity, 3 calls): " + "; ".join(
            f"{name} {launches!r} kernel launches a step"
            for name, launches in hosts.items())
        + f"; phase {time.perf_counter() - t_phase:.1f} s [{gpu}]")
    return out


# -- 30. the halo LETKF across processes --------------------------------------

GROUP_TIMEOUT = 60   # s: the process groups' timeout
CHILD_LIMIT = 240    # s: each child process's hard limit
LOADER_LIMIT = 60    # s: the 200 loader passes
LOADER_PASSES = 200
SPLIT3 = (1, 0, 0, 0, 0, 0, 0)  # the split dim of each halo argument


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def child(*args):
    """This script started again with ``args`` (a worker mode)."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *map(str, args)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def join(procs, limit):
    """Waits for every child up to ``limit`` seconds in all; kills them all
    and fails on expiry or on a child that failed. Returns their output."""
    deadline = time.perf_counter() + limit
    outs = []
    try:
        for label, proc in procs:
            out, err = proc.communicate(
                timeout=max(deadline - time.perf_counter(), 1))
            check(proc.returncode == 0, f"{label} exited {proc.returncode}: "
                  + err[-3000:])
            outs.append(out)
    except subprocess.TimeoutExpired:
        for _, proc in procs:
            proc.kill()
            proc.communicate()
        raise AssertionError(f"{[label for label, _ in procs]} outlived "
                             f"their {limit} s limit and were killed")
    return outs


def config3_obs_space(w3, dev):
    """Config 3's replicated obs space for the grid-sharded weights:
    (perts, innovations, grid info, obs info) on ``dev``."""
    state = torch.as_tensor(w3[0], device=dev)
    idx = torch.as_tensor(w3[3], device=dev).long()
    perts, innov = _normalized_obs_space(
        state[:, idx], *(torch.as_tensor(a, device=dev) for a in w3[1:3]))
    return (perts, innov, _with_time(torch.as_tensor(w3[4], device=dev)),
            _with_time(torch.as_tensor(w3[5], device=dev)))


def synced_ms(fn, args, reps=10):
    """Median ms per call of ``fn(*args)``, each call between barriers of
    every process (their cost included)."""
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def copies_and(keys, fn, args):
    """The copies and the kernels named by ``keys`` in one torch.profiler
    window over one call of ``fn(*args)``, a collective of every process
    (``device_profile`` without a retake): ``{name: (ms, count)}``."""
    _, _, rows = device_profile(lambda: fn(*args), calls=1, retakes=0)
    return {name: (ms, n) for name, ms, n in rows
            if "Memcpy" in name or any(key in name for key in keys)}


def in_turns(fns, args, reps=10):
    """``synced_ms`` of each of ``fns`` (name -> function) in turns, first
    to last and back: name -> the two medians."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(synced_ms(fns[name], args, reps))
    return times


def phase30_worker(rank, port, out):
    """Rank ``rank`` of two processes (gloo) that share the card, 4
    virtual shards each: the config-3 halo analyses (window through K1,
    top-k through K4, ppermute and rdma through K8 over CUDA IPC) from
    this process's blocks and from whole tensors, with the launches of
    each; a profiler window of each top-k exchange's copies; the rdma and
    ppermute calls and exchanges (config 3, [103, 8192] x 8) timed in
    turns; phase 32's sharded smoother and phase 33(c)'s members x grid
    cycle (owners by grid half) from blocks and from whole tensors, timed
    between barriers; the grid-sharded weights saved by DCP; comm="rdma"
    raising once the two processes claim two hosts; results and times to
    ``out``."""
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize_multihost(f"tcp://localhost:{port}", 2, rank,
                                   timeout=GROUP_TIMEOUT)
    report = {"backend": torch.distributed.get_backend()}
    mesh = multihost.global_grid_mesh(devices=[dev] * 4)
    owners = mesh.owners.tolist()
    check(owners == [0] * 4 + [1] * 4, f"owners {mesh.owners}")
    report["info"] = multihost.process_info(devices=[dev] * 4)
    w3, whole3, opts = config3()
    loc = GaspariCohn((RADIUS,), coord1_distance)

    def local(a, dim):
        a = torch.as_tensor(a)
        half = a.shape[dim] // 2
        return a.narrow(dim, rank * half, half)

    blocks = [multihost.host_local_to_global(mesh, local(a, d), axis=d)
              for a, d in zip(whole3, SPLIT3)]
    whole = [torch.as_tensor(a, device=dev) for a in whole3]
    results, fns = {}, {}
    for name, kw in (("window", dict(local_method="window")),
                     ("pallas", dict(use_pallas=True)),
                     ("rdma", dict(use_pallas=True, comm="rdma"))):
        fn = fns[name] = halo_letkf_analysis(mesh, loc, **kw, **opts)
        got, report[name + "_launches"] = counted(fn, *blocks)
        check(isinstance(got, multihost.GlobalTensor)
              and sorted(got.blocks) == [(s,) for s in
                                         range(4 * rank, 4 * rank + 4)],
              f"{name}: this process's blocks are {sorted(got.blocks)}")
        results[name] = got.gather().cpu()
        got, report[name + "_whole_launches"] = counted(fn, *whole)
        results[name + "_whole"] = got.cpu()
        if name == "window":
            report[name + "_ms"] = synced_ms(fn, blocks)
            report[name + "_whole_ms"] = synced_ms(fn, whole)
    for form in ("", "_whole"):
        same_bits(results["rdma" + form].to(dev),
                  results["pallas" + form].to(dev),
                  f"rank {rank}: rdma{form} against ppermute{form}")
    # the copies of each top-k call from blocks: K8 reads the other
    # process's blocks through CUDA IPC, ppermute stages them (gloo)
    for name in ("rdma", "pallas"):
        report[name + "_window"] = copies_and(("halo_ring", "nbh_cheb"),
                                              fns[name], blocks)
    for name, times in in_turns({"pallas": fns["pallas"],
                                 "rdma": fns["rdma"]}, blocks).items():
        report[name + "_ms"] = times
    for name, times in in_turns({"pallas": fns["pallas"],
                                 "rdma": fns["rdma"]}, whole).items():
        report[name + "_whole_ms"] = times
    # the exchange alone, at config 3's blocks and at K8's bytes-bound
    # shape, across the two processes
    rng = np.random.RandomState(SEED + 300 + rank)
    for label, (rows_, cols) in (("config3", (43, 128)),
                                 ("big", (103, 8192))):
        packed = [torch.as_tensor(rng.normal(size=(rows_, cols)),
                                  dtype=torch.float32, device=dev)
                  if r == rank else None for r in owners]
        exchanges = {
            "ppermute": lambda p: k8.ring_halo_plain(p, N_SHARDS, 1, owners),
            "rdma": lambda p: k8.ring_halo_rdma(p, N_SHARDS, 1, owners)}
        got, launches = counted(exchanges["rdma"], packed)
        check(launches == {"halo_ring": 1},
              f"rank {rank}: K8 {label} launches {launches}")
        ref = exchanges["ppermute"](packed)
        for s, (a, b) in enumerate(zip(got, ref)):
            check((a is None) == (b is None)
                  and (a is None or torch.equal(a, b)),
                  f"rank {rank}: K8 {label} shard {s} differs from plain")
        report[f"k8_{label}_window"] = copies_and(
            ("halo_ring",), exchanges["rdma"], [packed])
        for name, times in in_turns(exchanges, [packed]).items():
            report[f"k8_{label}_{name}_ms"] = times
    # phase 32's sharded smoother over the two processes' 8 shards
    w9 = build_workload(40, 10000, 1000)
    nb9 = exact_nb(k1.max_in_support_1d(w9[5][:, 0], w9[4][:, 0], RADIUS))
    whole9 = [torch.as_tensor(a, device=dev) for a in w9]
    blocks9 = ([multihost.host_local_to_global(mesh, local(w9[0], 1), axis=1)]
               + whole9[1:4]
               + [multihost.host_local_to_global(mesh, local(w9[4], 0),
                                                 axis=0), whole9[5]])
    for kind in ("transform", "bundle"):
        step = config9_step(mesh, loc, nb9, kind)
        got, report[f"lienks_{kind}_launches"] = counted(step, *blocks9)
        check(isinstance(got, multihost.GlobalTensor)
              and sorted(got.blocks) == [(s,) for s in
                                         range(4 * rank, 4 * rank + 4)],
              f"lienks: this process's blocks are {sorted(got.blocks)}")
        results[f"lienks_{kind}"] = got.gather().cpu()
        got, report[f"lienks_{kind}_whole_launches"] = counted(step, *whole9)
        results[f"lienks_{kind}_whole"] = got.cpu()
    report["lienks_ms"] = synced_ms(step, blocks9)
    report["lienks_whole_ms"] = synced_ms(step, whole9)
    # phase 33(c)'s members x grid cycle over a 2 x 4 mesh whose owners
    # split by grid half: the ring halo, the model equivalents and the
    # re-split into the analysis layout cross the processes
    half = [0] * (GRID33 // 2) + [1] * (GRID33 // 2)
    mesh33 = make_forecast_analysis_mesh(ENS33, GRID33,
                                         devices=[dev] * (ENS33 * GRID33),
                                         owners=[half] * ENS33)
    cycle = config6_cycle(mesh33, loc)
    blocks33 = [multihost.host_local_to_global(
        mesh33, local(w9[0], 1), axis=(0, 1), axis_name=("ens", "grid"))
    ] + whole9[1:]
    got, report["cycle_launches"] = counted(cycle, *blocks33)
    mine = sorted(key for key in got.keys() if got.owner(key) == rank)
    check(isinstance(got, multihost.GlobalTensor)
          and sorted(got.blocks) == mine and len(mine) == 4,
          f"cycle: this process's blocks are {sorted(got.blocks)}")
    results["cycle"] = got.gather().cpu()
    got, report["cycle_whole_launches"] = counted(cycle, *whole9)
    results["cycle_whole"] = got.cpu()
    report["cycle_ms"] = synced_ms(cycle, blocks33)
    report["cycle_whole_ms"] = synced_ms(cycle, whole9)
    perts, innov, ginfo, oinfo = config3_obs_space(w3, dev)
    weights = sharded_letkf_weights(
        mesh, loc, perts, innov,
        multihost.host_local_to_global(mesh, local(ginfo, 0), axis=0),
        oinfo, INF)
    save_weights_sharded(os.path.join(out, "weights"), weights)
    # two processes that claim two hosts: CUDA IPC cannot reach across,
    # so building the rdma analysis raises on both
    socket.gethostname = lambda: f"node{rank}"
    try:
        halo_letkf_analysis(mesh, loc, use_pallas=True, comm="rdma", **opts)
        report["hosts"] = None
    except NotImplementedError as exc:
        report["hosts"] = str(exc)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    multihost.shutdown_multihost()


def phase30_nccl(port, out):
    """A world of one process over NCCL: its process info and mesh, and
    the config-3 halo analyses over 8 virtual shards under it."""
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize_multihost(f"tcp://localhost:{port}", 1, 0,
                                   timeout=GROUP_TIMEOUT)
    mesh = multihost.global_grid_mesh(devices=[dev] * N_SHARDS)
    # by default a group of one keeps every card it sees
    own = multihost.global_grid_mesh()
    report = {"backend": torch.distributed.get_backend(),
              "info": multihost.process_info(devices=[dev] * N_SHARDS),
              "mesh": [mesh.size, mesh.owners is None,
                       sorted({str(d) for d in mesh.devices.flat})],
              "default_mesh": [str(d) for d in own.devices.flat],
              "default_info": multihost.process_info(),
              "cards": torch.cuda.device_count()}
    w3, whole3, opts = config3()
    loc = GaspariCohn((RADIUS,), coord1_distance)
    whole = [torch.as_tensor(a, device=dev) for a in whole3]
    results = {name: halo_letkf_analysis(mesh, loc, **kw, **opts)(
        *whole).cpu() for name, kw in (("window", dict(local_method="window")),
                                       ("pallas", dict(use_pallas=True)))}
    torch.save(results, os.path.join(out, "nccl.pt"))
    with open(os.path.join(out, "nccl.json"), "w") as f:
        json.dump(report, f)
    multihost.shutdown_multihost()


def obs_files(directory, w3):
    """Six TAOB files of config-3 observations: file 0 holds config 3's
    own, file i its values moved by 0.05 i standard normals."""
    rng = np.random.RandomState(SEED + 30)
    paths = []
    for i in range(6):
        vals = w3[1] + (0.05 * i * rng.normal(size=O3)).astype(np.float32)
        paths.append(os.path.join(directory, f"cycle{i}.taob"))
        obs_pipeline.write_obs_file(paths[-1], vals, w3[2], w3[3], w3[5])
    return paths


def loader_passes(directory, passes):
    """``passes`` loader passes over the six files at depth 3 (the
    repaired race): every batch in file order and equal to
    ``shard_observations`` of its file."""
    paths = [os.path.join(directory, f"cycle{i}.taob") for i in range(6)]
    refs = []
    for path in paths:
        vals, var, gidx, coords = obs_pipeline.read_obs_file(path)
        refs.append(shard_observations(vals, var, gidx, coords, G3,
                                       N_SHARDS))
    cap = refs[0][5]
    for n in range(int(passes)):
        with obs_pipeline.ObsLoader(paths, G3, N_SHARDS, cap=cap,
                                    depth=3) as loader:
            for i, (idx, *arrays) in enumerate(loader):
                check(idx == i, f"pass {n}: file {idx} came {i}th")
                for got, want in zip(arrays, refs[i][:5]):
                    check(np.array_equal(got.reshape(want.shape), want),
                          f"pass {n}, file {i}: a batch differs")
    print(passes, flush=True)


def window_note(rows):
    """A profile's copies and kernels (name -> (ms, count)) in a line."""
    return ", ".join(f"{k[:40]} {t!r} ms x{n}" for k, (t, n) in
                     sorted(rows.items(), key=lambda kv: -kv[1][0]))


def multiprocess_phase(dev, gpu, ref26, ref32, ref33):
    """Phase 30: the config-3 halo analyses across two processes that
    share the card (gloo, 4 virtual shards each) against phase 26's
    one-process analyses, bit for bit, comm="rdma" through K8 over CUDA
    IPC among them (no block through the host, 1 launch a process);
    K8's exchange alone across them at config 3 and [103, 8192] x 8;
    comm="rdma" raising once the processes claim two hosts;
    phase 32's grid-sharded smoother and phase 33(c)'s members x grid
    cycle over the two processes, from blocks and from whole tensors,
    against ``ref32`` and ``ref33`` bit for bit; a world of one
    process over NCCL; the obs-ingest loader feeding the halo analysis,
    and 200 loader passes in a child; the sharded weight checkpoint
    written by the two processes."""
    t_phase = time.perf_counter()
    check(native.native_available() and obs_pipeline._lib() is not None,
          "the native runtime (runtime/cpp) did not build")
    w3, whole3, opts = config3()
    with tempfile.TemporaryDirectory() as out:
        paths = obs_files(out, w3)
        gloo, nccl = free_port(), free_port()
        procs = [(f"rank {r}", child("--phase30-worker", r, gloo, out))
                 for r in (0, 1)]
        procs.append(("nccl", child("--phase30-nccl", nccl, out)))
        procs.append(("loader", child("--loader-passes", out,
                                      LOADER_PASSES)))
        t_children = time.perf_counter()
        # meanwhile: each file through the loader (depth 3) into the
        # one-process window analysis, against the file's own sharding
        window = ref26["window_fn"]
        t0 = time.perf_counter()
        cap = len(whole3[1]) // N_SHARDS
        n_batches = 0
        with obs_pipeline.ObsLoader(paths, G3, N_SHARDS, cap=cap, depth=3,
                                    device=dev) as loader:
            for i, (idx, vals, var, lidx, coords, valid) in enumerate(
                    loader):
                check(idx == i, f"loader: file {idx} came {i}th")
                batch = [vals.float(), var.float(), lidx,
                         coords.float(), valid.float()]
                got = window(ref26["args"][0], *batch, ref26["args"][6])
                fvals, fvar, gidx, fcoords = obs_pipeline.read_obs_file(
                    paths[i])
                sh = shard_observations(fvals.astype(np.float32),
                                        fvar.astype(np.float32), gidx,
                                        fcoords.astype(np.float32), G3,
                                        N_SHARDS)
                same_bits(got, window(ref26["args"][0], *(
                    torch.as_tensor(a, device=dev) for a in sh[:5]),
                    ref26["args"][6]), f"loader batch {i}")
                if i == 0:
                    same_bits(got, ref26["window"], "loader batch 0 against "
                              "phase 26")
                n_batches += 1
        check(n_batches == 6, f"the loader gave {n_batches} batches")
        s_ingest = time.perf_counter() - t0
        outs = join(procs, CHILD_LIMIT)
        s_children = time.perf_counter() - t_children
        check(outs[3].split()[-1] == str(LOADER_PASSES),
              f"loader passes: {outs[3][-200:]}")
        notes = []
        reports = []
        for r in (0, 1):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                rep = json.load(f)
            reports.append(rep)
            res = torch.load(os.path.join(out, f"rank{r}.pt"))
            check(rep["backend"] == "gloo", f"rank {r}: {rep['backend']}")
            check(rep["info"] == {"process_index": r, "process_count": 2,
                                  "local_devices": 4, "global_devices": 8},
                  f"rank {r}: process_info {rep['info']}")
            check(rep["hosts"] is not None and "CUDA IPC" in rep["hosts"],
                  f"rank {r}: comm='rdma' across two hosts did not raise")
            for name, want in (("window", {"window1d": 4}),
                               ("pallas", {"nbh_cheb": 4}),
                               ("rdma", {"halo_ring": 1, "nbh_cheb": 4})):
                for form in ("", "_whole"):
                    got = rep[f"{name}{form}_launches"]
                    check(got == want, f"rank {r}: {name}{form} launches "
                          f"{got}")
                    same_bits(res[name + form].to(dev), ref26[name],
                              f"rank {r} {name}{form} against phase 26")
            same_bits(res["rdma"].to(dev), res["pallas"].to(dev),
                      f"rank {r} rdma against this run's ppermute")
            # the rdma call copies no block to the host, K8 ran in the
            # window; the ppermute call stages its blocks (gloo)
            win = rep["rdma_window"]
            dtoh = {k: v for k, v in win.items() if "DtoH" in k}
            check(not dtoh and any("halo_ring" in k for k in win),
                  f"rank {r}: the rdma call's profile {win}")
            check(any("DtoH" in k for k in rep["pallas_window"]),
                  f"rank {r}: the ppermute call's profile shows no "
                  f"device-to-host copy: {rep['pallas_window']}")
            for label in ("config3", "big"):
                win = rep[f"k8_{label}_window"]
                check(not any("DtoH" in k for k in win)
                      and any("halo_ring" in k for k in win),
                      f"rank {r}: the K8 {label} exchange's profile {win}")
            for kind in ("transform", "bundle"):
                for form in ("", "_whole"):
                    check(rep[f"lienks_{kind}{form}_launches"]
                          == {"rk4_l96": 8, "svd_jacobi": 16},
                          f"rank {r}: sharded {kind}{form} launches "
                          f"{rep[f'lienks_{kind}{form}_launches']}")
                    same_bits(res[f"lienks_{kind}{form}"].to(dev),
                              ref32[kind], f"rank {r} sharded {kind}{form} "
                              "against phase 32")
            for form in ("", "_whole"):
                check(rep[f"cycle{form}_launches"]
                      == {"rk4_l96": 4, "svd_jacobi": 4},
                      f"rank {r}: members x grid cycle{form} launches "
                      f"{rep[f'cycle{form}_launches']}")
                same_bits(res[f"cycle{form}"].to(dev), ref33,
                          f"rank {r} members x grid cycle{form} against "
                          "phase 33")
        with open(os.path.join(out, "nccl.json")) as f:
            rep_nccl = json.load(f)
        res = torch.load(os.path.join(out, "nccl.pt"))
        check(rep_nccl["backend"] == "nccl", f"nccl: {rep_nccl['backend']}")
        check(rep_nccl["info"] == {"process_index": 0, "process_count": 1,
                                   "local_devices": N_SHARDS,
                                   "global_devices": N_SHARDS},
              f"nccl: process_info {rep_nccl['info']}")
        check(rep_nccl["mesh"] == [N_SHARDS, True, ["cuda:0"]],
              f"nccl: mesh {rep_nccl['mesh']}")
        cards = rep_nccl["cards"]
        check(rep_nccl["default_mesh"] == [f"cuda:{i}" for i in range(cards)]
              and rep_nccl["default_info"] == {
                  "process_index": 0, "process_count": 1,
                  "local_devices": cards, "global_devices": cards},
              f"nccl: a group of one by default {rep_nccl['default_mesh']} "
              f"{rep_nccl['default_info']}")
        for name in ("window", "pallas"):
            same_bits(res[name].to(dev), ref26[name],
                      f"nccl {name} against phase 26")
        loc = GaspariCohn((RADIUS,), coord1_distance)
        weights = sharded_letkf_weights(
            make_grid_mesh(N_SHARDS, devices=[dev] * N_SHARDS), loc,
            *config3_obs_space(w3, dev), INF)
        same_bits(load_weights_sharded(os.path.join(out, "weights"),
                                       device=dev), weights,
                  "sharded weights written by 2 processes")
    ms_one = {name: median_ms(lambda: ref26[name + "_fn"](*ref26["args"]),
                              reps=10, inner=3)
              for name in ("window", "pallas")}
    for name, label in (("window", "window (K1)"),
                        ("pallas", "top-k use_pallas ppermute (K4)"),
                        ("rdma", "top-k use_pallas rdma (K8 + K4)")):
        notes.append(
            f"{label}: 2 processes {reports[0][name + '_ms']!r} ms a call "
            f"from blocks, {reports[0][name + '_whole_ms']!r} ms from whole "
            f"tensors (between barriers; ppermute and rdma in turns, two "
            f"medians each), 1 process "
            f"{ms_one['pallas' if name == 'rdma' else name]!r} ms; launches "
            f"rank 0 {reports[0][name + '_launches']}, rank 1 "
            f"{reports[1][name + '_launches']}")
    for name in ("rdma", "pallas"):
        notes.append(f"profile of one {name} call from blocks, rank 0: "
                     + window_note(reports[0][name + "_window"]))
    for label, shape, (rows_, cols) in (("config3", "config 3", (43, 128)),
                                        ("big", "[103, 8192] x 8",
                                         (103, 8192))):
        win = reports[0][f"k8_{label}_window"]
        ms, ms1 = (sum(t for k, (t, _) in rep[f"k8_{label}_window"].items()
                       if "halo_ring" in k) for rep in reports)
        # this process's launch: its 4 blocks and the other process's 2
        # halo blocks read once, its 4 outputs of 3 blocks written
        block = rows_ * cols * 4
        b = bound((4 + 2 + 4 * 3) * block, 0)
        notes.append(
            f"K8 exchange across the 2 processes at {shape}, halo 1, a "
            f"process: K8 device time {ms!r} ms against its bound "
            f"{b[0]!r} ms ({(4 + 2 + 4 * 3) * block} bytes), profile "
            f"{window_note(win)}; per call between barriers, in turns, "
            f"rdma {reports[0][f'k8_{label}_rdma_ms']!r} ms, ppermute "
            f"{reports[0][f'k8_{label}_ppermute_ms']!r} ms; rank 1 K8 "
            f"{ms1!r} ms")
    notes.append(
        f"the sharded smoother (config 9, transform): 2 processes "
        f"{reports[0]['lienks_ms']!r} ms a step from blocks, "
        f"{reports[0]['lienks_whole_ms']!r} ms from whole tensors (between "
        f"barriers); launches a process "
        f"{reports[0]['lienks_transform_launches']}; both kinds, from "
        f"blocks and from whole tensors, equal to phase 32 bit for bit on "
        f"both ranks")
    notes.append(
        f"phase 33(c)'s members x grid cycle (config 6, {ENS33} x {GRID33} "
        f"mesh, owners by grid half): 2 processes "
        f"{reports[0]['cycle_ms']!r} ms a step from blocks, "
        f"{reports[0]['cycle_whole_ms']!r} ms from whole tensors (between "
        f"barriers); launches a process {reports[0]['cycle_launches']}; "
        f"from blocks and from whole tensors equal to phase 33 bit for bit "
        f"on both ranks")
    log(30, f"config 3 (ens 40, grid {G3}, obs {O3}, GC r={RADIUS}, nb "
        f"{opts['max_obs']}, halo {opts['halo_width']}, degree {DEGREE}) "
        "across 2 processes (gloo, 4 virtual shards of the card each): "
        "window, top-k ppermute and top-k rdma (K8 over CUDA IPC), from "
        "blocks and from whole tensors, equal to phase 26 bit for bit on "
        "both ranks, rdma to ppermute; no device-to-host copy in the rdma "
        "call; comm='rdma' raises on both ranks once they claim two hosts; "
        f"NCCL world of 1: process_info {rep_nccl['info']}, both analyses "
        f"equal to phase 26, by default its {rep_nccl['cards']} card(s) "
        f"{rep_nccl['default_mesh']}; loader: 6 files at depth 3 into the "
        f"window analysis in "
        f"{s_ingest:.2f} s (batch 0 equal to phase 26, each batch to its "
        f"file's sharding), {LOADER_PASSES} passes in a child, each in "
        f"order and exact; native runtime built; DCP weights of 2 processes "
        f"loaded whole equal the 1-process weights; children "
        f"{s_children:.1f} s. " + "; ".join(notes) + f"; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{gpu}]")


# -- 31. TerrSysMP at COSMO-DE width ------------------------------------------

# DWD's COSMO-DE: 421 x 461 columns (ie_tot along rlon x je_tot along rlat)
# at 0.025 deg (2.8 km; Baldauf et al. 2011, MWR 139:3887)
COSMO_RLAT, COSMO_RLON = 461, 421
COSMO_ENS = 40       # KENDA's ensemble (Schraff et al. 2016, QJRMS 142:1453)
N_STATIONS = 500
# the lowest 11 half-level heights (m) of a terrain-following grid over
# flat ground, top down, and TERRA-ML's 8 soil layers (m)
COSMO_VCOORD = np.array([1190.0, 1000.0, 825.0, 665.0, 520.0, 390.0, 275.0,
                         180.0, 100.0, 40.0, 0.0])
COSMO_SOIL = np.array([0.005, 0.025, 0.07, 0.16, 0.34, 0.7, 1.42, 2.86])
CLM_LEVSOI = 15
# KENDA's horizontal localization length scale, 100 km (Schraff et al.
# 2016), as the GC radius c in degrees of the rotated grid (111.2 km a
# degree); K4 takes the route the worst column's count needs
R31 = 100.0 / 111.2
CHUNK31 = 65536      # grid columns per K4 launch


def cosmo_de_dataset(dev):
    """A COSMO-shaped dataset at COSMO-DE width (T on 10 full levels, W on
    11 half levels, T_2M, W_SO on 8 soil layers; one time, 40 members),
    made from the seed on the card and handed to the host: a smooth-ish
    mean field per level and a perturbation per member."""
    from tpu_assim_torch.utils.dataset import Dataset, Variable

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    shape = (COSMO_RLAT, COSMO_RLON)

    def field(levels, mean, spread):
        base = mean + spread * torch.randn((1, 1, levels) + shape,
                                           generator=gen, device=dev)
        pert = torch.randn((1, COSMO_ENS, levels) + shape, generator=gen,
                           device=dev)
        return (base + 0.5 * spread * pert).cpu().numpy()

    dims = ("time", "ensemble")
    horiz = ("rlat", "rlon")
    data_vars = {
        "T": Variable(dims + ("level",) + horiz, field(10, 280.0, 2.0)),
        "W": Variable(dims + ("level1",) + horiz, field(11, 0.0, 0.5)),
        "T_2M": Variable(dims + ("height_2m",) + horiz,
                         field(1, 285.0, 2.0)),
        "W_SO": Variable(dims + ("soil1",) + horiz, field(8, 0.25, 0.05)),
        "vcoord": Variable(("level1",), COSMO_VCOORD.copy()),
    }
    coords = {
        "time": np.array([0.0]),
        "level1": np.arange(11, dtype=np.float64),
        "level": np.arange(10, dtype=np.float64),
        "soil1": COSMO_SOIL.copy(),
        "height_2m": np.array([2.0]),
        "rlat": -5.0 + 0.025 * np.arange(COSMO_RLAT),
        "rlon": -5.0 + 0.025 * np.arange(COSMO_RLON),
    }
    return Dataset(data_vars, coords)


def rlatlon_distance(grid_coord, obs_coords):
    """|d rlat| and |d rlon| (localization info columns 1 and 2)."""
    return torch.abs(obs_coords[:, 1:3] - grid_coord[1:3][None, :]).T


def clm_dataset(dev):
    """A CLM-shaped dataset at the same width: H2OSOI on 15 soil levels,
    H2OSNO without a level (one time, 40 members)."""
    from tpu_assim_torch.utils.dataset import Dataset, Variable

    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    shape = (1, COSMO_ENS, CLM_LEVSOI, COSMO_RLAT, COSMO_RLON)
    soil = torch.rand(shape, generator=gen, device=dev).cpu().numpy()
    snow = torch.rand(shape[:2] + shape[3:], generator=gen,
                      device=dev).cpu().numpy()
    dims = ("time", "ensemble")
    return Dataset(
        {"H2OSOI": Variable(dims + ("levsoi", "lat", "lon"), soil),
         "H2OSNO": Variable(dims + ("lat", "lon"), snow)},
        {"time": np.array([0.0]),
         "levsoi": 0.01 * 1.6 ** np.arange(CLM_LEVSOI),
         "lat": 45.0 + 0.025 * np.arange(COSMO_RLAT),
         "lon": 5.0 + 0.025 * np.arange(COSMO_RLON)})


def same_values(out_ds, ds, names, what):
    for name in names:
        check(out_ds[name].dims == ds[name].dims
              and np.array_equal(out_ds[name].values, ds[name].values),
              f"{what}: {name} differs")


def terrsysmp_phase(dev, gpu):
    """Phase 31: a COSMO-DE-wide dataset through preprocess_cosmo, the
    class LETKF (cheb, top-k, K4) with the T2m station operator and a
    horizontal GC taper on (rlat, rlon), and postprocess_cosmo; NaN exactly
    at the vgrid padding, 4096 sampled columns against an f64 eigh
    analysis on the CPU, K4 launched once a chunk; the identity round trips
    of COSMO and of CLM; host times."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ds = cosmo_de_dataset(dev)
    s_make = time.perf_counter() - t0
    names = ["T", "W", "T_2M", "W_SO"]
    t0 = time.perf_counter()
    state = preprocess_cosmo(ds, names, device=dev)
    torch.cuda.synchronize()
    s_pre = time.perf_counter() - t0
    n_vgrid = len(state.vgrid)
    g = state.n_grid
    check(n_vgrid == 19 and g == COSMO_RLAT * COSMO_RLON * 19,
          f"vgrid {n_vgrid}, grid {g}")
    check(state.data.shape == (4, 1, COSMO_ENS, g)
          and state.dtype == torch.float32, f"state {state.data.shape}")
    # stations at seeded random cells; geographic lat/lon a shifted
    # copy of the rotated grid, terrain from 0 to 1200 m
    rs = np.random.RandomState(SEED + 31)
    rlat, rlon = ds.coords["rlat"], ds.coords["rlon"]
    lat2d, lon2d = np.meshgrid(50.0 + rlat, 10.0 + rlon, indexing="ij")
    hsurf = 600.0 + 600.0 * np.sin(lat2d * 0.7) * np.cos(lon2d * 0.5)
    cells = rs.choice(lat2d.size, N_STATIONS, replace=False)
    op = CosmoT2mOperator(lat2d.flat[cells], lon2d.flat[cells],
                          hsurf.flat[cells] + rs.normal(0, 30, N_STATIONS),
                          lat2d, lon2d, hsurf, state.vgrid, state.var_names,
                          lev_inds=(9, 8), t2m_level=0.0)
    check(np.array_equal(np.sort(op.locs), np.sort(cells)),
          "T2m: a station did not find its own cell")
    hx = op.torch_operator()(state.data)                  # [1, ens, 500]
    check(bool(torch.isfinite(hx).all()), "T2m equivalents not finite")
    obs_vals = (hx.mean(1) + torch.as_tensor(
        rs.normal(size=(1, N_STATIONS)), dtype=hx.dtype, device=dev))
    obs_coords = state.grid_coords[torch.as_tensor(
        op.locs * n_vgrid, device=dev)][:, :2]
    obs = Observation(obs_vals, torch.ones(N_STATIONS, device=dev),
                      obs_coords=obs_coords, times=state.times,
                      operator=lambda o, s: op(o, s))
    loc = GaspariCohn((R31, R31), rlatlon_distance)
    # the exact window: the worst in-support count over the columns
    info_h = state.grid_info()[::n_vgrid]
    oinfo = obs.stacked_coords()
    worst = max(int((loc.taper_weights(info_h[i:i + CHUNK31],
                                       oinfo) > 0).sum(1).max())
                for i in range(0, info_h.shape[0], CHUNK31))
    nb31 = exact_nb(worst)
    letkf = LETKF(localization=loc, inf_factor=INF, method="cheb",
                  max_obs=nb31, selection="topk", chunksize=CHUNK31)
    letkf.assimilate(state, obs)                          # warm-up
    t0 = time.perf_counter()
    analysis, counts = counted(letkf.assimilate, state, obs)
    s_assim = time.perf_counter() - t0
    n_chunks = -(-g // CHUNK31)
    check(counts == {"nbh_cheb": n_chunks},
          f"COSMO-DE cheb launches {counts}, {n_chunks} chunks")
    check(analysis.vgrid is state.vgrid, "the analysis lost vgrid")
    nan = torch.isnan(state.data)
    check(torch.equal(torch.isnan(analysis.data), nan),
          "analysis NaN where the background is not, or the reverse")
    check(bool(torch.isfinite(analysis.data[~nan]).all()),
          "analysis not finite off the padding")
    # the f64 oracle: dense eigh on 4096 sampled columns, on the CPU
    t0 = time.perf_counter()
    cols = np.sort(rs.choice(g, 4096, replace=False))
    cols_t = torch.as_tensor(cols, device=dev)
    hx64 = op.torch_operator()(state.data.double())[0].cpu()
    perts, innov = _normalized_obs_space(
        hx64, obs_vals[0].double().cpu(),
        torch.ones(N_STATIONS, dtype=torch.float64))
    w_loc = loc.taper_weights(state.grid_info()[cols_t].double().cpu(),
                              oinfo.double().cpu())
    weights = letkf_weights_dense(perts, innov, w_loc, INF)
    x = state.data[..., cols_t].double().cpu()
    xm = x.mean(2, keepdim=True)
    oracle = xm + torch.einsum("vtkg,gkm->vtmg", x - xm, weights)
    s_oracle = time.perf_counter() - t0
    err, rel = compare(analysis.data[..., cols_t].cpu(), oracle,
                       "COSMO-DE cheb on 4096 columns vs f64 eigh")
    t0 = time.perf_counter()
    out_ds = postprocess_cosmo(analysis, ds)
    s_post = time.perf_counter() - t0
    for name in names:
        check(np.isfinite(out_ds[name].values).all(),
              f"postprocess: {name} not finite")
    check(not np.array_equal(out_ds["T_2M"].values, ds["T_2M"].values),
          "the analysis left T_2M as it was")
    same_values(postprocess_cosmo(state, ds), ds, names + ["vcoord"],
                "COSMO round trip")
    t0 = time.perf_counter()
    clm = clm_dataset(dev)
    clm_state = preprocess_clm(clm, ["H2OSOI", "H2OSNO"], device=dev)
    same_values(postprocess_clm(clm_state, clm), clm, ["H2OSOI", "H2OSNO"],
                "CLM round trip")
    s_clm = time.perf_counter() - t0
    log(31, f"COSMO-DE width ({COSMO_RLAT} rlat x {COSMO_RLON} rlon x vgrid "
        f"{n_vgrid} = {g} grid points, ens {COSMO_ENS}, state "
        f"{state.data.numel() * 4 / 1e9:.2f} GB f32 on the card, "
        f"{N_STATIONS} T2m stations, GC r={R31:.4f} deg on (rlat, rlon), "
        f"worst in-support count {worst}, max_obs {nb31}, chunks of "
        f"{CHUNK31}): LETKF(cheb, topk) launches {counts} (one a chunk); "
        f"NaN exactly at the vgrid padding ({int(nan.sum())} entries); "
        f"4096 sampled columns against f64 eigh (CPU, {s_oracle:.1f} s): "
        f"max abs {err!r}, {rel!r} of max (budget {TOL}); COSMO and CLM "
        f"({CLM_LEVSOI} levsoi) round trips the identity. Host times: "
        f"dataset made {s_make:.2f} s, preprocess_cosmo {s_pre:.2f} s, "
        f"assimilate {s_assim:.2f} s, postprocess_cosmo {s_post:.2f} s, "
        f"CLM make + round trip {s_clm:.2f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{gpu}]")


WORKERS = {"--phase30-worker": lambda r, port, out: phase30_worker(
               int(r), port, out),
           "--phase30-nccl": phase30_nccl,
           "--loader-passes": loader_passes}

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in WORKERS:
        # a child's own hard limit: it ends even if its parent is gone
        signal.alarm(CHILD_LIMIT)
        WORKERS[sys.argv[1]](*sys.argv[2:])
        sys.exit(0)
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke.py finished in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
