"""
Fused multi-step RK4 forecast of Lorenz-96 as one hand-written CUDA kernel
(the port of :func:`tpu_assim.models.pallas_forecast.fused_rk4_steps`), with
its plain PyTorch twin.

:func:`fused_rk4_steps` runs :func:`rk4_steps_plain` for CPU tensors and
launches ``csrc/rk4_l96.cu`` for CUDA tensors: one warp per tile of 32 P
ring points of a row, the tile's halo recomputed, up to :data:`MAX_STEPS`
steps a launch (:func:`rk4_plan`). A state that requires a gradient goes
through an ``autograd.Function`` whose backward replays
:func:`rk4_steps_plain`, as the JAX kernel's VJP replays the XLA loop. Its
semantics are those of :class:`tpu_assim_torch.models.RK4Integrator` up to
the reassociation of the stage combination.
"""

import ctypes
import functools
import numbers
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from tpu_assim_torch.models.integration import RK4Integrator
from tpu_assim_torch.models.lorenz96 import Lorenz96
from tpu_assim_torch.utils.profiling import span

__all__ = ["LAUNCHES", "MAX_STEPS", "RK4Plan", "TILE_P", "fused_rk4_steps",
           "rk4_plan", "rk4_steps_plain", "rk4_tiles_plain",
           "supports_fused_rk4"]

# Launches of the CUDA kernel, counted by the wrapper.
LAUNCHES = {"rk4_l96": 0}

TILE_P = 8      # ring points a lane holds; a warp's tile is 32 TILE_P
MAX_STEPS = 4   # RK4 steps a launch: the halo is 12 a step, 48 of 256


class RK4Plan(NamedTuple):
    """How the kernel tiles a row of g points for ``n_steps`` steps."""

    p: int         # ring points a lane; a tile holds 32 p
    steps: int     # RK4 steps a launch (the last launch may run fewer)
    tiles: int     # tiles (warps) a row
    launches: int  # ceil(n_steps / steps); 0 for n_steps = 0
    left: int      # halo before a tile's interior: 8 points a step
    stride: int    # interior points a tile writes

    @property
    def right(self) -> int:
        """Halo after a tile's interior: 4 points a step."""
        return 32 * self.p - self.left - self.stride


def rk4_plan(g: int, n_steps: int) -> RK4Plan:
    """The kernel's tiles for ``n_steps`` RK4 steps of rows of ``g`` points:
    a stage reads i-2 .. i+1, so the ``steps`` steps of one launch need 8
    halo points a step on the left and 4 on the right of what a tile
    writes."""
    steps = min(max(n_steps, 1), MAX_STEPS)
    stride = 32 * TILE_P - 12 * steps
    return RK4Plan(TILE_P, steps, -(-g // stride), -(-n_steps // steps),
                   8 * steps, stride)


def supports_fused_rk4(integrator, state_shape, dtype_bytes=4) -> bool:
    """True when ``integrator`` is a stock :class:`RK4Integrator` over a
    :class:`Lorenz96` with a scalar forcing, the state is f32 and its rows
    hold at least 4 points — what the CUDA kernel accepts."""
    if type(integrator) is not RK4Integrator:
        return False
    model = integrator.model
    if not isinstance(model, Lorenz96):
        return False
    if not isinstance(model.forcing, numbers.Real):
        return False
    return (dtype_bytes == 4 and len(state_shape) >= 1
            and int(state_shape[-1]) >= 4)


def rk4_steps_plain(model, state: torch.Tensor, dt: float,
                    n_steps: int) -> torch.Tensor:
    """``n_steps`` of classic RK4 under ``model``:
    ``x + dt/6 (k1 + 2 k2 + 2 k3 + k4)`` per step."""
    x = state
    for _ in range(n_steps):
        k1 = model(x)
        k2 = model(x + (dt / 2.0) * k1)
        k3 = model(x + (dt / 2.0) * k2)
        k4 = model(x + dt * k3)
        x = x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def rk4_tiles_plain(model, state: torch.Tensor, dt: float, n_steps: int,
                    plan: RK4Plan) -> torch.Tensor:
    """What the kernel's decomposition computes, in plain PyTorch: per
    launch, every tile's 32 p ring points stepped on their own — at the
    tile's ends each stage takes the values the kernel's edge lanes take
    (lane 0 its own last two, lane 31 its own first) — and the interiors
    put back in ring order. Equal to :func:`rk4_steps_plain` bit for bit
    when the plan's halo suffices; for the tests, not on any path."""
    g, p, tile = state.shape[-1], plan.p, 32 * plan.p
    ring = ((torch.arange(plan.tiles)[:, None] * plan.stride - plan.left
             + torch.arange(tile)) % g).to(state.device)

    def tile_model(s):
        edges = torch.cat([s[..., p - 2:p], s, s[..., tile - p:tile - p + 1]],
                          dim=-1)
        return model(edges)[..., 2:tile + 2]

    x = state
    for launch in range(plan.launches):
        steps = min(plan.steps, n_steps - launch * plan.steps)
        tiles = rk4_steps_plain(tile_model, x[..., ring], dt, steps)
        x = tiles[..., plan.left:plan.left + plan.stride].flatten(-2)[..., :g]
    return x


@functools.lru_cache(maxsize=None)
def _rk4_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("rk4_l96")
    lib.rk4_l96_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    lib.rk4_l96_launch.restype = ctypes.c_int
    lib.rk4_l96_error_string.argtypes = [ctypes.c_int]
    lib.rk4_l96_error_string.restype = ctypes.c_char_p
    lib.rk4_l96_tile_points.restype = ctypes.c_int
    if lib.rk4_l96_tile_points() != 32 * TILE_P:
        raise RuntimeError(
            f"rk4_l96.cu tiles {lib.rk4_l96_tile_points()} points a warp, "
            f"rk4_plan {32 * TILE_P}")
    return lib


def _launch_rk4(model, state, dt, n_steps):
    if not isinstance(model, Lorenz96) or not isinstance(model.forcing,
                                                         numbers.Real):
        raise ValueError("the CUDA RK4 kernel integrates Lorenz96 with a "
                         f"scalar forcing; got {model}")
    if state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError("the CUDA RK4 kernel takes a contiguous f32 state; "
                         f"got {state.dtype}")
    g, n_steps = state.shape[-1], int(n_steps)
    if g < 4:
        raise ValueError(f"the CUDA RK4 kernel takes rows of at least 4 "
                         f"points; got {g}")
    plan = rk4_plan(g, n_steps)
    if plan.launches == 0 or state.numel() == 0:
        return state.clone()
    lib = _rk4_lib()
    # ping-pong buffers, so that the last launch writes `out`
    bufs = [torch.empty_like(state) for _ in range(min(plan.launches, 2))]
    src = state
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        for launch in range(plan.launches):
            dst = bufs[(plan.launches - 1 - launch) % 2]
            with span("kernel.rk4_l96"):
                err = lib.rk4_l96_launch(
                    src.data_ptr(), dst.data_ptr(), state.numel() // g, g,
                    plan.tiles, plan.left, plan.stride,
                    min(plan.steps, n_steps - launch * plan.steps),
                    float(dt), float(model.forcing), stream)
            if err != 0:
                raise RuntimeError("rk4_l96 kernel launch failed: "
                                   + lib.rk4_l96_error_string(err).decode())
            LAUNCHES["rk4_l96"] += 1
            src = dst
    return src


def _rk4_forward(model, state, dt, n_steps):
    if state.device.type == "cpu":
        return rk4_steps_plain(model, state, dt, n_steps)
    if state.device.type == "cuda":
        return _launch_rk4(model, state, dt, n_steps)
    raise ValueError(f"no RK4 kernel for device {state.device}")


class _FusedRK4(torch.autograd.Function):
    """The forecast with a VJP: the forward dispatches as
    :func:`fused_rk4_steps` does, the backward replays
    :func:`rk4_steps_plain` on the saved input and pulls the cotangent back
    through it (``tpu_assim/models/pallas_forecast.py:_fused_rk4_bwd``)."""

    @staticmethod
    def forward(ctx, state, model, dt, n_steps):
        ctx.save_for_backward(state)
        ctx.model, ctx.dt, ctx.n_steps = model, dt, n_steps
        return _rk4_forward(model, state, dt, n_steps)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (state,) = ctx.saved_tensors
        with torch.enable_grad():
            x = state.detach().requires_grad_()
            y = rk4_steps_plain(ctx.model, x, ctx.dt, ctx.n_steps)
        return torch.autograd.grad(y, x, grad)[0], None, None, None


def fused_rk4_steps(model, state: torch.Tensor, dt: float,
                    n_steps: int) -> torch.Tensor:
    """``n_steps`` of classic RK4 under ``model`` on a ``[..., g]``
    ensemble: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (callers gate on :func:`supports_fused_rk4`).
    Differentiable: a state that requires a gradient goes through an
    ``autograd.Function`` whose backward replays the plain version."""
    if state.requires_grad and torch.is_grad_enabled():
        return _FusedRK4.apply(state, model, dt, n_steps)
    return _rk4_forward(model, state, dt, n_steps)
