"""
Fused multi-step RK4 forecast of Lorenz-96 as one hand-written CUDA kernel
(the port of :func:`tpu_assim.models.pallas_forecast.fused_rk4_steps`), with
its plain PyTorch twin.

:func:`fused_rk4_steps` runs :func:`rk4_steps_plain` for CPU tensors and
launches ``csrc/rk4_l96.cu`` for CUDA tensors: one block per ensemble row,
the row's ring in shared memory for all steps. Its semantics are those of
:class:`tpu_assim_torch.models.RK4Integrator` up to the reassociation of the
stage combination.
"""

import ctypes
import functools
import numbers

import torch

from tpu_assim_torch._build import SMEM_PER_BLOCK
from tpu_assim_torch.models.integration import RK4Integrator
from tpu_assim_torch.models.lorenz96 import Lorenz96

__all__ = ["LAUNCHES", "fused_rk4_steps", "rk4_steps_plain",
           "supports_fused_rk4"]

# Launches of the CUDA kernel, counted by the wrapper.
LAUNCHES = {"rk4_l96": 0}

# f32 rows of the ring the kernel keeps in shared memory
_SMEM_ROWS = 3


def _row_fits(g: int) -> bool:
    return 4 <= g and _SMEM_ROWS * g * 4 <= SMEM_PER_BLOCK


def supports_fused_rk4(integrator, state_shape, dtype_bytes=4) -> bool:
    """True when ``integrator`` is a stock :class:`RK4Integrator` over a
    :class:`Lorenz96` with a scalar forcing, the state is f32 and one row of
    it fits the kernel's shared memory (4 <= g <= 19 370) — what the CUDA
    kernel accepts."""
    if type(integrator) is not RK4Integrator:
        return False
    model = integrator.model
    if not isinstance(model, Lorenz96):
        return False
    if not isinstance(model.forcing, numbers.Real):
        return False
    return dtype_bytes == 4 and len(state_shape) >= 1 and _row_fits(
        int(state_shape[-1]))


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


@functools.lru_cache(maxsize=None)
def _rk4_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("rk4_l96")
    lib.rk4_l96_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
    lib.rk4_l96_launch.restype = ctypes.c_int
    lib.rk4_l96_error_string.argtypes = [ctypes.c_int]
    lib.rk4_l96_error_string.restype = ctypes.c_char_p
    return lib


def _launch_rk4(model, state, dt, n_steps):
    if not isinstance(model, Lorenz96) or not isinstance(model.forcing,
                                                         numbers.Real):
        raise ValueError("the CUDA RK4 kernel integrates Lorenz96 with a "
                         f"scalar forcing; got {model}")
    if state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError("the CUDA RK4 kernel takes a contiguous f32 state; "
                         f"got {state.dtype}")
    if state.requires_grad:
        raise NotImplementedError(
            "gradients through the CUDA RK4 kernel are not ported yet "
            "(ROADMAP.md: the autograd.Function of K2)")
    g = state.shape[-1]
    if not _row_fits(g):
        raise ValueError(f"a row of {g} grid points does not fit the RK4 "
                         "kernel's shared memory (4 <= g <= 19370)")
    lib = _rk4_lib()
    out = torch.empty_like(state)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.rk4_l96_launch(state.data_ptr(), out.data_ptr(),
                                 state.numel() // g, g, int(n_steps),
                                 float(dt), float(model.forcing), stream)
    if err != 0:
        raise RuntimeError("rk4_l96 kernel launch failed: "
                           + lib.rk4_l96_error_string(err).decode())
    LAUNCHES["rk4_l96"] += 1
    return out


def fused_rk4_steps(model, state: torch.Tensor, dt: float,
                    n_steps: int) -> torch.Tensor:
    """``n_steps`` of classic RK4 under ``model`` on a ``[..., g]``
    ensemble: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (callers gate on :func:`supports_fused_rk4`)."""
    if state.device.type == "cpu":
        return rk4_steps_plain(model, state, dt, n_steps)
    if state.device.type == "cuda":
        return _launch_rk4(model, state, dt, n_steps)
    raise ValueError(f"no RK4 kernel for device {state.device}")
