"""
Ensemble model state (PyTorch port of :mod:`tpu_assim.state`): one dense
``[var, time, ensemble, grid]`` tensor with explicit times and grid
coordinates, on one device.

Dimension contract: ``('var_name', 'time', 'ensemble', 'grid')``. The grid
coordinates ``grid_coords [grid, n_coord]`` feed the localization distance
functions.
"""

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["EnsembleState", "StateError", "as_device_tensor"]


class StateError(Exception):
    """Raised when a state fails validation."""


def as_device_tensor(data, device=None) -> torch.Tensor:
    """``data`` as a tensor: a tensor on its own device unless ``device``
    is given; anything else on ``device``, by default the card. Without a
    card and without ``device``, non-tensor data raises rather than land
    on the CPU unasked."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "this data is not a tensor, so it goes to the card by "
                "default, and this process sees no CUDA device; pass "
                "device=\"cpu\" to keep it on the CPU")
        device = "cuda"
    return torch.as_tensor(data, device=device)


class EnsembleState:
    """Dense ensemble state with coordinates.

    Parameters
    ----------
    data : [var, time, ensemble, grid] tensor (or array).
    times : [time] times; default ``arange(time)`` in the dtype of ``data``.
    grid_coords : [grid, n_coord] (or [grid]) coordinates of the grid
        columns; default ``arange(grid)[:, None]``.
    var_names : tuple of variable names; default ``range(var)``.
    ens_members : tuple of ensemble-member labels; default ``range(ens)``.
    device : where ``data`` goes. A tensor stays on its device unless
        ``device`` is given; anything else (numpy, lists) goes to
        ``device``, by default the card (``"cuda"``), as ``jnp.asarray``
        puts data on the accelerator. Without a card pass ``device="cpu"``.

    ``times`` and ``grid_coords`` move to the device of ``data``.
    """

    def __init__(
        self,
        data,
        times=None,
        grid_coords=None,
        var_names: Optional[Tuple] = None,
        ens_members: Optional[Tuple] = None,
        *,
        device=None,
    ):
        data = as_device_tensor(data, device)
        if data.ndim != 4:
            raise StateError(
                "EnsembleState data must be 4-D (var, time, ensemble, grid), "
                f"got shape {tuple(data.shape)}")
        n_var, n_time, n_ens, n_grid = data.shape
        device = data.device
        self.data = data
        self.times = (torch.arange(n_time, dtype=data.dtype, device=device)
                      if times is None
                      else torch.as_tensor(times, device=device))
        if grid_coords is None:
            grid_coords = torch.arange(n_grid, dtype=data.dtype,
                                       device=device)[:, None]
        grid_coords = torch.as_tensor(grid_coords, device=device)
        self.grid_coords = (grid_coords[:, None] if grid_coords.ndim == 1
                            else grid_coords)
        self.var_names = (tuple(var_names) if var_names is not None
                          else tuple(range(n_var)))
        self.ens_members = (tuple(ens_members) if ens_members is not None
                            else tuple(range(n_ens)))

    def replace(self, data=None, times=None,
                grid_coords=None) -> "EnsembleState":
        """A state sharing everything but the given tensors."""
        obj = object.__new__(EnsembleState)
        obj.data = self.data if data is None else data
        obj.times = self.times if times is None else times
        obj.grid_coords = (self.grid_coords if grid_coords is None
                           else grid_coords)
        obj.var_names = self.var_names
        obj.ens_members = self.ens_members
        return obj

    # ------------------------------------------------------------- properties
    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def n_vars(self) -> int:
        return self.data.shape[0]

    @property
    def n_times(self) -> int:
        return self.data.shape[1]

    @property
    def ens_size(self) -> int:
        return self.data.shape[2]

    @property
    def n_grid(self) -> int:
        return self.data.shape[3]

    @property
    def valid(self) -> bool:
        """4 dimensions in the contracted order, with matching coordinate
        lengths."""
        try:
            return bool(
                self.data.ndim == 4
                and self.times.shape[0] == self.n_times
                and self.grid_coords.shape[0] == self.n_grid
                and len(self.var_names) == self.n_vars
                and len(self.ens_members) == self.ens_size)
        except (AttributeError, IndexError, TypeError):
            return False

    # ------------------------------------------------------------ ensemble ops
    def mean(self) -> torch.Tensor:
        """Ensemble mean [var, time, 1, grid]."""
        return torch.mean(self.data, dim=2, keepdim=True)

    def split_mean_perts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ensemble mean and perturbations."""
        mean = self.mean()
        return mean, self.data - mean

    # ---------------------------------------------------------- time selection
    def time_index(self, analysis_time: Optional[float]) -> int:
        """Index of the analysis time: the last time for ``None``, else the
        nearest time."""
        times = self.times.detach().cpu().numpy()
        if analysis_time is None:
            return int(len(times) - 1)
        return int(np.argmin(np.abs(times - float(analysis_time))))

    def sel_time_index(self, idx: int) -> "EnsembleState":
        """The state at one time, kept as a length-1 time dimension."""
        return EnsembleState(
            self.data[:, idx:idx + 1],
            times=self.times[idx:idx + 1],
            grid_coords=self.grid_coords,
            var_names=self.var_names,
            ens_members=self.ens_members,
        )

    # -------------------------------------------------------------- arithmetic
    def _binop(self, other, op) -> "EnsembleState":
        if isinstance(other, EnsembleState):
            other = other.data
        return self.replace(data=op(self.data, other))

    def __add__(self, other):
        return self._binop(other, torch.add)

    def __radd__(self, other):
        return self._binop(other, lambda a, b: torch.add(b, a))

    def __sub__(self, other):
        return self._binop(other, torch.sub)

    def __mul__(self, other):
        return self._binop(other, torch.mul)

    def __rmul__(self, other):
        return self._binop(other, lambda a, b: torch.mul(b, a))

    def __truediv__(self, other):
        return self._binop(other, torch.div)

    def __repr__(self):
        return (f"EnsembleState(vars={self.n_vars}, times={self.n_times}, "
                f"ens={self.ens_size}, grid={self.n_grid})")

    # ------------------------------------------------------- localization info
    def grid_info(self) -> torch.Tensor:
        """Per-column coordinate rows for localization distances, with the
        first time as column 0: [grid, 1 + n_coord]."""
        t0 = self.times[0].to(self.grid_coords.dtype).expand(self.n_grid, 1)
        return torch.cat([t0, self.grid_coords], dim=1)
