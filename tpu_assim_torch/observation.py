"""
Observation container with R^{-1/2} normalization (PyTorch port of
:mod:`tpu_assim.observation`): observed values ``[time, obs]``, the
observation covariance (diagonal, possibly time-dependent, or a full
correlated matrix), observation coordinates for localization and the
attached observation operator.

The R^{-1/2} normalization is:

* uncorrelated: divide by ``sqrt(var)``;
* correlated: right-multiply by the inverse upper Cholesky factor
  ``U^{-1}``, ``U = chol(R)^T``, as a triangular solve with the lower
  factor; a time-dependent ``R`` is solved per time in one batched call.
"""

from typing import Callable, Optional

import numpy as np
import torch

from tpu_assim_torch.state import as_device_tensor

__all__ = ["Observation", "ObservationError"]


class ObservationError(Exception):
    """Raised when an observation container fails validation."""


class Observation:
    """Observations, covariance, coordinates and operator.

    Parameters
    ----------
    observations : [time, obs] (or [obs]) observed values.
    covariance : R as ``[obs]`` (diagonal), ``[time, obs]`` (time-dependent
        diagonal), ``[obs, obs]`` (correlated) or ``[time, obs, obs]``
        (time-dependent correlated).
    obs_coords : [obs, n_coord] (or [obs]) coordinates; default
        ``arange(obs)[:, None]``.
    times : [time] times, in the units of the state's times; default
        ``arange(time)``.
    operator : callable ``(obs, pseudo_state) -> [time, ens, obs]`` mapping
        a state into observation space, e.g. an
        :class:`tpu_assim_torch.obs_ops.BaseOperator`.
    correlated : mark the covariance as correlated; inferred from its shape
        when not given (a square ``[time, obs]`` covariance with
        ``time == obs`` counts as uncorrelated).
    device : where ``observations`` go. A tensor stays on its device unless
        ``device`` is given; anything else goes to ``device``, by default
        the card (``"cuda"``). Without a card pass ``device="cpu"``.

    Every other tensor moves to the device of ``observations``.
    """

    def __init__(
        self,
        observations,
        covariance,
        obs_coords=None,
        times=None,
        operator: Optional[Callable] = None,
        correlated: Optional[bool] = None,
        *,
        device=None,
    ):
        observations = torch.atleast_2d(as_device_tensor(observations, device))
        device = observations.device
        covariance = torch.as_tensor(covariance, device=device)
        n_time, n_obs = observations.shape
        if correlated is None:
            if covariance.ndim == 1:
                correlated = False
            elif covariance.ndim == 3:
                correlated = True
            else:
                shape = tuple(covariance.shape)
                correlated = (shape == (n_obs, n_obs)
                              and shape != (n_time, n_obs))
        self.observations = observations
        self.covariance = covariance
        if obs_coords is None:
            obs_coords = torch.arange(n_obs, dtype=observations.dtype,
                                      device=device)[:, None]
        obs_coords = torch.as_tensor(obs_coords, device=device)
        self.obs_coords = (obs_coords[:, None] if obs_coords.ndim == 1
                           else obs_coords)
        self.times = (torch.arange(n_time, dtype=observations.dtype,
                                   device=device)
                      if times is None
                      else torch.atleast_1d(torch.as_tensor(times,
                                                            device=device)))
        self.operator = operator
        self.correlated = bool(correlated)

    def replace(self, **kwargs) -> "Observation":
        """A container sharing everything but the given attributes."""
        obj = object.__new__(Observation)
        for name in ("observations", "covariance", "obs_coords", "times",
                     "operator", "correlated"):
            setattr(obj, name, kwargs.get(name, getattr(self, name)))
        return obj

    # ------------------------------------------------------------- properties
    @property
    def n_obs(self) -> int:
        return self.observations.shape[-1]

    @property
    def n_times(self) -> int:
        return self.observations.shape[0]

    @property
    def time_dependent_cov(self) -> bool:
        return self.covariance.ndim == (3 if self.correlated else 2)

    @property
    def valid(self) -> bool:
        """The shapes of values, times, coordinates and covariance fit."""
        try:
            n_time, n_obs = self.observations.shape
            if self.correlated:
                cov_ok = (tuple(self.covariance.shape)
                          in ((n_time, n_obs, n_obs), (n_obs, n_obs)))
            else:
                cov_ok = (tuple(self.covariance.shape)
                          in ((n_time, n_obs), (n_obs,)))
            return bool(cov_ok and self.times.shape[0] == n_time
                        and self.obs_coords.shape[0] == n_obs)
        except (AttributeError, IndexError, TypeError, ValueError):
            return False

    # ------------------------------------------------------- R^{-1/2} scaling
    def mul_rcinv(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` normalized by R^{-1/2}; ``value`` has the obs dimension
        last, and the time dimension next to it where R depends on time:
        ``[..., time, obs]``."""
        if not self.correlated:
            return value / torch.sqrt(self.covariance)
        chol = torch.linalg.cholesky(self.covariance)
        if self.covariance.ndim == 3:
            # per time: [time, b, obs] rows, one batched solve
            val_tm = torch.movedim(value, -2, 0)
            flat = val_tm.reshape(val_tm.shape[0], -1, val_tm.shape[-1])
            zt = torch.linalg.solve_triangular(chol, flat.transpose(1, 2),
                                               upper=False)
            return torch.movedim(zt.transpose(1, 2).reshape(val_tm.shape),
                                 0, -2)
        flat = value.reshape(-1, value.shape[-1])
        zt = torch.linalg.solve_triangular(chol, flat.T, upper=False)
        return zt.T.reshape(value.shape)

    def __repr__(self):
        return (f"Observation(times={self.n_times}, obs={self.n_obs}, "
                f"correlated={self.correlated})")

    # ---------------------------------------------------------- time slicing
    def sel_time(self, time_value: float) -> "Observation":
        """The observations at ``time_value`` (matched with rtol 1e-12 and
        atol 1e-12); ``KeyError`` when no time matches."""
        times = self.times.detach().cpu().numpy()
        idx = np.nonzero(np.isclose(times, float(time_value), rtol=1e-12,
                                    atol=1e-12))[0]
        if idx.size == 0:
            raise KeyError(f"time {time_value} not found in observation "
                           "times")
        sel = torch.as_tensor(np.sort(idx), device=self.observations.device)
        covariance = self.covariance
        if self.time_dependent_cov:
            covariance = covariance[sel]
        return self.replace(observations=self.observations[sel],
                            covariance=covariance, times=self.times[sel])

    # ------------------------------------------------------------ obs stacking
    def stacked_coords(self) -> torch.Tensor:
        """Coordinates of the flattened ``(time, obs)`` dimension with the
        obs time as column 0: [time * obs, 1 + n_coord]."""
        n_time, n_obs = self.observations.shape
        t_col = self.times.to(self.obs_coords.dtype).repeat_interleave(
            n_obs)[:, None]
        coords = self.obs_coords.repeat(n_time, 1)
        return torch.cat([t_col, coords], dim=1)
