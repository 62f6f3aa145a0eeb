"""
Fixed-step time integrators (PyTorch port of
:mod:`tpu_assim.models.integration`).
"""

from typing import Callable

import torch

__all__ = ["BaseIntegrator", "RK4Integrator", "integrate_trajectory"]


class BaseIntegrator:
    """Generic fixed-step integrator.

    Parameters
    ----------
    model : callable time-derivative ``f(state) -> dstate/dt``.
    dt : step width; positive integrates forward, negative backward.
    """

    def __init__(self, model: Callable, dt: float = 0.05):
        self._model = None
        self._dt = None
        self.model = model
        self.dt = dt

    @property
    def model(self) -> Callable:
        return self._model

    @model.setter
    def model(self, new_model: Callable):
        if not callable(new_model):
            raise TypeError("Given model is not callable!")
        self._model = new_model

    @property
    def dt(self) -> float:
        return self._dt

    @dt.setter
    def dt(self, new_dt: float):
        if not isinstance(new_dt, (float, int)):
            raise TypeError("Given time step is not a float!")
        if new_dt == 0:
            raise ValueError("Given time step is zero!")
        self._dt = new_dt

    def _calc_increment(self, state):
        raise NotImplementedError

    def integrate(self, state):
        """One step: ``state + increment``."""
        return state + self._calc_increment(state)


class RK4Integrator(BaseIntegrator):
    """Classic fourth-order Runge-Kutta in stage form with the weights
    [1, 2, 2, 1]/6; ``steps``/``weights`` are attributes, so other RK
    schemes can be expressed."""

    def __init__(self, model: Callable, dt: float = 0.05):
        super().__init__(model=model, dt=dt)
        self.steps = [0.0, self.dt / 2.0, self.dt / 2.0, self.dt]
        self.weights = [1.0, 2.0, 2.0, 1.0]
        self._weights_sum = sum(self.weights)
        self._weights = [w / self._weights_sum for w in self.weights]

    def __str__(self):
        return "RK4Integrator(model={0:s}, dt={1})".format(
            str(self.model), self.dt)

    def _estimate_slope(self, state):
        """Weighted average of the staged slopes."""
        averaged_slope = state * 0
        curr_slope = state * 0
        for k, ts in enumerate(self.steps):
            curr_slope = self.model(state + curr_slope * ts)
            averaged_slope = averaged_slope + self._weights[k] * curr_slope
        return averaged_slope

    def _calc_increment(self, state):
        return self._estimate_slope(state) * self.dt


def integrate_trajectory(integrator: BaseIntegrator, state: torch.Tensor,
                         n_steps: int, save_every: int = 1) -> torch.Tensor:
    """Integrate ``n_steps`` steps, saving every ``save_every``-th state.
    Returns ``[n_saved, *state.shape]``."""
    if n_steps % save_every != 0:
        raise ValueError("n_steps must be divisible by save_every")
    saved = []
    for step in range(1, n_steps + 1):
        state = integrator.integrate(state)
        if step % save_every == 0:
            saved.append(state)
    return torch.stack(saved)
