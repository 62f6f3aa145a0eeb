"""
Small decorators and validators (PyTorch port of
:mod:`tpu_assim.utils.decorators`).
"""

from typing import Optional

import torch

__all__ = ["bound_scalar", "ensure_array", "lazy_property"]


def lazy_property(name: str):
    """Cache a property's value on the instance under ``_<name>``; a cached
    None counts as not computed."""

    def decorator(fget):
        attr = "_" + name

        @property
        def wrapper(self):
            cached = getattr(self, attr, None)
            if cached is None:
                cached = fget(self)
                setattr(self, attr, cached)
            return cached

        return wrapper

    return decorator


def bound_scalar(
    value,
    min_val: Optional[float] = None,
    max_val: Optional[float] = None,
    name: str = "value",
) -> float:
    """``value`` as a float, checked to lie in [min_val, max_val] (a bound
    of None is open); raises ``ValueError`` outside."""
    value = float(value)
    if min_val is not None and value < min_val:
        raise ValueError(
            "{0} has to be larger or equal than {1}".format(name, min_val)
        )
    if max_val is not None and value > max_val:
        raise ValueError(
            "{0} has to be smaller or equal than {1}".format(name, max_val)
        )
    return value


def ensure_array(value) -> torch.Tensor:
    """Python scalars and sequences as a tensor; a tensor as it is."""
    return torch.as_tensor(value)
