"""Lorenz-96 with forcing ``forcing``, ``steps`` classic RK4 steps of
``dt`` a forecast; on the card the program runs it as K2."""

from port_bench.reference import l96
from port_bench.work import k2


def program(model):
    from tpu_assim_torch.models import Lorenz96, RK4Integrator

    return (RK4Integrator(Lorenz96(model["forcing"]), dt=model["dt"]),
            model["steps"])


def reference(model):
    return lambda x: l96.rk4(x, model["forcing"], model["dt"],
                             model["steps"])


def work(model, k, g):
    return {"k2": k2.work(k, g, model["steps"])}
