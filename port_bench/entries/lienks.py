"""
The localized IEnKS smoother: ``analysis.make_lienks_step`` over the
configured forecast window, the window size from the localization; the
same seeded prior every step, the observations from the pool.
"""

import torch

from port_bench.parts import load
from port_bench.reference import lienks
from port_bench.work import k3


class Smoother:
    def __init__(self, config, traffic, inputs, device):
        from tpu_assim_torch.analysis import make_lienks_step

        self.config, self.inputs, self.device = config, inputs, device
        sm, model, loc = (config["smoother"], config["model"],
                          config["localization"])
        if sm["kind"] != "transform":
            raise ValueError("the reference holds the transform smoother")
        self.forecast = load("forecasts", model["name"])
        self.loc = load("localizations", loc["name"])
        self.obs_op = load("obs_operators", config["obs_operator"])
        k, g = config["ens_size"], config["grid"]
        self.nb = self.loc.max_obs(loc, inputs)
        integ, n_steps = self.forecast.program(model)
        self._step = make_lienks_step(
            self.loc.program(loc), integ, n_steps,
            n_outer=sm["n_outer"], kind=sm["kind"], tau=sm["tau"],
            max_obs=self.nb, selection=sm["selection"],
            obs_operator=self.obs_op.program(config, inputs, device))
        self._geometry = tuple(
            torch.as_tensor(a, device=device)
            for a in (inputs.obs_idx, inputs.grid_x, inputs.obs_x))
        self.columns = g
        # each outer iteration: one forecast, two SVDs of the weights
        f3, b3 = k3.work(g, k)
        self.work = {kid: (sm["n_outer"] * f, sm["n_outer"] * b)
                     for kid, (f, b) in self.forecast.work(model, k, g).items()}
        self.work["k3"] = (2 * sm["n_outer"] * f3, 2 * sm["n_outer"] * b3)

    def initial(self):
        return self.inputs.prior

    def run(self, prior, j):
        return self._step(prior, self.inputs.obs_pool[j],
                          self.inputs.obs_var, *self._geometry)

    def reference(self, prior, j, products):
        cfg, inp, dev = self.config, self.inputs, self.device
        sm = cfg["smoother"]
        return lienks.smoother_step(
            prior, inp.obs_pool[j], inp.obs_var,
            self.obs_op.reference(cfg, inp, dev),
            self.loc.reference(cfg["localization"], inp, products, dev),
            self.forecast.reference(cfg["model"]), sm["n_outer"], sm["tau"],
            products)

    def free(self):
        self._step = None


def build(config, traffic, inputs, device):
    return Smoother(config, traffic, inputs, device)
