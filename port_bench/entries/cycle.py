"""
The cycled LETKF: ``analysis.make_cycle_step`` (the forecast, then the
analysis) with the geometry bound at build time; ``method`` and the
Chebyshev degree from the configuration, the window size from the
localization.
"""

from port_bench.parts import load
from port_bench.reference import letkf
from port_bench.work import k1


class Cycle:
    def __init__(self, config, traffic, inputs, device):
        from tpu_assim_torch.analysis import make_cycle_step

        self.config, self.inputs, self.device = config, inputs, device
        model, loc = config["model"], config["localization"]
        self.forecast = load("forecasts", model["name"])
        self.loc = load("localizations", loc["name"])
        self.obs_op = load("obs_operators", config["obs_operator"])
        k, g, o = config["ens_size"], config["grid"], config["n_obs"]
        self.nb = self.loc.max_obs(loc, inputs)
        integ, n_steps = self.forecast.program(model)
        h = self.obs_op.program(config, inputs, device)
        self._step = make_cycle_step(
            integ, n_steps, self.loc.program(loc),
            inf_factor=config["inflation"], method=config["method"],
            max_obs=self.nb, cheb_degree=config["cheb_degree"],
            obs_operator=h,
            geometry=(None if h is not None else inputs.obs_idx,
                      inputs.grid_x, inputs.obs_x))
        self.columns = g
        self.work = {"k1": k1.work(k, g, o, self.nb, config["cheb_degree"]),
                     **self.forecast.work(model, k, g)}

    def initial(self):
        return self.inputs.prior

    def run(self, prior, j):
        return self._step(prior, self.inputs.obs_pool[j],
                          self.inputs.obs_var)

    def reference(self, prior, j, products):
        cfg, inp, dev = self.config, self.inputs, self.device
        fc = self.forecast.reference(cfg["model"])(products.cast(prior))
        ens_obs = self.obs_op.reference(cfg, inp, dev)(fc)
        window = self.loc.reference(cfg["localization"], inp, products, dev)
        return letkf.analysis(fc, ens_obs, inp.obs_pool[j], inp.obs_var,
                              window, cfg["inflation"], products)

    def free(self):
        self._step = None


def build(config, traffic, inputs, device):
    return Cycle(config, traffic, inputs, device)
