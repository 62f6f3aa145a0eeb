"""
The 2-D x-strip LETKF: ``analysis.make_strip_letkf_2d`` (every strip in
one launch of K6) with the geometry bound at build time, the strips,
inflation and Chebyshev degree from the configuration, the window sized by
the program's strip plan (strict); the analysis alone, no forecast.
"""

from port_bench.parts import load
from port_bench.reference import letkf_sorted
from port_bench.reference.precision import Products
from port_bench.work import k6


class Strips:
    def __init__(self, config, traffic, inputs, device):
        from tpu_assim_torch.analysis import make_strip_letkf_2d

        self.config, self.inputs, self.device = config, inputs, device
        model, loc = config["model"], config["localization"]
        self.forecast = load("forecasts", model["name"])
        self.loc = load("localizations", loc["name"])
        self.obs_op = load("obs_operators", config["obs_operator"])
        if (self.forecast.program(model) is not None
                or self.obs_op.program(config, inputs, device) is not None):
            raise ValueError("the strips take point observations of the "
                             "prior, with no forecast")
        k, g, o = config["ens_size"], config["grid"], config["n_obs"]
        self._fn = make_strip_letkf_2d(
            self.loc.program(loc),
            (inputs.obs_idx, inputs.grid_x, inputs.obs_x),
            n_strips=config["n_strips"], inf_factor=config["inflation"],
            max_obs=self.loc.max_obs(loc, inputs),
            cheb_degree=config["cheb_degree"])
        # each column's observations of nonzero weight, from the network
        self.counts = self.loc.reference(loc, inputs, Products("f64"),
                                         device).counts()
        self.columns = g
        self.work = {"k6": k6.work(k, g, o, self.counts,
                                   config["cheb_degree"]),
                     **self.forecast.work(model, k, g)}

    def initial(self):
        return self.inputs.prior

    def run(self, prior, j):
        return self._fn(prior, self.inputs.obs_pool[j], self.inputs.obs_var)

    def reference(self, prior, j, products):
        cfg, inp, dev = self.config, self.inputs, self.device
        fc = self.forecast.reference(cfg["model"])(products.cast(prior))
        ens_obs = self.obs_op.reference(cfg, inp, dev)(fc)
        window = self.loc.reference(cfg["localization"], inp, products, dev)
        return letkf_sorted.analysis(fc, ens_obs, inp.obs_pool[j],
                                     inp.obs_var, window, self.counts,
                                     cfg["inflation"], products)

    def free(self):
        self._fn = None


def build(config, traffic, inputs, device):
    return Strips(config, traffic, inputs, device)
