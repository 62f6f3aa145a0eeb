"""
Forecast models, one module each, found by the configuration's ``model``
``name``:

- ``program(model) -> (integrator, n_steps)``: the program's integrator
  and its steps a forecast;
- ``reference(model)``: the reference's forecast, ``[k, g] -> [k, g]``;
- ``work(model, k, g) -> {kernel: (flops, bytes)}``: one forecast's
  kernel work (:mod:`port_bench.work`).
"""
