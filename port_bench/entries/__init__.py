"""
The entries of the program that a traffic mix drives, one module each,
found by the ``entry`` name in the traffic file. ``build(config, traffic,
inputs, device)`` returns an object with:

- ``columns``: grid columns a step completes;
- ``work``: ``{kernel: (flops, bytes)}`` a step, from ``work/<kernel>.py``;
- ``initial()``: the first step's prior;
- ``run(prior, j)``: the program's step on ``prior`` with observation
  vector ``j`` of the pool (the timed path);
- ``reference(prior, j, products)``: the plain reference's result of the
  same step;
- ``free()``: drops the program's own state.

An entry takes the configuration's forecast model, obs operator and
localization by name (:mod:`port_bench.parts`).
"""
