"""
Observation operators, one module each, found by the configuration's
``obs_operator``:

- ``program(config, inputs, device)``: the operator handed to the
  program, ``None`` for the program's own point observations at
  ``obs_idx``, else a callable ``[k, g] -> [k, o]``;
- ``reference(config, inputs, device)``: the reference's operator, a
  callable ``[k, g] -> [k, o]`` of :mod:`port_bench.reference`.
"""
