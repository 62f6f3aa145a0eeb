"""
Localizations, one module each, found by the configuration's
``localization`` ``name``:

- ``program(loc)``: the program's localization;
- ``max_obs(loc, inputs)``: the window size handed to the program;
- ``reference(loc, inputs, products, device)``: ``window(cols) -> (idx
  [c, m], sqrt_w [c, m])``, the in-support observations of the grid
  columns ``cols`` (a slice) and the square roots of their taper weights,
  zero in the padding, in the precision of ``products``.
"""
