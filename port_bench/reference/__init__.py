"""
The plain reference of the benchmark's cells: straightforward PyTorch that
imports nothing of the program under test.

- :mod:`.l96`: the Lorenz-96 tendency and classic RK4;
- :mod:`.taper`: the Gaspari-Cohn taper with its sub-epsilon cut;
- :mod:`.window`: each grid column's observations inside the taper's
  support (sorted 1-D coordinates);
- :mod:`.obs`: point observations and the 4-point-mean operator;
- :mod:`.letkf`: the per-column LETKF transform, by an exact
  eigendecomposition (:mod:`.symeig`);
- :mod:`.lienks`: the localized IEnKS-Transform smoother step;
- :mod:`.precision`: the products in f64, or in TF32 (the control).

Everything takes its own copies of the benchmark's inputs and works out
again what the program's set-up derives from them (window size, geometry).
"""
