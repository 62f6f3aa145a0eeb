"""The IEnKS pseudo-ensemble, selection and inner step (``analysis.
_lienks_*``, ``ops/ienks.py``): device time a step of every operation that
is neither K2 nor K3."""

from port_bench.metrics._other import other_ms


def read(table):
    return other_ms(table, ("k2", "k3"))
