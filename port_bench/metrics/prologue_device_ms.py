"""The analysis prologue and the obs operator (``analysis.py:
make_letkf_analysis._impl``): device time a step of every operation that
is neither K1 nor K2."""

from port_bench.metrics._other import other_ms


def read(table):
    return other_ms(table, ("k1", "k2"))
