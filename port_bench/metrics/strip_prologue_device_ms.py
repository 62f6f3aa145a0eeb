"""The x-strip path around K6 (``analysis.py: make_strip_letkf_2d``,
``_strip_apply_2d``): device time a step of every operation that is not
K6, the observations' gather, normalization, mean, table build,
permutation into strip order and scatter back."""

from port_bench.metrics._other import other_ms


def read(table):
    return other_ms(table, ("k6",))
