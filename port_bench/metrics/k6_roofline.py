"""K6's share of its roofline (work/k6.py) over its device time a step."""

from port_bench.metrics._roofline import share


def read(table):
    return share(table, "k6")
