"""
One reader a per-layer metric, ``metrics/<metric>.py``, found by the
metric's name: ``read(table) -> float or None`` over the traced window
(:class:`port_bench.tracing.Table`); None where the window holds nothing
to read, and the metric is then left out of the result.
"""
