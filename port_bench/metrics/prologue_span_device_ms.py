"""The analysis prologue and the obs operator, read from the program's
spans: device time a step of the operations launched inside
``letkf.analysis`` but not inside ``kernel.window1d`` (K1's launch); None
where the window holds no such span or no device operation
(:mod:`port_bench.attribution`)."""


def read(table):
    spans = getattr(table, "program_spans", None)
    if not spans or not table.ops or not any(s.name == "letkf.analysis"
                                             for s in spans):
        return None
    return table.device_ms_under(("letkf.analysis",), ("kernel.window1d",))
