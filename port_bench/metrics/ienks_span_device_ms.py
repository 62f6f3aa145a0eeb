"""The IEnKS step but its forecasts and K3, read from the program's
spans: device time a step of the operations launched inside
``lienks.step`` but inside neither ``forecast`` nor ``kernel.svd_jacobi``;
None where the window holds no such span or no device operation
(:mod:`port_bench.attribution`)."""


def read(table):
    spans = getattr(table, "program_spans", None)
    if not spans or not table.ops or not any(s.name == "lienks.step"
                                             for s in spans):
        return None
    return table.device_ms_under(("lienks.step",),
                                 ("forecast", "kernel.svd_jacobi"))
