"""A kernel's share of its roofline over the traced window."""

from port_bench.parts import load
from port_bench.work import peaks


def share(table, kernel: str):
    """100 x the least time of the step's work of ``kernel`` (the entry's
    count, :mod:`port_bench.work`) over the device time a step of its
    kernels; None where the step has no such work or the window no such
    kernel."""
    if kernel not in table.work:
        return None
    names = load("work", kernel).KERNEL_NAMES
    ms = table.device_ms_per_step(names)
    if ms <= 0.0:
        return None
    return 100.0 * peaks.bound_ms(*table.work[kernel])[0] / ms
