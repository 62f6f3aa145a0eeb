"""Device time a step of every operation outside the named kernels."""

from port_bench.parts import load


def other_ms(table, kernels):
    if not table.ops or any(k not in table.work for k in kernels):
        return None
    names = tuple(n for k in kernels for n in load("work", k).KERNEL_NAMES)
    return table.device_ms_per_step(exclude=names)
