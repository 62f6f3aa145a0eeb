"""The host time of the entry call, the mean over a slice in which each
step follows a synchronise, so that the launch queue never blocks it."""

import statistics


def read(table):
    return statistics.fmean(table.host_ms) if table.host_ms else None
