"""Calls of the launching thread that block on the card (a synchronise,
a copy without ``Async``) inside the program's step spans (``cycle.step``,
``lienks.step``), a step; None where the window holds no step span or no
device operation (:mod:`port_bench.attribution`)."""

from port_bench.attribution import STEP_SPANS


def read(table):
    spans = getattr(table, "program_spans", None)
    if not spans or not table.ops or not any(s.name in STEP_SPANS
                                             for s in spans):
        return None
    return len(table.syncs) / table.steps
