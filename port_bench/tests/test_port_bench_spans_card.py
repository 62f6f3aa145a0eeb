"""On the card, at each cell's own size: the traced slice read down to the
program's spans (:mod:`port_bench.spans`). At least 99% of the device time
is launched inside a program span, every kernel of K1-K3 finds its launch
(by correlation, or paired with its launch span), each step opens the
spans below, and the four span metrics read. Skipped without a CUDA
device."""

import pytest

from port_bench import spans
from port_bench.tests.conftest import ROOT

SPANS = {
    "l96-1m.cycle": {
        "cycle.step in None": 1, "forecast in cycle.step": 1,
        "kernel.rk4_l96 in forecast": 1,
        "letkf.analysis in cycle.step": 1,
        "kernel.window1d in letkf.analysis": 1},
    "l96-10k.smoother": {
        "lienks.step in None": 1, "lienks.taper in lienks.step": 1,
        "lienks.outer in lienks.step": 2, "forecast in lienks.outer": 2,
        "kernel.rk4_l96 in forecast": 2, "lienks.inner in lienks.outer": 2,
        "linalg.svd in lienks.inner": 4,
        "kernel.svd_jacobi in linalg.svd": 4},
}
METRICS = {
    "l96-1m.cycle": ("host_late_idle_pct", "host_syncs_per_step",
                     "prologue_span_device_ms"),
    "l96-10k.smoother": ("host_late_idle_pct", "host_syncs_per_step",
                         "ienks_span_device_ms"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SPANS))
def test_spans_hold_the_window(cuda_device, cell):
    out = spans.measure(ROOT, cell, 2**31 + 41, 0.5, cuda_device)
    assert out["attributed_share"] >= 0.99
    assert out["joins"] and all("none" not in hows
                                for hows in out["joins"].values())
    assert out["spans_per_step"] == SPANS[cell]
    for name in METRICS[cell]:
        assert name in out["metrics"], name
