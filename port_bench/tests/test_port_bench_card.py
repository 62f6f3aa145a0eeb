"""On the card, at each cell's own size: the program within the cell's
limit and the control (the reference with TF32 products in the program's
place) over it, on one seed. Skipped without a CUDA device."""

import pytest

from port_bench import calibrate, harness
from port_bench.tests.conftest import ROOT

CELLS = ("l96-1m.cycle", "l96-10k.smoother")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda_device, cell):
    spec = harness.Spec(ROOT, cell)
    limit = spec.limits["analysis_rel_err"]["limit"]
    row = calibrate.readings(spec, 2**31 + 29, 1.0, True, cuda_device)
    assert max(row["program"]) <= limit
    assert max(row["control_tf32"]) > limit
