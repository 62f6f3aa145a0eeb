"""The 2-D cell ``grid2d-1024.strips``: on the CPU at a small size, a run
is correct, and each fault of the timed path reads ``correct`` false; on
the card at the cell's own size, the program within the cell's limit and
the control (the reference with TF32 products in the program's place)
over it."""

import pytest
import torch

from port_bench import calibrate, harness
from port_bench.tests.conftest import ROOT, TINY, copy_benchmark
from port_bench.tests.test_port_bench_faults import (
    altered,
    half_batch,
    unchanged,
)

CELL = "grid2d-1024.strips"
# config 8's density of observed cells (10^5 / 2^20) on a 64 x 64 grid
SIZES = {**TINY, "grid2d-1024": {"nx": 64, "ny": 64, "grid": 4096,
                                 "n_obs": 390, "ens_size": 10,
                                 "n_strips": 4}}


@pytest.fixture
def tiny_2d_root(tmp_path):
    return copy_benchmark(tmp_path, sizes=SIZES)


def _run(root, fault):
    return harness.run_cell(root, CELL, 2**31 + 101, 0.3, False,
                            torch.device("cpu"), fault=fault,
                            log=lambda msg: None)[0]


def test_sound_run_is_correct(tiny_2d_root):
    result = _run(tiny_2d_root, None)
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"gridpoints_per_s", "step_ms_p95",
                                      "setup_s"}


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_fault_is_not_correct(tiny_2d_root, fault):
    result = _run(tiny_2d_root, fault)
    assert not result["correct"]
    assert result["failed"] >= 1


@pytest.mark.cuda
def test_control_fails_and_program_passes(cuda_device):
    spec = harness.Spec(ROOT, CELL)
    limit = spec.limits["analysis_rel_err"]["limit"]
    row = calibrate.readings(spec, 2**31 + 29, 1.0, True, cuda_device)
    assert max(row["program"]) <= limit
    assert max(row["control_tf32"]) > limit
