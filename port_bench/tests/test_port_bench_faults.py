"""A run of each cell on the CPU, past the harness's look for a card, with
the timed path broken underneath: ``correct`` comes out false for each
fault a cell can have, and true without one."""

import pytest
import torch

from port_bench import harness

CELLS = ("l96-1m.cycle", "l96-10k.smoother")


def unchanged(prior, out):
    """A step that returns its state unchanged."""
    return prior


def half_batch(prior, out):
    """Half of the grid's columns left out of the analysis."""
    out = out.clone()
    g = out.shape[-1]
    out[:, g // 2:] = prior[:, g // 2:]
    return out


def altered(prior, out):
    """One answer altered where it is produced."""
    out = out.clone()
    out[1, out.shape[-1] // 3] += 1e-3 * out.abs().max()
    return out


def _run(root, cell, fault):
    result, lines = harness.run_cell(root, cell, 2**31 + 101, 0.3, False,
                                     torch.device("cpu"), fault=fault,
                                     log=lambda msg: None)
    return result, lines


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result, lines = _run(tiny_root, cell, None)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert lines and lines[0].startswith("check analysis_rel_err ")
    assert set(result["metrics"]) == {"gridpoints_per_s", "step_ms_p95",
                                      "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_fault_is_not_correct(tiny_root, cell, fault):
    result, _ = _run(tiny_root, cell, fault)
    assert not result["correct"]
    assert result["failed"] >= 1
