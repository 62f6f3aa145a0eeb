"""The plain reference against the program's CPU path (its kernels' plain
versions) at small sizes, and its pieces against textbook values."""

import json

import pytest
import torch

from port_bench.inputs import make_inputs
from port_bench.parts import load
from port_bench.reference import l96, symeig, taper
from port_bench.reference.precision import Products, round_tf32
from port_bench.tests.conftest import ROOT, TINY

CELLS = {"l96-1m": "cycle", "l96-10k": "smoother"}


def _entry(config_name, seed):
    cfg = json.loads((ROOT / "port_bench" / "configs" /
                      f"{config_name}.json").read_text())
    cfg.update(TINY[config_name])
    traffic = json.loads((ROOT / "port_bench" / "traffic" /
                          f"{CELLS[config_name]}.json").read_text())
    dev = torch.device("cpu")
    return load("entries", traffic["entry"]).build(
        cfg, traffic, make_inputs(cfg, traffic, seed, dev), dev)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.abs().max())


@pytest.mark.parametrize("config_name", sorted(CELLS))
@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_program_matches_reference(config_name, seed):
    """The program's step (f32) within f32 rounding of the f64 reference;
    the TF32 control far outside it."""
    entry = _entry(config_name, seed)
    prior = entry.initial()
    for j in range(3):                      # a few cycles in, if chained
        out = entry.run(prior, j)
        if config_name == "l96-1m":
            prior, out = out, entry.run(out, j + 1)
    ref = entry.reference(prior, 1, Products("f64"))
    out = entry.run(prior, 1)
    assert _rel(out, ref) < 2e-6
    assert _rel(entry.reference(prior, 1, Products("tf32")), ref) > 5e-5


def test_rk4_matches_the_programs_plain_forecast():
    from tpu_assim_torch.models import Lorenz96, RK4Integrator

    x = torch.randn(3, 64, dtype=torch.float64)
    integ = RK4Integrator(Lorenz96(8.0), dt=0.05)
    y = x
    for _ in range(4):
        y = integ.integrate(y)
    assert _rel(l96.rk4(x, 8.0, 0.05, 4), y) < 1e-14


def test_gaspari_cohn_values():
    z = torch.tensor([0.0, 0.5, 1.0, 1.5, 1.95, 2.0, 3.0],
                     dtype=torch.float64)
    w = taper.gaspari_cohn(z, 1e-5)
    assert w[0] == 1.0 and w[-1] == 0.0 and w[-2] == 0.0
    assert float(w[2]) == pytest.approx(5.0 / 24.0 + 1.0 / 12 - 0.5
                                        + 0.625 + 5.0 / 3 - 5 + 4 - 2 / 3
                                        - 5.0 / 24.0)
    assert float(w[4]) == 0.0                 # 1.9e-6 <= epsilon: cut
    assert bool((w[:-1][:-1].diff() <= 0).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("m", [1, 5, 8])
def test_symeig_reconstructs(dtype, tol, m):
    a = torch.randn(512, m, m, dtype=dtype)
    a = a @ a.mT
    a[0] = 0.0
    lam, v = symeig.eigh(a)
    rec = (v * lam[:, None, :]) @ v.mT
    assert _rel(rec, a) < tol
    assert float((v.mT @ v - torch.eye(m, dtype=dtype)).abs().max()) < tol


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      float("inf")])
    r = round_tf32(x)
    assert r[0] == 1.0 + 2**-10
    assert r[1] == 1.0                        # a tie, to even
    assert r[2] == 1.0 + 2**-9                # a tie, to even
    assert r[3] == float("inf")
