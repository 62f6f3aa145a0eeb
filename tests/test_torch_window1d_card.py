"""
K1, the 1-D window kernel (``csrc/letkf_window1d.cu``), on the card
against its plain version ``window_analysis_plain`` on the same f32 inputs:
within 1e-5 of max|plain| wherever the plain version is finite, NaN where
it is NaN. The cases take both of the union kernel's window sources: the
union route, where a block stages its windows' union once (evenly spaced
observations, tied coordinates, fewer observations than slots), and its
fallback from global memory, where a block's windows spread wider than its
staged slots (a shuffled grid, more observations than columns); the share
of blocks on the union route (``window1d_union_share``) is 1.0 on the even
network and below 1 on the shuffled grid. Also the strict and the
unsortedness poisons, a NaN observation and a NaN column, and windows of
32 at 1500 members, whose union block does not fit: the shared route.

These tests need a CUDA card and skip without one. The card's machine has
no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_window1d_card.py
"""

import numpy as np
import pytest
import torch

from tpu_assim_torch.ops.cuda import letkf as k1

pytestmark = pytest.mark.cuda

INF = 1.1  # multiplicative inflation: reg = (k - 1) / INF


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _even(g, o):
    return np.linspace(0, g, num=o, endpoint=False)


def _random_sorted(g, o):
    return np.sort(np.random.RandomState(5).uniform(0, g, size=o))


# name: (k, grid_x, obs_x, nb, degree, radius, ns, strict, share), share
# the union route's expected share of blocks (None: not checked)
CASES = {
    "even k100 nb8": (100, np.arange(1 << 16), _even(1 << 16, 1 << 12), 8,
                      16, 20.0, 1, True, 1.0),
    "even k40 nb12": (40, np.arange(10000), _even(10000, 1000), 12, 12, 20.0,
                      1, True, 1.0),
    "tied nb32": (40, np.arange(10000), np.repeat(_even(10000, 1000), 4), 32,
                  16, 20.0, 1, True, 1.0),
    "even ns3": (20, np.arange(4096), _even(4096, 256), 8, 12, 20.0, 3, True,
                 1.0),
    "o<nb": (40, np.arange(1000), _even(1000, 5), 8, 12, 20.0, 1, True, 1.0),
    "shuffled grid": (40, np.random.RandomState(3).permutation(4096),
                      _even(4096, 256), 8, 12, 20.0, 1, True, 0.0),
    "o>g": (40, np.arange(256), _even(256, 4096), 8, 12, 20.0, 1, False,
            0.0),
    "strict poison": (40, np.arange(4096), _random_sorted(4096, 512), 4, 12,
                      8.0, 1, True, None),
    "k1500 nb32 shared route": (1500, np.arange(64), _even(64, 64), 32, 12,
                                20.0, 1, False, 0.0),
}


def _inputs(dev, case, seed=11):
    k, grid_x, obs_x, _, _, _, ns, _, _ = case
    rng = np.random.RandomState(seed)
    g, o = len(grid_x), len(obs_x)
    arrays = (rng.normal(size=(k, o)), rng.normal(size=o), obs_x, grid_x,
              rng.normal(size=(ns, k, g)), rng.normal(size=(ns, g)))
    return [torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
            for a in arrays]


def _kernel_and_plain(args, case):
    k, _, _, nb, degree, radius, _, strict, _ = case
    kw = dict(nb=nb, degree=degree, strict=strict)
    out = k1.letkf_window_analysis_fused(*args, (k - 1) / INF, radius, k,
                                         **kw)
    plain = k1.window_analysis_plain(*args, (k - 1) / INF, radius,
                                     ens_size=k, epsilon=1e-5, taper="gc2",
                                     **kw)
    return out, plain


def _check_close(out, plain, what):
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(out), nan), f"{what}: NaN entries differ"
    if bool((~nan).any()):
        err = float((out[~nan].double() - plain[~nan].double()).abs().max())
        scale = float(plain[~nan].double().abs().max())
        assert err <= 1e-5 * scale, f"{what}: {err} > 1e-5 * {scale}"


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda_device, name):
    case = CASES[name]
    args = _inputs(cuda_device, case)
    out, plain = _kernel_and_plain(args, case)
    share = k1.window1d_union_share()
    _check_close(out, plain, name)
    expected = case[-1]
    if expected == 1.0:
        assert share == 1.0, f"{name}: union share {share}"
    elif expected == 0.0:
        assert share < 1.0, f"{name}: union share {share}"
    if name == "strict poison":
        bad = torch.isnan(out).all(1)[0]
        assert 0 < int(bad.sum()) < bad.numel()


def test_unsorted_poisons_everything(cuda_device):
    case = CASES["even k40 nb12"]
    args = _inputs(cuda_device, case)
    args[2] = args[2].flip(0).contiguous()
    out, plain = _kernel_and_plain(args, case)
    assert bool(torch.isnan(out).all()) and bool(torch.isnan(plain).all())


@pytest.mark.parametrize("name", ["even ns3", "shuffled grid"])
def test_nan_observation_and_column(cuda_device, name):
    """A NaN observation poisons the columns whose windows hold it, a NaN
    state column only itself, on the union route and off it."""
    case = CASES[name]
    args = _inputs(cuda_device, case)
    args[0][:, 100] = float("nan")
    args[4][0, :, 5] = float("nan")
    out, plain = _kernel_and_plain(args, case)
    _check_close(out, plain, name)
    bad = torch.isnan(out).any(1)[0]
    assert bool(bad[5]) and 1 < int(bad.sum()) < bad.numel()
