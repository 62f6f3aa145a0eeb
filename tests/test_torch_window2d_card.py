"""
K6, the 2-D window kernel (``csrc/letkf_window2d.cu``), on the card
against its plain version ``window2d_plain`` on the same f32 inputs: within
1e-5 of max|plain| wherever the plain version is finite, NaN where it is
NaN. Its register route solves each column on the window's observations of
nonzero weight alone, at their count rounded up to 8; every case also
holds the kernel's count of columns at each width
(``window2d_width_counts``) equal to the count made on the host from the
same inputs (the plain version's windows), and the share of its blocks
that staged their slice of the table in shared memory
(``window2d_staged_share``) at 1.0 where the plan stages and 0.0 where it
does not. The cases, staged: a network whose columns take every width
8-56 (columns with no observation of weight, and with 49-52), bench config
8's strip plan cut to 64 x 64, a third coordinate (rows of 10 floats,
staged at a stride of 11), strict-overflow columns, band-overflow poison;
unstaged, in slices too wide to stage: the first network, and two state
slices with a third coordinate. The staged output is bit for bit the unstaged one on the same
inputs, and a NaN observation poisons the columns where it weighs and no
other, staged and not.

These tests need a CUDA card and skip without one. The card's machine has
no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_window2d_card.py
"""

import numpy as np
import pytest
import torch

from tpu_assim_torch.analysis import _strip_inputs_2d, _strip_plan_2d
from tpu_assim_torch.ops.cuda import letkf as k6
from tpu_assim_torch.ops.localization import GaspariCohn

pytestmark = pytest.mark.cuda

INF = 1.1  # multiplicative inflation: reg = (k - 1) / INF


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _graded(nx=128, ny=40, seed=7):
    """A row-major nx x ny grid, and observations at its cells whose density
    rises along y from none in the first rows to more than one a cell in
    the last. On cells, every taper weight lies far from epsilon: a weight
    within f32 rounding of it could fall on either side of the cut in the
    kernel and in the plain version, whose tapers round differently, and
    the counts of the two would then differ by a column."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(ny, dtype="f8"), np.arange(nx, dtype="f8"),
                         indexing="ij")
    grid = np.stack([xx.ravel(), yy.ravel()], 1)
    obs = []
    for y in range(ny):
        n = rng.poisson(max(0.0, (y - 6) / (ny - 10)) * 1.15 * nx)
        obs.append(np.stack([rng.randint(0, nx, size=n),
                             np.full(n, y)], 1).astype("f8"))
    return grid, np.concatenate(obs)


def _random(dev, shapes, seed=11):
    rng = np.random.RandomState(seed)
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32),
                            device=dev) for s in shapes]


def _banded(dev, grid, obs, k, ns, nb, radius, block=None, extra=(),
            strict=True):
    """``window2d_banded``'s inputs and options for a network."""
    o, g = obs.shape[0], grid.shape[0]
    perts, innov, sp, mean = _random(dev, ((k, o), (o,), (ns, k, g), (ns, g)))
    if block is None:
        block = k6.required_obs_block_2d(obs[:, 1], grid[:, 1], radius)
    args, width = k6.window2d_inputs(
        perts, innov, torch.as_tensor(obs, device=dev),
        torch.as_tensor(grid, device=dev), sp, mean, (k - 1) / INF, radius,
        radius, block, extra_radii=extra)
    kw = dict(width=width, ens_size=k, nb=nb, degree=16, epsilon=1e-5,
              taper="gc2", strict=strict)
    return list(args), kw


def _graded_case(dev, **opts):
    grid, obs = _graded()
    return _banded(dev, grid, obs, 8, 1, 56, 2.0, **opts)


# an observation block whose slices (2408 rows) are too wide to stage
WIDE_BLOCK = 2400


def _third_coordinate(dev, k=12, ns=2):
    grid, obs = _graded(nx=128, ny=24, seed=3)
    grid = np.concatenate([grid, np.remainder(grid[:, :1] + 2 * grid[:, 1:],
                                              3.0)], 1)
    obs = np.concatenate([obs, np.remainder(obs[:, :1] + obs[:, 1:], 3.0)],
                         1)
    return _banded(dev, grid, obs, k, ns, 48, 2.0, extra=(1.5,),
                   strict=False)


def _strips_64(dev, k=40, n_strips=4):
    """Bench config 8's network (10^5 of 2^20 cells drawn by
    RandomState(42), sorted; GC radius 4 in x and y) cut to 64 x 64 at the
    same density, through the program's strip plan."""
    n, o = 64, 390
    yy, xx = np.meshgrid(np.arange(n, dtype=np.float32),
                         np.arange(n, dtype=np.float32), indexing="ij")
    grid = np.stack([xx.ravel(), yy.ravel()], 1)
    cells = np.sort(np.random.RandomState(42).choice(n * n, size=o,
                                                     replace=False))

    def dist(grid_coord, obs_coords):
        return torch.stack([torch.abs(obs_coords[:, 1] - grid_coord[1]),
                            torch.abs(obs_coords[:, 2] - grid_coord[2])], 0)

    loc = GaspariCohn((4.0, 4.0), dist)
    plan = _strip_plan_2d(loc, grid, grid[cells], n_strips, None, True)
    perts, innov, sp, mean = _random(dev, ((k, o), (o,), (1, k, n * n),
                                           (1, n * n)))
    args, kw = _strip_inputs_2d(plan, perts, innov, sp, mean, (k - 1) / INF,
                                16)
    return list(args), kw


def _windows(args, kw):
    """The plain version's windows of these inputs, chunk by chunk."""
    return k6._window2d_windows(
        args[0], args[1], args[2], args[5], width=kw["width"], nb=kw["nb"],
        k=kw["ens_size"], epsilon=kw["epsilon"], taper=kw["taper"],
        tile=kw.get("tile", 128), chunk=16384)


def _counts_by_width(args, kw):
    """The columns at each width of the register route, counted on the
    host from the plain version's windows, and each column's observations
    of nonzero weight."""
    m = torch.cat([(w > 0).sum(-1).reshape(-1)
                   for _, _, w, _ in _windows(args, kw)])
    width = torch.clamp((m + 7) // 8 * 8, min=8)
    return {w: int((width == w).sum()) for w in k6.K6_WIDTHS}, m


def _check_close(out, plain, what):
    nan = torch.isnan(plain)
    assert torch.equal(torch.isnan(out), nan), f"{what}: NaN entries differ"
    if bool((~nan).any()):
        err = float((out[~nan].double() - plain[~nan].double()).abs().max())
        scale = float(plain[~nan].double().abs().max())
        assert err <= 1e-5 * scale, f"{what}: {err} > 1e-5 * {scale}"


def _plan(args, kw):
    tile = kw.get("tile", 128)
    return k6.window2d_plan(kw["ens_size"], kw["nb"], args[3].shape[0],
                            kw["degree"], kw["width"],
                            args[2].shape[1] // tile, tile, args[2].shape[0])


def _run(args, kw, what):
    """K6 against the plain version, its width counts against the host's
    and its staged share against its plan; returns the kernel's output and
    each column's count of observations of nonzero weight."""
    before = k6.LAUNCHES["window2d"]
    out = k6.window2d_banded(*args, **kw)
    assert k6.LAUNCHES["window2d"] == before + 1
    assert k6.window2d_staged_share() == float(_plan(args, kw)["staged"])
    counts = k6.window2d_width_counts()
    _check_close(out, k6.window2d_plain(*args, **kw), what)
    expected, m = _counts_by_width(args, kw)
    assert counts == expected, f"{what}: widths {counts} != {expected}"
    return out, m


CASES = {
    "every width": lambda dev: _graded_case(dev, strict=False),
    "strips 64x64": _strips_64,
    "ns 2, third coordinate": _third_coordinate,
    # rows of 6 + 1 + 3 floats, staged at a stride of 11
    "k 6, third coordinate": lambda dev: _third_coordinate(dev, k=6, ns=1),
    "strict overflow": lambda dev: _graded_case(dev),
    "band overflow poison": lambda dev: _graded_case(dev, block=200,
                                                     strict=False),
    "every width, wide slice": lambda dev: _graded_case(
        dev, block=WIDE_BLOCK, strict=False),
}


# the cases whose slices are too wide to stage beside their workspaces
UNSTAGED = {"ns 2, third coordinate", "every width, wide slice"}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda_device, name):
    args, kw = CASES[name](cuda_device)
    tile = kw.get("tile", 128)
    plan = _plan(args, kw)
    assert plan["route"] == "register"
    assert plan["staged"] != (name in UNSTAGED)
    out, m = _run(args, kw, name)
    nan_cols = torch.isnan(out).any(1).any(0)
    if name.startswith("every width"):
        widths = set(torch.clamp((m + 7) // 8 * 8, min=8).tolist())
        assert widths == set(range(8, 57, 8)), widths
        assert bool((m == 0).any()) and bool(((m >= 49) & (m <= 52)).any())
    if name in ("strict overflow", "band overflow poison"):
        assert 0 < int(nan_cols.sum()) < nan_cols.numel()
    else:
        assert not bool(nan_cols.any())
    if name == "band overflow poison":
        tiles = nan_cols.reshape(-1, tile)
        assert bool((tiles.all(1) | ~tiles.any(1)).all())


def test_staged_equals_unstaged(cuda_device, monkeypatch):
    """The staged plan's output is bit for bit the unstaged plan's on the
    same inputs: the staged floats are the table's, read in the same
    expressions."""
    args, kw = _graded_case(cuda_device, strict=False)
    assert _plan(args, kw)["staged"]
    out = k6.window2d_banded(*args, **kw)
    assert k6.window2d_staged_share() == 1.0
    # the same shapes in tiles of 4 columns: too few a block to stage; the
    # plan's warps, one block a tile and its bytes hold at any tile
    unstaged = k6.window2d_plan(kw["ens_size"], kw["nb"], args[3].shape[0],
                                kw["degree"], kw["width"], 1, 4)
    assert not unstaged["staged"]
    monkeypatch.setattr(k6, "_launch_plan", lambda name, *shape: unstaged)
    out_unstaged = k6.window2d_banded(*args, **kw)
    assert k6.window2d_staged_share() == 0.0
    assert torch.equal(out.view(torch.int32), out_unstaged.view(torch.int32))


@pytest.mark.parametrize("block", [WIDE_BLOCK, None],
                         ids=["table", "staged"])
def test_nan_observation_poisons_where_it_weighs(cuda_device, block):
    """A NaN in one observation's perturbations poisons the columns whose
    windows hold it at nonzero weight; the columns whose windows hold it
    at zero weight stay finite, on the card as in the plain version,
    whether the blocks read their windows from the table or from their
    staged slice."""
    args, kw = _graded_case(cuda_device, block=block, strict=False)
    assert _plan(args, kw)["staged"] == (block is None)
    table = args[0].clone()
    table[_graded()[1].shape[0] // 3, :kw["ens_size"]] = float("nan")
    args[0] = table
    out, _ = _run(args, kw, "NaN observation")
    weighs, holds = [], []
    for _, sel, w, _ in _windows(args, kw):
        nan_slot = torch.isnan(sel[..., 0])
        weighs.append((nan_slot & (w > 0)).any(-1).reshape(-1))
        holds.append(nan_slot.any(-1).reshape(-1))
    weighs, holds = torch.cat(weighs), torch.cat(holds)
    nan_cols = torch.isnan(out).any(1).any(0)
    assert torch.equal(nan_cols, weighs)
    assert 0 < int(weighs.sum()) < int(holds.sum())
