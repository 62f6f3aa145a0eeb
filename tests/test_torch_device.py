"""
Where the port's data lands, and the host-side launch arithmetic of its
kernels, on the CPU:

- ``EnsembleState`` and ``Observation``: a tensor keeps its device unless
  ``device`` is given; numpy data goes to ``device``, by default the card,
  with the coordinates, times and covariance following the data; with no
  card and no ``device``, numpy data raises and names ``device="cpu"``;
- K6's plan (``window2d_plan``): every window from 8 to 72 gets a route
  whose block fits a Hopper block's shared memory, the register route up
  to its bound, and grids of few tiles spread over several blocks a tile;
- K3's plan (``svd_jacobi_plan``) and K7's (``eigh_jacobi_plan``): every
  K up to ``MAX_K``;
- K5's plan (``nbh_ns_plan``): every nb from 1 to 40 gets the route of
  its size, columns packed a lane per row on the register route, a block
  within a Hopper block's shared memory, and blocks that cover the grid;
- K1's and K4's plans (``window1d_plan``, ``nbh_cheb_plan``): every nb
  from 1 to 72 gets the route of its size, small windows packed 32 // nbc
  columns a warp on the register route, a block within a Hopper block's
  shared memory, and blocks that cover the grid;
- the parse of nvcc's resource report that ``chip_smoke.py`` prints.

Whether a card exists is decided inside each test.
"""

import numpy as np
import pytest
import torch

import tpu_assim_torch as TT
from tpu_assim_torch._build import SMEM_PER_BLOCK
from tpu_assim_torch.ops.cuda import jacobi as k7
from tpu_assim_torch.ops.cuda import letkf as k1
from tpu_assim_torch.ops.cuda import svd as k3

torch.set_num_threads(1)


def _numpy_state(rng):
    return (rng.normal(size=(1, 2, 5, 6)),
            dict(times=np.arange(2.0), grid_coords=np.arange(6.0)))


def _numpy_obs(rng):
    return (rng.normal(size=(2, 4)), np.full(4, 0.5),
            dict(obs_coords=np.arange(4.0), times=[0.0, 1.0]))


def test_tensor_keeps_its_device(rng):
    data, kw = _numpy_state(rng)
    state = TT.EnsembleState(torch.from_numpy(data), **kw)
    assert state.device.type == "cpu"
    assert state.times.device.type == state.grid_coords.device.type == "cpu"
    vals, cov, okw = _numpy_obs(rng)
    obs = TT.Observation(torch.from_numpy(vals), cov, **okw)
    assert {obs.observations.device.type, obs.covariance.device.type,
            obs.obs_coords.device.type, obs.times.device.type} == {"cpu"}
    # an explicit device moves a tensor
    moved = TT.EnsembleState(torch.from_numpy(data), device="cpu", **kw)
    assert moved.device.type == "cpu"


@pytest.mark.parametrize("kind", ["numpy", "list"])
def test_cpu_device_keeps_numpy_on_the_cpu(rng, kind):
    data, kw = _numpy_state(rng)
    vals, cov, okw = _numpy_obs(rng)
    if kind == "list":
        data, vals, cov = data.tolist(), vals.tolist(), cov.tolist()
    state = TT.EnsembleState(data, device="cpu", **kw)
    assert state.device.type == "cpu" and state.valid
    assert state.times.device.type == state.grid_coords.device.type == "cpu"
    # a list becomes torch's default dtype, as torch.as_tensor makes it
    np.testing.assert_allclose(state.data.numpy(), np.asarray(data),
                               rtol=1e-6)
    obs = TT.Observation(vals, cov, device="cpu", **okw)
    assert obs.valid and not obs.correlated
    assert {obs.observations.device.type, obs.covariance.device.type,
            obs.obs_coords.device.type, obs.times.device.type} == {"cpu"}


def test_numpy_goes_to_the_card_or_raises(rng):
    data, kw = _numpy_state(rng)
    vals, cov, okw = _numpy_obs(rng)
    if torch.cuda.is_available():
        assert TT.EnsembleState(data, **kw).device.type == "cuda"
        obs = TT.Observation(vals, cov, **okw)
        assert obs.observations.device.type == "cuda"
        assert obs.covariance.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TT.EnsembleState(data, **kw)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TT.Observation(vals, cov, **okw)


@pytest.mark.parametrize("nb", range(8, 73))
def test_window2d_plan_fits(nb):
    """Every window at ens 40, ns 1 and 3, degree 12, 16 and 48, over a
    config-7 slice (168 slots) and a wide one (4000): a route that fits a
    block, the register route exactly up to K6_REG_MAX_NB, and the plan's
    bytes as the kernel lays them out."""
    for ns in (1, 3):
        for degree in (12, 16, 48):
            for width, n_tiles in ((168, 128), (4000, 8192)):
                plan = k1.window2d_plan(40, nb, ns, degree, width, n_tiles)
                assert plan["smem"] <= SMEM_PER_BLOCK
                assert plan["route"] == ("register" if nb <= k1.K6_REG_MAX_NB
                                         else "shared")
                cap = (k1.K6_REG_WARPS if plan["route"] == "register"
                       else k1.K6_SMEM_MAX_WARPS)
                assert 1 <= plan["warps"] <= cap
                band, keys = 8 * width, 8 * (1 << (width - 1).bit_length())
                per_warp = 4 * k1._k6_floats_per_warp(plan["route"], 40, nb,
                                                      ns, degree)
                assert plan["smem"] == -(-band // 16) * 16 + max(
                    keys, plan["warps"] * per_warp)
                assert 128 % plan["splits"] == 0
                assert 128 // plan["splits"] >= 2 * plan["warps"]


@pytest.mark.parametrize("n_tiles, splits", [(8192, 1), (128, 16), (16, 16),
                                             (1000, 4)])
def test_window2d_plan_spreads_small_grids(n_tiles, splits):
    """Config 8 (8192 tiles) keeps a block a tile; config 7 (128 tiles)
    and a 2-D halo tile (16) spread each tile until every warp has two
    columns; a middling grid only until ~2112 blocks are in flight."""
    plan = k1.window2d_plan(40, 52, 1, 16, 184, n_tiles)
    assert plan["route"] == "register" and plan["warps"] == 4
    assert plan["splits"] == splits


def test_window2d_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        k1.window2d_plan(40, 52, 1, 16, 40000, 1)


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__f89981a3_17_letkf_window2d_cu_5ef9315e19window2d_reg_kernelILi56EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__f89981a3_17_letkf_window2d_cu_5ef9315e19window2d_reg_kernelILi56EEEvNS_6ParamsE
    40 bytes stack frame, 48 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__f89981a3_17_letkf_window2d_cu_5ef9315e20window2d_smem_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__f89981a3_17_letkf_window2d_cu_5ef9315e20window2d_smem_kernelENS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 16 bytes smem
ptxas info    : Compiling entry function 'rk4_kernel' for 'sm_90a'
ptxas info    : Used 32 registers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1f192236_10_rk4_l96_cu_29af328c14rk4_l96_kernelILi8EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__1f192236_10_rk4_l96_cu_29af328c14rk4_l96_kernelILi8EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 4096 bytes smem
"""


def test_kernel_resources_parses_ptxas():
    """chip_smoke.py phase 1 reads each kernel's registers, static shared
    memory and spills from nvcc -Xptxas -v, template instances by name."""
    from tpu_assim_torch._build import kernel_resources

    assert kernel_resources(_PTXAS) == [
        ("window2d_reg_kernel<56>", 168, 0, 48, 88),
        ("window2d_smem_kernel", 64, 16, 0, 0),
        ("rk4_kernel", 32, 0, 0, 0),
        ("rk4_l96_kernel<8>", 40, 4096, 0, 0)]


@pytest.mark.parametrize("k", range(1, k3.MAX_K + 1))
def test_svd_jacobi_plan(k):
    """K3's block: a warp per 8 column pairs (4 lanes a pair), rows padded
    to whole 16-row chunks (at most 4 of them: registers), a column stride
    of 16 mod 32, and A, V, 1/sigma and the seats within a block's shared
    memory."""
    plan = k3.svd_jacobi_plan(k)
    kp = k + k % 2
    assert plan["kp"] == kp
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024
    assert plan["threads"] // 4 >= kp // 2 > plan["threads"] // 4 - 8
    assert plan["rows"] % 16 == 0 and kp <= plan["rows"] < kp + 16
    assert plan["rows"] // 16 <= 4
    assert plan["ld"] % 32 == 16 and plan["ld"] >= plan["rows"]
    assert plan["smem"] == 4 * (2 * kp * plan["ld"] + kp) + 8 * kp
    assert plan["smem"] <= SMEM_PER_BLOCK


@pytest.mark.parametrize("k", range(1, k7.MAX_K + 1))
def test_eigh_jacobi_plan(k):
    """K7's block: one warp, one matrix, a lane per seat pair; V^T's columns
    in registers (two a lane above 32) or, for 32 < Kp <= 42, the ones past
    32 as extra columns of A, one for each lane without a seat pair; A's row
    stride odd (a column walk hits 32 distinct banks) and room for A, the
    extra columns, the zero column and the pair table within a block's
    shared memory."""
    plan = k7.eigh_jacobi_plan(k)
    kp = k + k % 2
    assert plan["kp"] == kp
    assert (plan["threads"], plan["matrices"]) == (32, 1)
    assert kp // 2 <= plan["threads"]
    extra, regs = plan["extra"], plan["vt_regs"]
    assert extra <= plan["threads"] - kp // 2
    assert regs * 32 + extra >= kp and (extra == 0 or regs == 1)
    assert extra == (kp - 32 if 32 < kp <= 42 else 0)
    assert plan["ld"] % 2 == 1 and plan["ld"] >= kp + extra + 1
    assert len({r * plan["ld"] % 32 for r in range(32)}) == 32
    assert plan["smem"] == 16 * (kp // 2) + 4 * kp * plan["ld"]
    assert plan["smem"] <= SMEM_PER_BLOCK


@pytest.mark.parametrize("nb", range(1, 41))
def test_nbh_ns_plan(nb):
    """K5's launch: the register route up to K5_REG_MAX_NB with 32 // nb
    columns a warp (a lane per row), the shared route beyond with one; the
    most warps up to K5_MAX_WARPS whose column slices fit a block's shared
    memory; on the register route slices 4 mod 8 floats long, so that the
    broadcasts of up to 8 packed columns start in different bank quads;
    and blocks that cover g exactly."""
    for k in (1, 9, 40, 64):
        for g in (1, 37, 256, 10000):
            plan = k1.nbh_ns_plan(k, nb, g)
            register = nb <= k1.K5_REG_MAX_NB
            assert plan["route"] == ("register" if register else "shared")
            assert plan["nb_t"] == (nb if register else None)
            cols = plan["cols_per_warp"]
            assert cols == (32 // nb if register else 1)
            assert not register or cols * nb <= 32 < (cols + 1) * nb
            floats = k1._k5_col_floats(plan["route"], k, nb)
            nbp = -(-nb // 4) * 4
            if register:
                assert floats % 8 == 4
                assert floats >= k * nbp + k + 3 * nbp + 4 * nb * nbp
                lanes = min(cols, 8)
                assert len({c * floats % 32 for c in range(lanes)}) == lanes
            else:
                assert floats % 4 == 0
                assert floats >= nb * k + k + 4 * nb + 6 * nb * nb
            per_warp = 4 * cols * floats
            assert plan["smem"] == plan["warps"] * per_warp
            assert plan["smem"] <= SMEM_PER_BLOCK
            assert 1 <= plan["warps"] <= k1.K5_MAX_WARPS
            assert (plan["warps"] == k1.K5_MAX_WARPS
                    or 2 * plan["warps"] * per_warp > SMEM_PER_BLOCK)
            per_block = plan["warps"] * cols
            assert (plan["blocks"] - 1) * per_block < g <= (
                plan["blocks"] * per_block)


def test_nbh_ns_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        k1.nbh_ns_plan(4096, 40, 1)


def _check_cheb_plan(kernel, nb):
    """K1's and K4's launch: the register route up to CHEB_REG_MAX_NB with
    nb rounded up to 4 (nbc), a column on nbc rounded up to a power of 2
    lanes (at most 32) and 32 // lanes columns a warp, the shared route
    after it with one; a warp's slice holds its columns' rows side by side
    and then each column's own block, lanes mod 32 floats long when packed,
    so that the packed columns' broadcasts of them fall in different banks;
    the most warps of 8, 4, 2, 1 whose slices fit a block's shared memory;
    and blocks that cover g exactly."""
    for k in (1, 9, 40, 64):
        for ns, degree in ((1, 12), (6, 48), (6, 24)):
            for g in (1, 37, 10000):
                plan = getattr(k1, f"{kernel}_plan")(k, nb, ns, degree,
                                                     g)
                register = nb <= k1.CHEB_REG_MAX_NB
                assert plan["route"] == ("register" if register
                                         else "shared")
                nbc = -(-nb // 4) * 4
                assert plan["nbc"] == (nbc if register else None)
                lanes = min(1 << (nbc - 1).bit_length(), 32)
                cols = plan["cols_per_warp"]
                assert cols == (32 // max(lanes, 4) if register else 1)
                per_warp = plan["smem"] // plan["warps"]
                assert per_warp * plan["warps"] == plan["smem"]
                assert per_warp % 16 == 0
                own_min = ns * k + ns + 4 * (degree + 1)
                if register:
                    rows = cols * nbc * (k + 4 * (1 + ns))
                    own = (per_warp // 4 - rows) // cols
                    assert own >= own_min and own % 4 == 0
                    if cols > 1:
                        assert cols * max(lanes, 4) == 32
                        assert own % 32 == 32 // cols
                        banks = {c * own % 32 for c in range(cols)}
                        assert len(banks) == cols
                else:
                    core = (nb * (k | 1) + nb * nb + own_min
                            + 4 * (1 + ns) * nb)
                    extra = nb if kernel == "window1d" else 0
                    assert core + extra <= per_warp // 4 <= core + extra + 6
                assert plan["smem"] <= SMEM_PER_BLOCK
                assert plan["warps"] in (1, 2, 4, 8)
                assert (plan["warps"] == k1.CHEB_MAX_WARPS
                        or 2 * plan["smem"] > SMEM_PER_BLOCK)
                per_block = plan["warps"] * cols
                assert (plan["blocks"] - 1) * per_block < g <= (
                    plan["blocks"] * per_block)


@pytest.mark.parametrize("nb", range(1, 73))
def test_window1d_plan(nb):
    _check_cheb_plan("window1d", nb)


@pytest.mark.parametrize("nb", range(1, 73))
def test_nbh_cheb_plan(nb):
    _check_cheb_plan("nbh_cheb", nb)


@pytest.mark.parametrize("plan", [k1.window1d_plan, k1.nbh_cheb_plan])
def test_cheb_plans_raise_when_nothing_fits(plan):
    for nb in (12, 72):
        with pytest.raises(ValueError, match="shared memory"):
            plan(4096, nb, 6, 48, 1)
