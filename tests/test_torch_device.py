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
  the register route's blocks stage their slice where it fits beside the
  workspaces at the blocks an SM the kernel is built for and a block has
  enough columns (bench config 8's strips, config 7, a 2-D halo's 16
  tiles), and read from the table elsewhere (the dense network's wide
  slices, tiles of 4 columns, the shared route);
- K3's plan (``svd_jacobi_plan``) and K7's (``eigh_jacobi_plan``): every
  K up to ``MAX_K``;
- K5's plan (``nbh_ns_plan``): every nb from 1 to 40 gets the route of
  its size, columns packed a lane per row on the register route, a block
  within a Hopper block's shared memory, and blocks that cover the grid;
- K1's and K4's plans (``window1d_plan``, ``nbh_cheb_plan``): every nb
  from 1 to 72 gets the route of its size, small windows packed 32 // nbc
  columns a warp on the register route, a block within a Hopper block's
  shared memory, and blocks that cover the grid; K1's union route up to nb
  32 (its slots, shared bytes and blocks an SM, the arithmetic of
  ``letkf_window1d.cu``'s twin) wherever its block fits, its register route
  from nb 33, and the shared route for nb up to 32 where no union block
  fits;
- K1's block union widths (a twin here, ``window1d_union_widths``) from
  the plain window selection: within the union slots on evenly spaced and
  tied coordinates and where o < nb, beyond them on a shuffled grid and
  where a block's columns reach more observations than the slots hold;
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
    bytes as the kernel lays them out (the band, the block's count of
    columns at each width, then the keys or the warps' workspaces)."""
    for ns in (1, 3):
        for degree in (12, 16, 48):
            for width, n_tiles in ((168, 128), (4000, 8192)):
                plan = k1.window2d_plan(40, nb, ns, degree, width, n_tiles)
                assert plan["smem"] <= SMEM_PER_BLOCK
                assert plan["route"] == ("register" if nb <= k1.K6_REG_MAX_NB
                                         else "shared")
                cap = (k1.K6_SMEM_MAX_WARPS if plan["route"] == "shared"
                       else k1.K6_STAGED_WARPS if plan["staged"]
                       else k1.K6_REG_WARPS)
                assert 1 <= plan["warps"] <= cap
                band, keys = 8 * width, 8 * (1 << (width - 1).bit_length())
                per_warp = 4 * k1._k6_floats_per_warp(plan["route"], 40, nb,
                                                      ns, degree)
                # a staged slice: width rows of 43 floats, stride 43
                stage = -(-4 * width * 43 // 16) * 16 if plan["staged"] else 0
                assert plan["smem"] == (-(-band // 16) * 16
                                        + 4 * len(k1.K6_WIDTHS) + stage + max(
                                            keys, plan["warps"] * per_warp))
                assert 128 % plan["splits"] == 0
                assert 128 // plan["splits"] >= (
                    k1.K6_STAGED_MIN_COLS if plan["staged"]
                    else 2 * plan["warps"])


@pytest.mark.parametrize("n_tiles, width, staged, splits", [
    (8192, 184, True, 1), (128, 184, True, 4), (16, 184, True, 16),
    (1000, 184, True, 1), (128, 4000, False, 16), (16, 4000, False, 16),
    (1000, 4000, False, 4)])
def test_window2d_plan_spreads_small_grids(n_tiles, width, staged, splits):
    """Config 8 (8192 tiles) keeps a block a tile. Staged (a slice of 184
    rows), config 7's 128 tiles spread over blocks of 32 columns and a 2-D
    halo's 16 over blocks of 8, each within two waves of two blocks an SM;
    a middling grid not at all. Unstaged (a slice of 4000 rows, too wide to
    stage), grids of few tiles spread each tile until every warp has two
    columns, a middling grid only until ~2112 blocks are in flight."""
    plan = k1.window2d_plan(40, 52, 1, 16, width, n_tiles)
    assert plan["route"] == "register" and plan["staged"] is staged
    assert plan["warps"] == (6 if staged else 4)
    assert plan["splits"] == splits


def _blocks_per_sm(plan):
    return k1.SMEM_PER_SM // (plan["smem"] + k1.SMEM_RESERVED_PER_BLOCK)


# (k, nb, ns, degree, width, n_tiles, tile, staged, warps, splits)
_K6_STAGING = {
    # bench config 8's strip plan: a slice of 184 rows, 8192 tiles
    "config 8 strips": (40, 52, 1, 16, 184, 8192, 128, True, 6, 1),
    # chip_kernel_times.py's dense network: slices of 520 rows
    "dense network": (40, 52, 1, 16, 520, 512, 128, False, 4, 8),
    # k 100 on a wide band: a slice of 103-float rows beyond the SM's half
    "k 100, wide band": (100, 52, 1, 16, 400, 8192, 128, False, 4, 1),
    # config 7's 2 x 4 halo: 16 tiles a shard, 8 columns a block
    "halo tiles": (40, 36, 1, 12, 160, 16, 128, True, 6, 16),
    # tiles of 4 columns: a block would copy the slice for too few
    "tiles of 4 columns": (40, 36, 1, 12, 160, 16, 4, False, 4, 1),
    # the shared route as before: no staging
    "shared route": (40, 72, 1, 16, 184, 8192, 128, False, 6, 1),
    # windows of 57-64: staged blocks of 4 warps
    "nb 64": (40, 64, 1, 16, 184, 8192, 128, True, 4, 1),
    # windows of 25-32 stage; smaller ones keep 4-warp blocks, which hold
    # more warps an SM at their registers
    "nb 25": (40, 25, 1, 16, 184, 8192, 128, True, 6, 1),
    "nb 24": (40, 24, 1, 16, 184, 8192, 128, False, 4, 1),
}


@pytest.mark.parametrize("case", list(_K6_STAGING))
def test_window2d_plan_stages_where_it_fits(case):
    """The register route stages a tile's slice for windows of at least
    K6_STAGED_MIN_NB where the block, slice beside the workspaces, fits
    K6_STAGED_BLOCKS times in an SM and holds at least K6_STAGED_MIN_COLS
    columns; elsewhere the plan is the unstaged one."""
    k, nb, ns, degree, width, n_tiles, tile, staged, warps, splits = \
        _K6_STAGING[case]
    plan = k1.window2d_plan(k, nb, ns, degree, width, n_tiles, tile)
    assert plan["staged"] is staged
    assert (plan["warps"], plan["splits"]) == (warps, splits)
    route = "shared" if nb > k1.K6_REG_MAX_NB else "register"
    assert plan["route"] == route
    band = -(-8 * width // 16) * 16 + 4 * len(k1.K6_WIDTHS)
    keys = 8 * (1 << (width - 1).bit_length())
    per_warp = 4 * k1._k6_floats_per_warp(route, k, nb, ns, degree)
    # rows of k + 3 floats at an odd stride
    stage = -(-4 * width * ((k + 3) | 1) // 16) * 16
    if staged:
        assert plan["smem"] == band + stage + max(warps * per_warp, keys)
        assert _blocks_per_sm(plan) >= k1.K6_STAGED_BLOCKS
        assert tile // splits >= k1.K6_STAGED_MIN_COLS
        assert splits == 1 or (n_tiles * splits
                               <= 2 * k1.K6_STAGED_BLOCKS * 132)
    else:
        assert plan["smem"] == band + max(warps * per_warp, keys)
        fits = (k1.SMEM_PER_SM // (band + stage + max(
            k1.K6_STAGED_WARPS * per_warp, keys)
            + k1.SMEM_RESERVED_PER_BLOCK) >= k1.K6_STAGED_BLOCKS)
        assert (route == "shared" or not fits or nb < k1.K6_STAGED_MIN_NB
                or tile < k1.K6_STAGED_MIN_COLS)


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


SMEM_PER_SM = 233472  # a Hopper SM's shared memory, 228 KB


def _own_floats(k, ns, degree, lanes, cols):
    own = ns * k + ns + 4 * (degree + 1)
    return (own + 31 - lanes) // 32 * 32 + lanes if cols > 1 else (
        -(-own // 4) * 4)


def _held_warps(warps, smem, reg_blocks):
    """Warps an SM holds of blocks of ``warps`` warps and ``smem`` bytes,
    registers for ``reg_blocks`` blocks of 8 warps."""
    return warps * min(SMEM_PER_SM // (smem + 1024), 32, 64 // warps,
                       reg_blocks * 8 // warps)


def _union_plan(k, nb, ns, degree):
    """K1's union route as letkf_window1d.cu sizes it: union_slots = nbc
    + 8 window slots, staged with row stride slots + 1 beside their Gram
    matrix and 2 * 8 ints of window bounds; a warp's slice holds its
    columns' Clenshaw rows, a row of sqrt weights and the own blocks; the
    warps of 8, 4, 2, 1 that an SM holds the most of (registers for 5
    blocks of 8 warps up to nbc 8, 4 up to 16, 2 above), the larger on a
    tie. Returns (slots, warps, smem, warps held an SM), or None where no
    block fits."""
    nbc = -(-nb // 4) * 4
    lanes = max(min(1 << (nbc - 1).bit_length(), 32), 4)
    cols = 32 // lanes
    slots = nbc + 8
    per_warp = cols * (nbc * (4 * (1 + ns) + 1)
                       + _own_floats(k, ns, degree, lanes, cols))
    block = (k + slots) * (slots + 1) + 2 * 8
    best = None
    for warps in (8, 4, 2, 1):
        smem = 4 * (warps * per_warp + block)
        if smem > SMEM_PER_BLOCK:
            continue
        held = _held_warps(warps, smem,
                           5 if nbc <= 8 else 4 if nbc <= 16 else 2)
        if best is None or held > best[3]:
            best = (slots, warps, smem, held)
    return best


def _check_cheb_plan(kernel, nb):
    """K1's and K4's launch: the register route up to CHEB_REG_MAX_NB with
    nb rounded up to 4 (nbc), a column on nbc rounded up to a power of 2
    lanes (at most 32) and 32 // lanes columns a warp, the shared route
    after it with one; a warp's slice holds its columns' rows side by side
    and then each column's own block, lanes mod 32 floats long when packed,
    so that the packed columns' broadcasts of them fall in different banks;
    the most warps of 8, 4, 2, 1 whose slices fit a block's shared memory;
    and blocks that cover g exactly. K1's plan takes the union route
    (``_union_plan``) up to nb 32 wherever its block fits."""
    for k in (1, 9, 20, 40, 64, 100):
        for ns, degree in ((1, 12), (6, 48), (6, 24), (1, 16)):
            for g in (1, 37, 10000):
                plan = getattr(k1, f"{kernel}_plan")(k, nb, ns, degree,
                                                     g)
                if kernel == "window1d":
                    nbc = -(-nb // 4) * 4
                    union = _union_plan(k, nb, ns, degree) if nb <= 32 \
                        else None
                    if union is not None:
                        slots, warps, smem, most = union
                        cols = plan["cols_per_warp"]
                        assert (plan["route"], plan["nbc"], plan["union"],
                                plan["warps"], plan["smem"]) == (
                            "register", nbc, slots, warps, smem)
                        assert (slots + 1) % 2 == 1
                        assert plan["blocks_per_sm"] * warps == most
                        assert cols == 32 // max(min(
                            1 << (nbc - 1).bit_length(), 32), 4)
                        assert (plan["blocks"] - 1) * warps * cols < g <= (
                            plan["blocks"] * warps * cols)
                        continue
                    assert plan["union"] == 0
                    assert plan["blocks_per_sm"] * plan["warps"] == (
                        _held_warps(plan["warps"], plan["smem"], 1))
                register = nb <= k1.CHEB_REG_MAX_NB and (
                    kernel == "nbh_cheb" or nb > k1.CHEB_UNION_MAX_NB)
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


@pytest.mark.parametrize("k,nb,degree,g,union,warps,smem,per_sm", [
    (100, 8, 16, 1 << 20, 16, 8, 42768, 5),   # the cycle cell, bench config 5
    (40, 12, 12, 10000, 20, 8, 19184, 4),     # bench config 6
    (40, 32, 47, 10000, 40, 8, 29952, 2),     # bench config 10
    (20, 8, 16, 4096, 16, 8, 25040, 5),
])
def test_window1d_plan_bench_shapes(k, nb, degree, g, union, warps, smem,
                                    per_sm):
    """K1 at the benchmark's shapes takes the union route: at k 100, nb 8
    a 42.8 KB block, five blocks of 8 warps an SM (the per-column route's
    136 KB block held one)."""
    plan = k1.window1d_plan(k, nb, 1, degree, g)
    assert (plan["union"], plan["warps"], plan["smem"],
            plan["blocks_per_sm"]) == (union, warps, smem, per_sm)
    cols = warps * plan["cols_per_warp"]
    assert plan["blocks"] == -(-g // cols)


def _network(name):
    """(grid_x, obs_x, nb) of a union-width case."""
    even = lambda g, o: np.linspace(0, g, num=o, endpoint=False)  # noqa
    return {
        "even": (np.arange(1 << 16), even(1 << 16, 1 << 12), 8),
        "tied": (np.arange(10000), np.repeat(even(10000, 1000), 4), 32),
        "o<nb": (np.arange(1000), even(1000, 5), 8),
        "shuffled": (np.random.RandomState(3).permutation(4096),
                     even(4096, 256), 8),
        "o>g": (np.arange(256), even(256, 4096), 8),
    }[name]


@pytest.mark.parametrize("k,nb,warps", [(3000, 8, 2), (1500, 32, 1)])
def test_window1d_plan_takes_the_shared_route_where_no_union_block_fits(
        k, nb, warps):
    """Windows of up to 32 whose union block does not fit (k above about
    1300 at nb 32) take the shared route, one warp a column."""
    assert _union_plan(k, nb, 1, 16) is None
    plan = k1.window1d_plan(k, nb, 1, 16, 1000)
    assert (plan["route"], plan["nbc"], plan["union"], plan["cols_per_warp"],
            plan["warps"]) == ("shared", None, 0, 1, warps)


def window1d_union_widths(obs_x, grid_x, radius, nb, cols_per_block):
    """The window slots that each block of ``cols_per_block`` consecutive
    grid columns reads on K1's union route, from the plain window
    selection: the spread of its columns' window starts plus ``nb`` rounded
    up to 4 (a tensor [blocks]). The kernel stages the block's union where
    this is at most the plan's ``union`` slots, and takes each column's
    window from global memory elsewhere. The support rounds to f32 as the
    kernel's launcher rounds it."""
    sup = float(np.float32(k1.taper_support_z("gc2", 1e-5))
                * np.float32(radius))
    start, _ = k1._window_starts(obs_x, grid_x, sup, nb)
    pad = -start.shape[0] % cols_per_block
    blocks = torch.cat([start, start[-1:].expand(pad)]).reshape(
        -1, cols_per_block)
    return (blocks.amax(1) - blocks.amin(1)) + -(-nb // 4) * 4


def _random_sorted(o):
    return np.sort(np.random.RandomState(o).uniform(0, 100, size=o))


def _network(name):
    """(grid_x, obs_x, nb) of a union-width case."""
    even = lambda g, o: np.linspace(0, g, num=o, endpoint=False)  # noqa
    return {
        "even": (np.arange(1 << 16), even(1 << 16, 1 << 12), 8),
        "tied": (np.arange(10000), np.repeat(even(10000, 1000), 4), 32),
        "o<nb": (np.arange(1000), even(1000, 5), 8),
        "random o<nb": (np.arange(100), _random_sorted(5), 8),
        "shuffled": (np.random.RandomState(3).permutation(4096),
                     even(4096, 256), 8),
        "o>g": (np.arange(256), even(256, 4096), 8),
        "random o 64": (np.arange(100), _random_sorted(64), 8),
        "random o>g": (np.arange(100), _random_sorted(300), 8),
    }[name]


@pytest.mark.parametrize("name,within", [
    ("even", True), ("tied", True), ("o<nb", True), ("random o<nb", True),
    ("shuffled", False), ("o>g", False), ("random o 64", False),
    ("random o>g", False)])
def test_window1d_union_widths(name, within):
    """The slots each block of the plan's columns reads, from the plain
    window selection: within the union slots wherever consecutive columns
    share their windows (with o < nb every column has the one window
    [o - nb, o)), beyond them on a shuffled grid and where a block's
    columns reach more observations than the slots hold, whose blocks take
    the fallback."""
    grid_x, obs_x, nb = _network(name)
    k = 40
    plan = k1.window1d_plan(k, nb, 1, 16, len(grid_x))
    widths = window1d_union_widths(
        torch.as_tensor(obs_x, dtype=torch.float32),
        torch.as_tensor(grid_x, dtype=torch.float32), 20.0, nb,
        plan["warps"] * plan["cols_per_warp"])
    assert widths.shape == (plan["blocks"],)
    assert bool((widths >= -(-nb // 4) * 4).all())
    assert bool((widths <= plan["union"]).all()) == within
    if "o<nb" in name:
        assert bool((widths == 8).all())


@pytest.mark.parametrize("plan", [k1.window1d_plan, k1.nbh_cheb_plan])
def test_cheb_plans_raise_when_nothing_fits(plan):
    for nb in (12, 72):
        with pytest.raises(ValueError, match="shared memory"):
            plan(4096, nb, 6, 48, 1)
