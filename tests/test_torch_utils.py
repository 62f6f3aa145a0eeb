"""
The port's utilities (tpu_assim_torch.utils), its weight checkpoint and the
gradient of its SVD against the JAX package:

- ``bound_scalar``, ``lazy_property`` and ``ensure_array``;
- the HDF5 weight checkpoint: a round trip keeps dtype and device, a file
  of either package loads in the other, and ``weight_save_path`` leaves
  the filters' and smoothers' analyses as they are without it;
- K3's ``autograd.Function``: its backward against the JAX package's
  ``_svd_jacobi_bwd`` on the same factors and cotangents at 1e-12, each
  cotangent also absent; ``gradcheck`` in f64 through the plain version;
  sign-invariant compositions against ``torch.linalg.svd``'s own autograd
  at 1e-8 (tests/test_linalg.py::test_grad_matches_xla_svd), on the
  Jacobi route and on :func:`~tpu_assim_torch.ops.linalg.svd`'s LAPACK
  route, which is finite on tied singular values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.interpreters import ad

import tpu_assim as JT
from tpu_assim.ops import linalg as jlinalg
from tpu_assim.utils import checkpoint as jckpt

import tpu_assim_torch as TT
from tpu_assim_torch import convert
from tpu_assim_torch.ops import linalg as tl
from tpu_assim_torch.ops.cuda import svd as k3
from tpu_assim_torch.utils import (
    bound_scalar,
    ensure_array,
    lazy_property,
    load_arrays,
    load_weights,
    save_arrays,
    save_weights,
)

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


# -- the decorators -------------------------------------------------------------

def test_bound_scalar():
    from tpu_assim.utils.decorators import bound_scalar as jax_bound

    assert bound_scalar(0.5, 0.0, 1.0, "tau") == 0.5
    assert isinstance(bound_scalar(np.float32(2), 0.0), float)
    assert bound_scalar(-7.0) == -7.0
    for value, lo, hi in ((1.5, 0.0, 1.0), (-0.1, 0.0, 1.0), (-1e-3, 0.0,
                                                               None)):
        with pytest.raises(ValueError) as port_err:
            bound_scalar(value, lo, hi, "x")
        with pytest.raises(ValueError) as jax_err:
            jax_bound(value, lo, hi, "x")
        assert str(port_err.value) == str(jax_err.value)


def test_lazy_property():
    calls = []

    class Holder:
        @lazy_property("table")
        def table(self):
            calls.append(1)
            return [1, 2]

    h = Holder()
    assert h.table is h.table and h._table == [1, 2] and len(calls) == 1
    assert Holder().table == [1, 2] and len(calls) == 2


def test_ensure_array():
    t = ensure_array(2.5)
    assert isinstance(t, torch.Tensor) and t.ndim == 0 and float(t) == 2.5
    x = torch.arange(3)
    assert ensure_array(x) is x
    assert ensure_array([1.0, 2.0]).shape == (2,)


# -- the weight checkpoint ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_weight_round_trip_keeps_dtype_and_device(tmp_path, rng, dtype):
    w = torch.as_tensor(rng.normal(size=(7, 5, 5)), dtype=dtype)
    path = str(tmp_path / "w.h5")
    save_weights(path, w)
    back = load_weights(path, device="cpu")
    assert back.dtype == dtype and back.device == w.device
    assert torch.equal(back, w)
    assert load_weights(path, device="cpu",
                        dtype=torch.float64).dtype == torch.float64
    save_arrays(path, {"a": w, "b": np.arange(3)})
    arrays = load_arrays(path)
    assert sorted(arrays) == ["a", "b"]
    np.testing.assert_array_equal(arrays["a"], w.numpy())


def test_weight_files_cross_packages(tmp_path, rng):
    w = rng.normal(size=(6, 4, 4))
    jax_path, port_path = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    jckpt.save_weights(jax_path, jnp.asarray(w))
    from_jax = load_weights(jax_path, device="cpu")
    assert from_jax.dtype == torch.float64
    np.testing.assert_array_equal(from_jax.numpy(), w)
    save_weights(port_path, torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jckpt.load_weights(port_path)),
                                  w)


def states(rng, n_var=2, n_time=1, n_ens=10, n_grid=30, n_obs=12):
    data = rng.normal(size=(n_var, n_time, n_ens, n_grid))
    obs_idx = np.sort(rng.choice(n_grid, size=n_obs, replace=False))
    idx_t = torch.from_numpy(obs_idx)
    ts = TT.EnsembleState(torch.from_numpy(data),
                          times=np.arange(n_time, dtype=float),
                          grid_coords=np.arange(n_grid, dtype=float)[:, None])
    vals = data[0].mean(axis=1)[:, obs_idx] + rng.normal(size=(n_time, n_obs))
    to = TT.Observation(torch.from_numpy(vals),
                        torch.full((n_obs,), 0.5, dtype=torch.float64),
                        obs_coords=obs_idx.astype(float)[:, None],
                        times=np.arange(n_time, dtype=float),
                        operator=lambda obs, ps: ps.data[0][:, :, idx_t])
    return ts, to


def identity_model(state, iter_num=0):
    return state, state


@pytest.mark.parametrize("make", [
    lambda path, loc: TT.ETKF(1.1, weight_save_path=path),
    lambda path, loc: TT.LETKF(loc, 1.1, max_obs=8, weight_save_path=path),
    lambda path, loc: TT.IEnKSTransform(identity_model, tau=0.8, max_iter=2,
                                        weight_save_path=path),
    lambda path, loc: TT.LocalizedIEnKSBundle(
        identity_model, loc, max_iter=2, chunksize=7, max_obs=8,
        selection="window", weight_save_path=path),
], ids=["ETKF", "LETKF", "IEnKSTransform", "LocalizedIEnKSBundle"])
def test_weight_save_path_leaves_analysis(tmp_path, rng, make):
    """With ``weight_save_path`` the weights make a round trip through the
    file (the last ones stay there), and the analysis is the one without
    it."""
    ts, to = states(rng)
    loc = TT.ops.localization.GaspariCohn((4.0,), convert.coord1_distance)
    path = str(tmp_path / "weights.h5")
    out = make(path, loc).assimilate(ts, to)
    ref = make(None, loc).assimilate(ts, to)
    assert torch.equal(out.data, ref.data)
    stored = load_weights(path, device="cpu")
    assert stored.dtype == torch.float64 and stored.shape[-1] == 10


# -- the SVD's gradient -------------------------------------------------------

def factors(rng, b=3, k=6):
    """The plain K3 factors of a random f64 batch, and random cotangents."""
    a = torch.as_tensor(rng.normal(size=(b, k, k)))
    u, s, v = k3.svd_jacobi_plain(a)
    cot = [torch.as_tensor(rng.normal(size=x.shape)) for x in (u, s, v)]
    return a, (u, s, v), cot


@pytest.mark.parametrize("absent", [None, "u", "s", "v"])
def test_backward_matches_jax(rng, absent):
    """The Function's backward, reached through torch.autograd.grad from
    the outputs that carry a cotangent, equals ``_svd_jacobi_bwd`` of the
    JAX package on the same factors and cotangents (JAX's symbolic zero
    for the absent one) at 1e-12."""
    a, (u, s, v), cot = factors(rng)
    x = a.clone().requires_grad_(True)
    outs = k3.svd_jacobi(x)
    for o, f in zip(outs, (u, s, v)):
        assert torch.equal(o, f)
    keep = [i for i, n in enumerate("usv") if n != absent]
    (grad,) = torch.autograd.grad([outs[i] for i in keep], x,
                                  [cot[i] for i in keep])
    jax_cot = tuple(
        ad.Zero.from_primal_value(jnp.asarray(f)) if n == absent
        else jnp.asarray(c) for n, f, c in zip("usv", (u, s, v), cot))
    (ref,) = jlinalg._svd_jacobi_bwd(
        tuple(jnp.asarray(f) for f in (u, s, v)), jax_cot)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def sign_invariant(u, s, v):
    """Compositions the IEnKS steps take of an SVD: U S^-1 V^T, the
    precision U S^-2 U^T and the singular values."""
    return (tl.rev_svd(u, 1.0 / s, v), tl.rev_svd(u, 1.0 / (s * s), u), s)


def test_gradcheck_f64_plain(rng):
    # singular values 3, 2, 1.2, 0.7, 0.4: apart and away from 0
    q1, _ = np.linalg.qr(rng.normal(size=(2, 5, 5)))
    q2, _ = np.linalg.qr(rng.normal(size=(2, 5, 5)))
    a = torch.as_tensor(np.einsum("bik,k,bjk->bij", q1,
                                  [3.0, 2.0, 1.2, 0.7, 0.4], q2))
    a.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x: sign_invariant(*k3.svd_jacobi(x)), (a,))


@pytest.mark.parametrize("route", ["jacobi", "lapack"])
def test_grad_matches_torch_svd(rng, route):
    """The pullback on sign-invariant compositions equals torch.linalg.svd's
    own autograd at 1e-8: K3's Function (its plain version), and the LAPACK
    route of ``ops.linalg.svd``."""
    k, b = 10, 4
    a = torch.as_tensor(rng.normal(size=(b, k, k)))
    c1 = torch.as_tensor(rng.normal(size=(b, k, k)))
    c2 = torch.as_tensor(rng.normal(size=(b, k)))

    def parts(u, s, v):
        m1 = torch.einsum("bik,bk,bjk->bij", u, 1.0 / s, v)
        return torch.sum(m1 * c1) + torch.sum(torch.log(s) * c2)

    mine = (k3.svd_jacobi if route == "jacobi"
            else lambda t: tl.svd(t, use_jacobi=False))
    x1 = a.clone().requires_grad_(True)
    parts(*mine(x1)).backward()
    x2 = a.clone().requires_grad_(True)
    u, s, vh = torch.linalg.svd(x2, full_matrices=False)
    parts(u, s, vh.transpose(-1, -2)).backward()
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), rtol=1e-8,
                               atol=1e-8)


def test_lapack_route_grad_finite_on_ties():
    """Exactly tied singular values: torch.linalg.svd's own backward
    divides by their zero difference, the port's LAPACK route zeroes the
    tied pair's coupling, as K3's Function and the JAX package's Jacobi
    route do, and equals ``_svd_jacobi_bwd``."""
    a = torch.diag(torch.tensor([3.0, 3.0, 1.0], dtype=torch.float64))
    c = torch.arange(9, dtype=torch.float64).reshape(3, 3)

    def loss(u, s, v):
        return torch.sum(c * tl.rev_svd(u, 1.0 / s, v))

    x1 = a.clone().requires_grad_(True)
    u, s, v = tl.svd(x1)
    loss(u, s, v).backward()
    assert torch.isfinite(x1.grad).all()
    x2 = a.clone().requires_grad_(True)
    uu, ss, vh = torch.linalg.svd(x2)
    loss(uu, ss, vh.mT).backward()
    assert not torch.isfinite(x2.grad).all()
    fs = [t.detach().requires_grad_(True) for t in (u, s, v)]
    du, ds, dv = torch.autograd.grad(loss(*fs), fs)
    (ref,) = jlinalg._svd_jacobi_bwd(
        tuple(jnp.asarray(t.detach()) for t in (u, s, v)),
        tuple(jnp.asarray(t) for t in (du, ds, dv)))
    np.testing.assert_allclose(x1.grad.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
