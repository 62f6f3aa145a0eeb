"""
The port's two-sided Jacobi eigh (tpu_assim_torch.ops.cuda.jacobi: the
plain version of kernel K7) against the JAX package's kernel in interpret
mode, ``eigh_jacobi(..., tile=8, interpret=True)``, on the same numpy
inputs in f64.

Eigenvalues are compared at 1e-10, and so are the eigenvectors, directly:
both sides run the same rotations, so they come out with the same signs.
(The port freezes a pair at 8 eps where JAX freezes it at 8 Kp eps; in f64
the rotations between the two thresholds turn by angles far below 1e-10.)
Only inside a degenerate cluster is the basis arbitrary; there the two
sides' roundings (XLA contracts multiply-adds, the port does not) pick
different bases, and the cluster is compared through the projector onto
its span. On the CPU ``eigh_jacobi`` runs its plain version, so these
tests reach the algorithm but not the CUDA kernel, which chip_smoke.py
holds against the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim.ops.pallas.jacobi import eigh_jacobi as jax_eigh_jacobi

from tpu_assim_torch.ops.cuda import jacobi as k7
from tpu_assim_torch.ops.cuda.svd import eigh_svd_jacobi

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10


def t(a):
    return torch.from_numpy(np.asarray(a))


def rec(evecs, evals):
    return np.einsum("...ik,...k,...jk->...ij", np.asarray(evecs),
                     np.asarray(evals), np.asarray(evecs))


def orth_err(q):
    q = np.asarray(q)
    return np.abs(np.swapaxes(q, -1, -2) @ q - np.eye(q.shape[-1])).max()


def both(a, sweeps=7):
    """(port evals, port evecs, JAX evals, JAX evecs) as numpy arrays."""
    ev, vec = k7.eigh_jacobi_plain(t(a), sweeps)
    ev_j, vec_j = jax_eigh_jacobi(jnp.asarray(a), sweeps=sweeps, tile=8,
                                  interpret=True)
    return (ev.numpy(), vec.numpy(), np.asarray(ev_j), np.asarray(vec_j))


def with_spectrum(rng, b, evals):
    q = np.linalg.qr(rng.normal(size=(b, len(evals), len(evals))))[0]
    return np.einsum("bik,k,bjk->bij", q, np.asarray(evals), q)


@pytest.mark.parametrize("k", [8, 13, 40])
@pytest.mark.parametrize("kind", ["symmetric", "spd"])
def test_matches_jax_kernel_f64(rng, k, kind):
    """Random symmetric (indefinite) and full-rank SPD batches, odd K
    included: eigenvalues and eigenvectors at 1e-10 of JAX's, and of
    LAPACK's eigenvalues."""
    a = rng.normal(size=(3, k, k))
    a = a + np.swapaxes(a, -1, -2) if kind == "symmetric" else (
        np.einsum("bki,bmi->bkm", a, a) + np.eye(k))
    ev, vec, ev_j, vec_j = both(a)
    np.testing.assert_allclose(ev, ev_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vec, vec_j, atol=TOL)
    np.testing.assert_allclose(ev, np.linalg.eigvalsh(a), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rec(vec, ev), a, atol=TOL)
    assert orth_err(vec) < TOL


def test_rank3_degenerate_batch(rng):
    """K = 10 of rank 3 (a seven-fold zero eigenvalue): the three
    eigenvectors of the nonzero eigenvalues directly, the null space by its
    projector."""
    z = rng.normal(size=(4, 10, 3))
    a = np.einsum("bki,bmi->bkm", z, z)
    ev, vec, ev_j, vec_j = both(a)
    np.testing.assert_allclose(ev, ev_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vec[..., 7:], vec_j[..., 7:], atol=TOL)

    def null_projector(v):
        return v[..., :7] @ np.swapaxes(v[..., :7], -1, -2)

    np.testing.assert_allclose(null_projector(vec), null_projector(vec_j),
                               atol=TOL)
    np.testing.assert_allclose(rec(vec, ev), a, atol=TOL)


def test_early_exit_checks_all_offdiagonals():
    """diag(1, 2, 3, 4) with a_02 = 0.5: the seated pairs (2i, 2i+1) are
    all zero, the matrix is not converged; one sweep, as in JAX."""
    a = np.diag([1.0, 2.0, 3.0, 4.0])
    a[0, 2] = a[2, 0] = 0.5
    ev, vec, ev_j, vec_j = both(a[None])
    np.testing.assert_allclose(ev, ev_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(vec, vec_j, atol=1e-12)
    np.testing.assert_allclose(ev[0], np.linalg.eigvalsh(a), atol=1e-12)
    _, _, run = k7.eigh_jacobi_plain(t(a[None]), with_sweeps=True)
    assert run.tolist() == [1]


def test_diagonal_input_exits_at_once():
    d = np.array([3.0, 1.0, 4.0, 1.5, 9.0, 2.6])
    ev, vec, ev_j, vec_j = both(np.diag(d)[None])
    assert np.array_equal(ev[0], np.sort(d)) and np.array_equal(ev, ev_j)
    assert np.array_equal(np.abs(vec), np.abs(vec_j))
    assert orth_err(vec) == 0.0
    _, _, run = k7.eigh_jacobi_plain(t(np.diag(d)[None]), with_sweeps=True)
    assert run.tolist() == [0]


def test_exact_plus_minus_tie_is_exact():
    """[[0, 1], [1, 0]]: eigenvalues (-1, 1) and an exact reconstruction,
    as JAX's; the one-sided route freezes at once with V = I and misses by
    1. A K = 6 batch with eigenvalues +-0.5, +-1, +-2 likewise."""
    a = np.array([[[0.0, 1.0], [1.0, 0.0]]])
    ev, vec, ev_j, vec_j = both(a)
    np.testing.assert_allclose(ev[0], [-1.0, 1.0], atol=1e-15)
    np.testing.assert_allclose(vec, vec_j, atol=1e-15)
    np.testing.assert_allclose(rec(vec, ev), a, atol=1e-15)
    ev1, vec1 = eigh_svd_jacobi(t(a))
    assert np.abs(rec(vec1, ev1) - a).max() == pytest.approx(1.0)

    b = with_spectrum(np.random.RandomState(7), 3,
                      [-2.0, -1.0, -0.5, 0.5, 1.0, 2.0])
    ev, vec, ev_j, vec_j = both(b)
    np.testing.assert_allclose(ev, ev_j, atol=TOL)
    np.testing.assert_allclose(vec, vec_j, atol=TOL)
    np.testing.assert_allclose(rec(vec, ev), b, atol=TOL)
    ev1, vec1 = eigh_svd_jacobi(t(b))
    assert np.abs(rec(vec1, ev1) - b).max() > 0.1


def test_several_batch_dims(rng):
    a = rng.normal(size=(2, 3, 6, 6))
    a = a + np.swapaxes(a, -1, -2)
    ev, vec, ev_j, vec_j = both(a)
    assert ev.shape == (2, 3, 6) and vec.shape == (2, 3, 6, 6)
    np.testing.assert_allclose(ev, ev_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vec, vec_j, atol=TOL)
    assert (np.diff(ev, axis=-1) >= 0).all()


def test_sigma_span_1e4_at_the_cap_of_7(rng):
    """SPD, eigenvalues log-spaced over 1e4, K = 40, at the JAX dispatch's
    cap of 7 sweeps. In f64 every matrix is still rotating when the cap
    stops it (the sweep count shows it; nothing else does): the
    reconstruction error stays above 1e-6, over a million times what a cap
    of 20 leaves, and equals JAX's at the same cap. In f32 these matrices
    never pass the exit test (rotations at the noise level go on), and 7
    sweeps leave a reconstruction error below 1e-4."""
    a = with_spectrum(rng, 16, np.logspace(0, -4, 40))
    ev, vec, ev_j, vec_j = both(a)
    np.testing.assert_allclose(ev, ev_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vec, vec_j, atol=TOL)
    _, _, run = k7.eigh_jacobi_plain(t(a), with_sweeps=True)
    assert (run == 8).all()
    err7 = np.abs(rec(vec, ev) - a).max()
    ev20, vec20 = k7.eigh_jacobi_plain(t(a), 20)
    err20 = np.abs(rec(vec20, ev20) - a).max()
    assert err20 < 1e-12
    assert 1e-6 < err7 < 1e-4 and err7 > 1e6 * err20

    a32 = a.astype(np.float32)
    ev, vec, run = k7.eigh_jacobi_plain(t(a32), with_sweeps=True)
    assert (run == 8).all()
    assert np.abs(rec(vec, ev) - a32).max() < 1e-4 and orth_err(vec) < 2e-5
    np.testing.assert_allclose(ev, np.linalg.eigvalsh(a), atol=1e-5)


def test_nan_stays_in_its_matrix(rng):
    a = rng.normal(size=(3, 8, 8))
    a = a + np.swapaxes(a, -1, -2)
    bad = a.copy()
    bad[1, 2, 5] = bad[1, 5, 2] = np.nan
    ev, vec = k7.eigh_jacobi_plain(t(bad))
    # V takes only the finite rotations of live pairs; the NaN shows in A
    assert torch.isnan(ev[1]).any()
    assert torch.isfinite(ev[[0, 2]]).all() and torch.isfinite(vec[[0, 2]]).all()
    for i in (0, 2):
        alone = k7.eigh_jacobi_plain(t(a[i]))
        assert torch.equal(ev[i], alone[0]) and torch.equal(vec[i], alone[1])
    ev_j, vec_j = jax_eigh_jacobi(jnp.asarray(bad), tile=8, interpret=True)
    np.testing.assert_allclose(ev[[0, 2]], np.asarray(ev_j)[[0, 2]],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vec[[0, 2]], np.asarray(vec_j)[[0, 2]],
                               atol=TOL)


def test_odd_k_pad_sorts_last_and_is_sliced(rng):
    """The pad seat of odd K is decoupled: with the largest eigenvalue
    negative, the pad still sorts last and is sliced off."""
    a = with_spectrum(rng, 2, [-5.0, -4.0, -3.0, -2.0, -1.0])
    ev, vec, run = k7.eigh_jacobi_plain(t(a), with_sweeps=True)
    assert ev.shape == (2, 5) and vec.shape == (2, 5, 5)
    np.testing.assert_allclose(ev, np.broadcast_to([-5.0, -4, -3, -2, -1],
                                                   (2, 5)), atol=TOL)
    np.testing.assert_allclose(rec(vec, ev), a, atol=TOL)
    assert (run <= 7).all()


def test_cpu_dispatch_takes_the_plain_version(rng):
    a = t(rng.normal(size=(4, 6, 6)).astype(np.float32))
    a = a + a.mT
    before = dict(k7.LAUNCHES)
    for x, y in zip(k7.eigh_jacobi(a), k7.eigh_jacobi_plain(a)):
        assert torch.equal(x, y)
    out = k7.eigh_jacobi(a, 3, with_sweeps=True)
    assert len(out) == 3 and out[2].shape == (4,)
    assert k7.LAUNCHES == before
    with pytest.raises(ValueError, match="square"):
        k7.eigh_jacobi(a[:, :5])
