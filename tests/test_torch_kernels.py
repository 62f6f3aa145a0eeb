"""
The port's kernel family (tpu_assim_torch.ops.kernels) against the JAX
package on the same numpy inputs, in f64 at rtol 1e-12:

- the Gram helpers and each of the eleven concrete kernels and the three
  compositions on [b, n, f] x [b, m, f] batches;
- ``convert.from_tpu_assim`` of each kernel (compositions recursively) and
  of the transforms; a ModuleKernel raises TypeError;
- parameters are buffers, not nn.Parameters;
- the kernelized and transform modules import with JAX blocked.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim.ops import kernels as jk
from tpu_assim import transform as jtr

from tpu_assim_torch import convert
from tpu_assim_torch.ops import kernels as tk
from tpu_assim_torch import transform as ttr

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-12

# (name, constructor arguments): the same on both sides
KERNELS = [
    ("LinearKernel", ()),
    ("GaussKernel", (1.7,)),
    ("RBFKernel", (0.3,)),
    ("PolyKernel", (3.0, 0.7)),
    ("PeriodicKernel", (2.3, 1.4)),
    ("RationalKernel", (1.3, 0.8)),
    ("TanhKernel", (0.4, 0.2)),
    ("OrnsteinUhlenbeckKernel", (2.1,)),
    ("ScaleKernel", (1.9,)),
    ("DiagKernel", (0.6,)),
]


def close(port, ref, rtol=RTOL):
    if isinstance(port, torch.Tensor):
        port = port.detach()
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(ref)).max())


@pytest.fixture
def xy(rng):
    return rng.normal(size=(3, 5, 4)), rng.normal(size=(3, 7, 4))


def gram_pair(jax_kernel, port_kernel, x, y):
    return (port_kernel(torch.from_numpy(x), torch.from_numpy(y)),
            jax_kernel(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("norm", [2.0, 1.0, 3.0])
def test_distance_helpers(xy, norm):
    x, y = xy
    close(tk.distance_matrix(torch.from_numpy(x), torch.from_numpy(y), norm),
          jk.distance_matrix(jnp.asarray(x), jnp.asarray(y), norm))
    close(tk.euclidean_dist(torch.from_numpy(x), torch.from_numpy(y)),
          jk.euclidean_dist(jnp.asarray(x), jnp.asarray(y)))
    close(tk.dot_product(torch.from_numpy(x), torch.from_numpy(y)),
          jk.dot_product(jnp.asarray(x), jnp.asarray(y)))


def test_squared_distance_clamps_at_zero():
    x = torch.tensor([[1e8, 1.0], [1e8, 1.0]], dtype=torch.float64)
    assert (tk.euclidean_dist(x, x) >= 0).all()
    assert (tk.distance_matrix(x, x) >= 0).all()


@pytest.mark.parametrize("name,args", KERNELS)
def test_kernel_matches_jax(xy, name, args):
    x, y = xy
    jax_kernel = getattr(jk, name)(*args)
    port_kernel = getattr(tk, name)(*args)
    for a, b in ((x, y), (x, x)):
        out, ref = gram_pair(jax_kernel, port_kernel, a, b)
        assert out.shape == ref.shape and out.dtype == torch.float64
        close(out, ref)
    # and from the JAX object's attributes
    close(gram_pair(jax_kernel, convert.from_tpu_assim(jax_kernel,
                                                       device="cpu"), x, y)[0],
          gram_pair(jax_kernel, port_kernel, x, y)[1])


@pytest.mark.parametrize("name,args", KERNELS)
def test_kernel_defaults_match_jax(xy, name, args):
    x, y = xy
    out, ref = gram_pair(getattr(jk, name)(), getattr(tk, name)(), x, y)
    close(out, ref)


def test_module_kernel(xy):
    """A feature map of the same math on both sides; the JAX one cannot be
    carried across."""
    x, y = xy
    w = np.random.RandomState(3).normal(size=(4, 6))
    w_t = torch.from_numpy(w)
    jax_kernel = jk.ModuleKernel(lambda v: jnp.tanh(v @ jnp.asarray(w)))
    port_kernel = tk.ModuleKernel(lambda v: torch.tanh(v @ w_t))
    close(*gram_pair(jax_kernel, port_kernel, x, y))
    layer = torch.nn.Linear(4, 6, bias=False, dtype=torch.float64)
    with torch.no_grad():
        layer.weight.copy_(w_t.T)
    module_kernel = tk.ModuleKernel(layer)
    assert dict(module_kernel.named_children()) == {"transform": layer}
    close(module_kernel(torch.from_numpy(x), torch.from_numpy(y)),
          jk.ModuleKernel(lambda v: v @ jnp.asarray(w))(jnp.asarray(x),
                                                        jnp.asarray(y)))
    with pytest.raises(TypeError, match="ModuleKernel"):
        convert.from_tpu_assim(jax_kernel, device="cpu")


@pytest.mark.parametrize("op", ["add", "mul", "pow"])
def test_compositions_match_jax(xy, op):
    x, y = xy
    fn = {"add": lambda a, b: a + b, "mul": lambda a, b: a * b,
          "pow": lambda a, b: a ** b}[op]
    jax_kernel = fn(jk.GaussKernel(1.5) + jk.ScaleKernel(0.5),
                    jk.RationalKernel(1.1, 0.9))
    port_kernel = fn(tk.GaussKernel(1.5) + tk.ScaleKernel(0.5),
                     tk.RationalKernel(1.1, 0.9))
    assert type(port_kernel).__name__ == type(jax_kernel).__name__
    out, ref = gram_pair(jax_kernel, port_kernel, x, y)
    close(out, ref)
    carried = convert.from_tpu_assim(jax_kernel, device="cpu")
    assert isinstance(carried.kernel_1, tk.AdditiveKernel)
    close(carried(torch.from_numpy(x), torch.from_numpy(y)), ref)


def test_parameters_are_buffers():
    kernel = tk.GaussKernel(2.0) * tk.PolyKernel(2.0, 1.0)
    assert list(kernel.parameters()) == []
    names = {n for n, _ in kernel.named_buffers()}
    assert names == {"kernel_1.lengthscale", "kernel_2.degree",
                     "kernel_2.const"}
    assert kernel.kernel_1.lengthscale.dtype == torch.float64
    # an f32 Gram stays f32 with the f64 buffers
    x = torch.ones(2, 3, 4, dtype=torch.float32)
    assert kernel(x, x).dtype == torch.float32


def test_gradient_through_a_buffer_on_request(xy):
    """Gradients are opt-in: requires_grad on a buffer, on the CPU; the
    derivative of sum(K) in the lengthscale against a central difference."""
    x, y = (torch.from_numpy(a) for a in xy)
    ls = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    kernel = tk.GaussKernel(ls)
    kernel(x, y).sum().backward()
    h = 1e-6
    fd = (tk.GaussKernel(1.3 + h)(x, y).sum()
          - tk.GaussKernel(1.3 - h)(x, y).sum()) / (2 * h)
    np.testing.assert_allclose(float(ls.grad), float(fd), rtol=1e-7)


@pytest.mark.parametrize("kind", ["scalar", "array", "normalizer"])
def test_transforms_from_tpu_assim(kind):
    if kind == "normalizer":
        obj = jtr.Normalizer((0.5, 2.0), [(jnp.asarray([0.1, 0.2]), 1.5)],
                             (0.2, 3.0))
    else:
        obj = jtr.MultiplicativeInflation(
            1.3 if kind == "scalar" else jnp.asarray([[[[1.1]], [[1.4]]]]))
    port = convert.from_tpu_assim(obj, device="cpu")
    assert type(port).__name__ == type(obj).__name__
    assert isinstance(port, ttr.BaseTransformer)
    if kind == "normalizer":
        assert port.ens_stat == (0.5, 2.0) and port.fg_stat == (0.2, 3.0)
        close(port.obs_stat[0][0], [0.1, 0.2])
        assert port.obs_stat[0][1] == 1.5
    elif kind == "scalar":
        assert port.inf_factor == 1.3
    else:
        close(port.inf_factor, np.asarray(obj.inf_factor))


def test_kernel_modules_import_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["tpu_assim"] = None
        from tpu_assim_torch import KETKF, LKETKF, _build
        from tpu_assim_torch.interface import ketkf, lketkf
        from tpu_assim_torch.ops import kernels, ketkf as ops_ketkf
        from tpu_assim_torch.ops.cuda import jacobi
        from tpu_assim_torch.transform import (MultiplicativeInflation,
                                               Normalizer)
        assert callable(jacobi.eigh_jacobi) and callable(ops_ketkf.ketkf_weights)
        assert len(kernels.__all__) == 19
        assert "eigh_jacobi" in _build.KERNELS
        assert jacobi.LAUNCHES == {"eigh_jacobi": 0}
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
