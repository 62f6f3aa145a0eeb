"""
K1, the 1-D window LETKF analysis (``letkf_window_analysis_fused``,
``csrc/letkf_window1d.cu``): per grid column the Gram matrix of its ``nb``
window observations, the Chebyshev/Clenshaw solve of degree ``degree`` and
the apply (``cheb_flops``); the state read once, the analysis written once
and the observation arrays read once. ``check_sorted_kernel``, which K1's
own launcher in ``letkf_window1d.cu`` runs before the analysis kernel, is
K1's time too.
"""

KERNEL_NAMES = ("window1d", "check_sorted")
COUNTER = ("tpu_assim_torch.ops.cuda.letkf", "window1d")


def cheb_flops(k, nb, ns, degree):
    """FLOPs of one column's Chebyshev solve and apply: the symmetric Gram
    matrix (nb (nb + 1) / 2 entries of k multiply-adds), u_i = Zh sp_i, the
    degree + 1 Clenshaw steps over 1 + ns operands (a matvec and 5 FLOPs
    per entry), the apply."""
    return (nb * (nb + 1) * k + 2 * ns * nb * k
            + (degree + 1) * (1 + ns) * nb * (2 * nb + 5)
            + ns * k * (4 * nb + 4))


def work(k, g, o, nb, degree, bytes_per=4):
    """``(flops, bytes)`` of one analysis of ``k`` members on ``g`` columns
    with ``o`` observations: the state perturbations [k, g] and mean [g]
    in, the analysis [k, g] out; perturbations [k, o], innovations [o],
    observation [o] and grid [g] coordinates in."""
    flops = g * cheb_flops(k, nb, 1, degree)
    n_bytes = bytes_per * (2 * k * g + g + k * o + 2 * o + g)
    return flops, n_bytes
