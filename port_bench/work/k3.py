"""
K3, the batched SVD (``ops/linalg.py:svd`` -> ``svd_jacobi``,
``csrc/svd_jacobi.cu``): the Golub-Van Loan count for U, Sigma and V of an
n x n matrix, 21 n^3 FLOPs (Golub and Van Loan, Matrix Computations, 4th
ed., sec. 8.6.3), each matrix read once and U, Sigma and V written once.
"""

KERNEL_NAMES = ("svd_jacobi",)
COUNTER = ("tpu_assim_torch.ops.cuda.svd", "svd_jacobi")


def work(batch, n, bytes_per=4):
    """``(flops, bytes)`` of one SVD of ``batch`` n x n matrices."""
    return 21 * n**3 * batch, bytes_per * batch * (3 * n * n + n)
