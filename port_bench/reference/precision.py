"""
The arithmetic of the reference's products.

``"f64"`` computes in float64 (the reference), and ``"tf32"`` (the
control) in float32 with each product's operands rounded to TF32 (10
explicit mantissa bits, round to nearest even) before an f32 product:
what a tensor-core TF32 GEMM computes. The rounding is written
out, so that the control is the same on every device and for every shape
(cuBLAS takes its TF32 kernels only for some shapes).
"""

import torch

PRECISIONS = ("f64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}; got "
                         f"{precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


class Products:
    """``einsum`` in one of :data:`PRECISIONS`."""

    def __init__(self, precision: str):
        self.dtype = dtype_of(precision)
        self.tf32 = precision == "tf32"

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def einsum(self, spec: str, *operands: torch.Tensor) -> torch.Tensor:
        ops = [self.cast(t) for t in operands]
        if self.tf32:
            ops = [round_tf32(t) for t in ops]
        return torch.einsum(spec, *ops)
