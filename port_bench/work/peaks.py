"""
Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W): HBM at 3.35 TB/s, float32 outside the
tensor cores at 67 TFLOP/s. The kernels of the cells compute in f32
without tensor cores.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_ms(flops: float, n_bytes: float):
    """``(ms, "operations" or "bytes")``: the larger of ``flops`` at the f32
    rate and ``n_bytes`` at the HBM rate."""
    t_ops = flops / F32_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
