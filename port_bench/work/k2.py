"""
K2, the Lorenz-96 RK4 forecast (``fused_rk4_steps``, ``csrc/rk4_l96.cu``):
bounded by bytes, the ensemble read once and written once a forecast,
whatever the number of RK4 steps.
"""

KERNEL_NAMES = ("rk4_l96",)
COUNTER = ("tpu_assim_torch.models.cuda_forecast", "rk4_l96")


def work(k, g, n_steps, bytes_per=4):
    """``(flops, bytes)`` of one forecast of ``n_steps`` RK4 steps of a [k,
    g] ensemble: 4 stages of 5 FLOPs a point and 10 for the combination a
    step."""
    return 30 * n_steps * k * g, 2 * bytes_per * k * g
