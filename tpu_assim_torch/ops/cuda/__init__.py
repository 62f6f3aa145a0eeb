"""Hand-written CUDA kernels and their plain PyTorch twins (port of
:mod:`tpu_assim.ops.pallas`)."""
