"""The port's native host runtime (C++ via ctypes; PyTorch port of
:mod:`tpu_assim.runtime`): the CPU LETKF, obs bucketing and taper in
:mod:`~tpu_assim_torch.runtime.native`, and the background obs-ingest
loader in :mod:`~tpu_assim_torch.runtime.obs_pipeline`."""

from tpu_assim_torch.runtime.native import (
    native_available,
    letkf_weights_dense_cpu,
    etkf_weights_cpu,
    bucket_obs_cpu,
    gaspari_cohn_cpu,
)

__all__ = [
    "native_available",
    "letkf_weights_dense_cpu",
    "etkf_weights_cpu",
    "bucket_obs_cpu",
    "gaspari_cohn_cpu",
]
