// The Gaspari-Cohn tapers that the window kernels (letkf_window1d.cu, K1,
// and letkf_window2d.cu, K6) evaluate per observation: the polynomials of
// tpu_assim_torch/ops/localization.py with their Python constants rounded
// to f32, and their plain PyTorch twin
// tpu_assim_torch/ops/cuda/letkf.py:_taper_poly.

#pragma once

#include <cuda_runtime.h>

namespace taper {

// GC(z, 1/2, c): z < 1 and 1 <= z < 2.
__device__ __forceinline__ float gc2_f1(float z) {
  const float z2 = z * z, z3 = z2 * z, z4 = z2 * z2, z5 = z4 * z;
  return -0.25f * z5 + 0.5f * z4 + 0.625f * z3 - (5.0f / 3.0f) * z2 + 1.0f;
}
__device__ __forceinline__ float gc2_f2(float z) {
  const float z2 = z * z, z3 = z2 * z, z4 = z2 * z2, z5 = z4 * z;
  return (1.0f / 12.0f) * z5 - 0.5f * z4 + 0.625f * z3 + (5.0f / 3.0f) * z2
         - 5.0f * z + 4.0f - (2.0f / 3.0f) / z;
}
// GC(z, inf, c): z < 0.5, 0.5 <= z < 1, 1 <= z < 1.5, 1.5 <= z < 2.
__device__ __forceinline__ float gci_f1(float z) {
  const float z2 = z * z, z3 = z2 * z, z4 = z2 * z2, z5 = z4 * z;
  return -28.0f * z5 / 33.0f + 8.0f * z4 / 11.0f + 20.0f * z3 / 11.0f
         - 80.0f * z2 / 33.0f + 1.0f;
}
__device__ __forceinline__ float gci_f2(float z) {
  const float z2 = z * z, z4 = z2 * z2, z5 = z4 * z;
  return 20.0f * z5 / 33.0f - 16.0f * z4 / 11.0f + 100.0f * z2 / 33.0f
         - 45.0f * z / 11.0f + (51.0f / 22.0f) - 7.0f / (44.0f * z);
}
__device__ __forceinline__ float gci_f3(float z) {
  const float z2 = z * z, z3 = z2 * z, z4 = z2 * z2, z5 = z4 * z;
  return -4.0f * z5 / 11.0f + 16.0f * z4 / 11.0f - 10.0f * z3 / 11.0f
         - 100.0f * z2 / 33.0f + 5.0f * z - (61.0f / 22.0f)
         + 115.0f / (132.0f * z);
}
__device__ __forceinline__ float gci_f4(float z) {
  const float z2 = z * z, z3 = z2 * z, z4 = z2 * z2, z5 = z4 * z;
  return 4.0f * z5 / 33.0f - 8.0f * z4 / 11.0f + 10.0f * z3 / 11.0f
         + 80.0f * z2 / 33.0f - 80.0f * z / 11.0f + (64.0f / 11.0f)
         - 32.0f / (33.0f * z);
}

// The taper polynomial of a normalized distance z = |d| / radius, uncut
// (0 from z = 2; taper 0 is GC(z, 1/2, c), 1 is GC(z, inf, c)). The
// off-branch argument is clamped so the 1/z terms stay finite.
__device__ __forceinline__ float poly(float z, int kind) {
  float w;
  if (kind == 0) {
    const float zs = fmaxf(z, 0.5f);
    w = (z < 2.0f) ? gc2_f2(zs) : 0.0f;
    if (z < 1.0f) w = gc2_f1(z);
  } else {
    const float zs = fmaxf(z, 0.25f);
    w = (z < 2.0f) ? gci_f4(zs) : 0.0f;
    if (z < 1.5f) w = gci_f3(zs);
    if (z < 1.0f) w = gci_f2(zs);
    if (z < 0.5f) w = gci_f1(z);
  }
  return w;
}

// The taper weight cut to 0 at or below eps (eps 0 cuts only the rounding
// residue below 0, as the 2-D kernel does per dimension before its cut of
// the product).
__device__ __forceinline__ float weight(float z, int kind, float eps) {
  const float w = poly(z, kind);
  return (w > eps) ? w : 0.0f;
}

}  // namespace taper
