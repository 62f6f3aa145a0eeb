// The per-column Chebyshev/Clenshaw solve and weight application of the
// shared route (windows of more than 64 observations) that the 1-D window
// kernel (letkf_window1d.cu, K1), the neighborhood kernel (letkf_nbh_cheb.cu,
// K4) and the 2-D window kernel (letkf_window2d.cu, K6) share; their
// register routes are cheb_pack.cuh (K1, K4) and cheb_reg.cuh (K6). It is
// the port of _cheb_solve_apply in tpu_assim/ops/pallas/letkf.py, and of its
// plain PyTorch twin tpu_assim_torch/ops/cuda/letkf.py:_cheb_solve_apply.
//
// One warp owns one grid column. Its workspace lies in shared memory; the
// caller fills zh (row stride ld), spc, meanc and row 0 of w_all, then calls
// solve_apply, which leaves the column's analysis [ns][k] in spc.
//
// Shared-memory banks: the lanes of a warp read 32 different rows of zh at
// one perturbation index (the Gram matrix, u), so its row stride ld is odd
// (k rounded up to odd): 32 consecutive rows then fall in 32 banks. S is
// exactly symmetric (s[n][m] and s[m][n] are the same products summed in
// the same order), so the lanes that need row n of S read column n, whose
// entries are consecutive across lanes. Neither changes a single rounding.

#pragma once

#include <cuda_runtime.h>

namespace cheb {

constexpr unsigned kFull = 0xffffffffu;

// Maximum and minimum that return NaN when either operand is NaN, as
// jnp.maximum and jnp.minimum do; fmaxf and fminf drop a NaN operand.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Row stride of zh: k rounded up to odd.
__host__ __device__ inline int zh_ld(int k) { return k | 1; }

// Floats of one column's workspace, rounded up to keep 16-byte alignment.
__host__ __device__ inline int workspace_floats(int k, int nb, int ns,
                                                int degree) {
  const int n_ent = (1 + ns) * nb;
  const int floats = nb * zh_ld(k) + nb * nb + ns * k + ns + 4 * n_ent
                     + 4 * (degree + 1);
  return (floats + 3) & ~3;
}

struct Workspace {
  int ld;        // row stride of zh
  float* zh;     // [nb][ld] scaled perturbations (in), the first k used
  float* s_mat;  // [nb][nb] Gram matrix
  float* spc;    // [ns][k] state perturbations (in), the analysis (out)
  float* meanc;  // [ns] state mean (in)
  float* w_all;  // [1 + ns][nb]: yh (in), then u_i = zh sp_i
  float* b0;     // three Clenshaw buffers of [1 + ns][nb]
  float* b1;
  float* b2;
  float* c1;     // [d + 1] coefficients of 1/x
  float* c2;     // [d + 1] of 1/(sqrt(x)(1 + sqrt(x)))
  float* f1x;    // [d + 1] node values
  float* f2x;
};

__device__ __forceinline__ Workspace carve(float* base, int k, int nb, int ns,
                                           int degree) {
  const int n_ent = (1 + ns) * nb, dp1 = degree + 1;
  Workspace w;
  w.ld = zh_ld(k);
  w.zh = base;
  w.s_mat = w.zh + nb * w.ld;
  w.spc = w.s_mat + nb * nb;
  w.meanc = w.spc + ns * k;
  w.w_all = w.meanc + ns;
  w.b0 = w.w_all + n_ent;
  w.b1 = w.b0 + n_ent;
  w.b2 = w.b1 + n_ent;
  w.c1 = w.b2 + n_ent;
  w.c2 = w.c1 + dp1;
  w.f1x = w.c2 + dp1;
  w.f2x = w.f1x + dp1;
  return w;
}

// Steps of the solve, by the warp of lane `lane`:
//  1. S = zh zh^T and u_i = zh sp_i;
//  2. the spectral bound lam_ub = max(1 + min(||S||_inf, tr S)/reg, 1.05);
//  3. Chebyshev coefficients of 1/x and 1/(sqrt(x)(1 + sqrt(x))) on
//     [1, lam_ub] from the mapped nodes;
//  4. one joint Clenshaw recurrence over [yh; u_1..u_ns] with the normalized
//     operator Xt v = (2/(lam_ub - 1)/reg) S v - v: q = X^{-1} yh,
//     v_i = f2(X) u_i;
//  5. spc_i <- mean_i + <u_i, q>/reg + alpha sp_i - (alpha/reg) zh^T v_i.
__device__ inline void solve_apply(const Workspace& w, const float* nodes,
                                   const float* dct, int k, int nb, int ns,
                                   int degree, float reg, int lane) {
  const int dp1 = degree + 1;
  const int n_ent = (1 + ns) * nb;
  const int ld = w.ld;
  const float* zh = w.zh;
  float* s_mat = w.s_mat;
  float* spc = w.spc;
  float* w_all = w.w_all;

  // 1.
  for (int e = lane; e < nb * nb; e += 32) {
    const int n = e / nb, m = e - n * nb;
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk) acc += zh[n * ld + kk] * zh[m * ld + kk];
    s_mat[e] = acc;
  }
  for (int e = lane; e < ns * nb; e += 32) {
    const int i = e / nb, n = e - i * nb;
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk) acc += zh[n * ld + kk] * spc[i * k + kk];
    w_all[nb + e] = acc;
  }
  for (int e = lane; e < n_ent; e += 32) {
    w.b1[e] = 0.0f;
    w.b2[e] = 0.0f;
  }
  __syncwarp();

  // 2.
  float row_max = 0.0f, diag = 0.0f;
  for (int n = lane; n < nb; n += 32) {
    float r = 0.0f;
    for (int m = 0; m < nb; ++m) r += fabsf(s_mat[m * nb + n]);
    row_max = nan_max(row_max, r);
    diag += s_mat[n * nb + n];
  }
  const float inf_norm = warp_max(row_max);
  const float trace = warp_sum(diag);
  const float lam_ub = nan_max(1.0f + nan_min(inf_norm, trace) / reg, 1.05f);

  // 3.
  const float half_w = 0.5f * (lam_ub - 1.0f);
  for (int j = lane; j < dp1; j += 32) {
    const float x = (1.0f + half_w) + half_w * nodes[j];
    const float sq = sqrtf(x);
    w.f1x[j] = 1.0f / x;
    w.f2x[j] = 1.0f / (sq * (1.0f + sq));
  }
  __syncwarp();
  for (int m = lane; m < dp1; m += 32) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int j = 0; j < dp1; ++j) {
      const float d = dct[m * dp1 + j];
      a1 += d * w.f1x[j];
      a2 += d * w.f2x[j];
    }
    w.c1[m] = a1;
    w.c2[m] = a2;
  }
  __syncwarp();

  // 4.
  const float a2_sc = 2.0f / (lam_ub - 1.0f) / reg;
  float* b0 = w.b0;
  float* b1 = w.b1;
  float* b2 = w.b2;
  for (int mi = degree; mi >= 1; --mi) {
    for (int e = lane; e < n_ent; e += 32) {
      const int op = e / nb, n = e - op * nb;
      const float* v = b1 + op * nb;
      float sv = 0.0f;
      for (int m = 0; m < nb; ++m) sv += s_mat[m * nb + n] * v[m];
      const float c = (op == 0) ? w.c1[mi] : w.c2[mi];
      b0[e] = c * w_all[e] + 2.0f * (a2_sc * sv - b1[e]) - b2[e];
    }
    __syncwarp();
    float* t = b2;
    b2 = b1;
    b1 = b0;
    b0 = t;
  }
  float* res = b0;  // q = X^{-1} yh in row 0, v_i = f2(X) u_i in rows 1..
  for (int e = lane; e < n_ent; e += 32) {
    const int op = e / nb, n = e - op * nb;
    const float* v = b1 + op * nb;
    float sv = 0.0f;
    for (int m = 0; m < nb; ++m) sv += s_mat[m * nb + n] * v[m];
    const float c = (op == 0) ? w.c1[0] : w.c2[0];
    res[e] = c * w_all[e] + (a2_sc * sv - b1[e]) - b2[e];
  }
  __syncwarp();

  // 5. Each lane reads and writes only its own entries f of spc.
  const float alpha = sqrtf((static_cast<float>(k) - 1.0f) / reg);
  const float alpha_reg = alpha / reg;
  for (int f = lane; f < ns * k; f += 32) {
    const int i = f / k, kk = f - i * k;
    const float* u = w_all + nb * (1 + i);
    const float* v = res + nb * (1 + i);
    float uq = 0.0f, zv = 0.0f;
    for (int n = 0; n < nb; ++n) {
      uq += u[n] * res[n];
      zv += zh[n * ld + kk] * v[n];
    }
    spc[f] = w.meanc[i] + uq / reg + alpha * spc[f] - alpha_reg * zv;
  }
  __syncwarp();
}

}  // namespace cheb
