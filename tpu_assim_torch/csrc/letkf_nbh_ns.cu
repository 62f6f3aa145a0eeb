// The localized ETKF analysis over gathered observation neighborhoods,
// Woodbury form solved by Newton-Schulz iterations (kernel K5). Per grid
// column, with X = I + Zh Zh^T / reg (nb x nb):
//   coupled Newton-Schulz on X/norm, norm = (min(tr X, max row-sum |X|) + 1)/2
//     -> X^{1/2}, X^{-1/2};  X^{-1} = X^{-1/2} X^{-1/2};
//   Newton-Schulz inverse of C = X^{1/2} + I from 2/(2 + max row-sum |C|) I;
//   N = C^{-1} X^{-1/2};
//   analysis = mean + <q, u>/reg + alpha sp - (alpha/reg) Zh^T N u,
//   u = Zh sp, q = X^{-1} yh, alpha = sqrt((K - 1)/reg).
//
// Replaces the TPU kernel tpu_assim/ops/pallas/letkf.py:
// letkf_nbh_analysis_fused (kernel _letkf_kernel with _coupled_ns and
// _ns_inverse). The plain PyTorch twin is tpu_assim_torch/ops/cuda/letkf.py:
// nbh_fused_plain, which follows the same steps in the same order.
//
// What bounds it on an H100: each column is one chain of about 5 n + 5
// dependent nb x nb matrix products (n Newton-Schulz iterations: 3 products
// each for the square roots, 2 for the inverse), about 0.4 MFLOP per column
// at nb 12 and n 25, 4 GFLOP at grid 10^4: some 60 us of f32 work for the
// whole card, while a column's chain of ~130 products takes far longer. The
// bytes are small: zh [g, nb, k] is 19.2 MB at the headline shape, read once.
// The design keeps a column's whole solve in one warp: zh, the state
// perturbations and six nb x nb iterates sit in the warp's slice of shared
// memory, lanes spread over the entries of each product, and a __syncwarp
// separates the products. Inputs are columns-first ([g, nb, k], [g, k]), so
// each warp reads its own column as one contiguous run.

#include <cuda_runtime.h>

#include "cheb_core.cuh"

namespace {

constexpr int kMaxCols = 4;  // grid columns (warps) per block

using cheb::nan_max;
using cheb::nan_min;
using cheb::warp_max;
using cheb::warp_sum;

struct Params {
  const float* zh;    // [g, nb, k] scaled neighborhood perturbations
  const float* yh;    // [g, nb] scaled innovations
  const float* sp;    // [g, k] state perturbations
  const float* mean;  // [g] state mean
  float* out;         // [g, k]
  int k, g, nb, iters;
  float reg;          // (K - 1) / rho
  int per_warp;       // floats of shared memory per column
};

// c = a b for nb x nb matrices in shared memory, lanes over the entries of c.
// mode 0: c = a b;  mode 1: c = (3 I - a b)/2;  mode 2: c = I - a b;
// mode 3: c = d + a b.
__device__ __forceinline__ void matmul(const float* a, const float* b,
                                       float* c, const float* d, int nb,
                                       int mode, int lane) {
  for (int e = lane; e < nb * nb; e += 32) {
    const int i = e / nb, j = e - i * nb;
    float acc = 0.0f;
    for (int m = 0; m < nb; ++m) acc += a[i * nb + m] * b[m * nb + j];
    const float eye = (i == j) ? 1.0f : 0.0f;
    if (mode == 1) acc = 0.5f * (3.0f * eye - acc);
    else if (mode == 2) acc = eye - acc;
    else if (mode == 3) acc = d[e] + acc;
    c[e] = acc;
  }
  __syncwarp();
}

// Spectral bound min(trace, max row-sum |a|) (with_trace) or max row-sum |a|
// of an nb x nb matrix, NaN-keeping, the same in every lane.
__device__ __forceinline__ float row_sum_bound(const float* a, int nb,
                                               bool with_trace, int lane) {
  float row_max = 0.0f, diag = 0.0f;
  for (int n = lane; n < nb; n += 32) {
    float r = 0.0f;
    for (int m = 0; m < nb; ++m) r += fabsf(a[n * nb + m]);
    row_max = nan_max(row_max, r);
    diag += a[n * nb + n];
  }
  const float inf_norm = warp_max(row_max);
  return with_trace ? nan_min(warp_sum(diag), inf_norm) : inf_norm;
}

__global__ void nbh_ns_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * (blockDim.x >> 5) + warp;
  if (col >= p.g) return;  // whole warps leave; nothing below syncs blocks

  const int k = p.k, nb = p.nb, nn = nb * nb;
  float* zh = smem + static_cast<size_t>(warp) * p.per_warp;  // [nb][k]
  float* spc = zh + nb * k;     // [k]
  float* yh = spc + k;          // [nb]
  float* u = yh + nb;           // [nb]
  float* q = u + nb;            // [nb]
  float* v = q + nb;            // [nb]
  float* m0 = v + nb;           // six nb x nb matrices
  float* m1 = m0 + nn;
  float* m2 = m1 + nn;
  float* m3 = m2 + nn;
  float* m4 = m3 + nn;
  float* m5 = m4 + nn;

  const size_t c = static_cast<size_t>(col);
  for (int f = lane; f < nb * k; f += 32) zh[f] = p.zh[c * nb * k + f];
  for (int f = lane; f < k; f += 32) spc[f] = p.sp[c * k + f];
  for (int f = lane; f < nb; f += 32) yh[f] = p.yh[c * nb + f];
  __syncwarp();

  // X = I + S/reg into m0
  for (int e = lane; e < nn; e += 32) {
    const int n = e / nb, m = e - n * nb;
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk) acc += zh[n * k + kk] * zh[m * k + kk];
    m0[e] = ((n == m) ? 1.0f : 0.0f) + acc / p.reg;
  }
  __syncwarp();

  // coupled Newton-Schulz: Y = X/norm (m0), Z = I (m1); T (m2); Y T (m3),
  // T Z (m4)
  const float norm = 0.5f * (row_sum_bound(m0, nb, true, lane) + 1.0f);
  float* y = m0;
  float* z = m1;
  float* t = m2;
  float* yn = m3;
  float* zn = m4;
  for (int e = lane; e < nn; e += 32) {
    y[e] = y[e] / norm;
    z[e] = (e / nb == e % nb) ? 1.0f : 0.0f;
  }
  __syncwarp();
  for (int it = 0; it < p.iters; ++it) {
    matmul(z, y, t, nullptr, nb, 1, lane);
    matmul(y, t, yn, nullptr, nb, 0, lane);
    matmul(t, z, zn, nullptr, nb, 0, lane);
    float* tmp = y;
    y = yn;
    yn = tmp;
    tmp = z;
    z = zn;
    zn = tmp;
  }
  // y <- X^{1/2} + I (the matrix C of the inverse), z <- X^{-1/2}
  const float sqrt_norm = sqrtf(norm);
  for (int e = lane; e < nn; e += 32) {
    y[e] = y[e] * sqrt_norm + ((e / nb == e % nb) ? 1.0f : 0.0f);
    z[e] = z[e] / sqrt_norm;
  }
  __syncwarp();
  float* x_inv = t;  // X^{-1} = X^{-1/2} X^{-1/2}
  matmul(z, z, x_inv, nullptr, nb, 0, lane);

  // Newton-Schulz inverse of C: V = scale I (yn), W = I - C V (m5),
  // V <- V + V W (zn)
  const float scale = 2.0f / (2.0f + row_sum_bound(y, nb, false, lane));
  float* vv = yn;
  float* vn = zn;
  float* w = m5;
  for (int e = lane; e < nn; e += 32)
    vv[e] = scale * ((e / nb == e % nb) ? 1.0f : 0.0f);
  __syncwarp();
  for (int it = 0; it < p.iters; ++it) {
    matmul(y, vv, w, nullptr, nb, 2, lane);
    matmul(vv, w, vn, vv, nb, 3, lane);
    float* tmp = vv;
    vv = vn;
    vn = tmp;
  }
  float* n_mat = vn;  // N = C^{-1} X^{-1/2}
  matmul(vv, z, n_mat, nullptr, nb, 0, lane);

  // u = zh sp, q = X^{-1} yh, then v = N u
  for (int n = lane; n < nb; n += 32) {
    float acc_u = 0.0f, acc_q = 0.0f;
    for (int kk = 0; kk < k; ++kk) acc_u += zh[n * k + kk] * spc[kk];
    for (int m = 0; m < nb; ++m) acc_q += x_inv[n * nb + m] * yh[m];
    u[n] = acc_u;
    q[n] = acc_q;
  }
  __syncwarp();
  float qu = 0.0f;
  for (int n = lane; n < nb; n += 32) {
    float acc = 0.0f;
    for (int m = 0; m < nb; ++m) acc += n_mat[n * nb + m] * u[m];
    v[n] = acc;
    qu += q[n] * u[n];
  }
  const float mean_upd = warp_sum(qu) / p.reg;
  __syncwarp();

  const float alpha = sqrtf((static_cast<float>(k) - 1.0f) / p.reg);
  const float alpha_reg = alpha / p.reg;
  const float mean = p.mean[col] + mean_upd;
  for (int kk = lane; kk < k; kk += 32) {
    float zv = 0.0f;
    for (int n = 0; n < nb; ++n) zv += zh[n * k + kk] * v[n];
    p.out[c * k + kk] = mean + (alpha * spc[kk] - alpha_reg * zv);
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory one grid column's warp uses; a block holds up to
// 4 of them.
size_t nbh_ns_smem_bytes_per_col(int k, int nb) {
  const int floats = nb * k + k + 4 * nb + 6 * nb * nb;
  return static_cast<size_t>((floats + 3) & ~3) * sizeof(float);
}

// The analysis of every grid column; all pointers are device memory.
// smem_limit is the shared memory one block may use. Returns the
// cudaError_t of the launch (0 on success).
int nbh_ns_launch(const float* zh, const float* yh, const float* sp,
                  const float* mean, float* out, int k, int g, int nb,
                  int iters, float reg, int smem_limit, void* stream) {
  if (g <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t per_col = nbh_ns_smem_bytes_per_col(k, nb);
  int cols = kMaxCols;
  while (cols > 1 && static_cast<size_t>(cols) * per_col >
                         static_cast<size_t>(smem_limit))
    cols >>= 1;
  const size_t smem = static_cast<size_t>(cols) * per_col;
  Params p{zh, yh, sp, mean, out, k, g, nb, iters, reg,
           static_cast<int>(per_col / sizeof(float))};
  cudaError_t err = cudaFuncSetAttribute(
      nbh_ns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nbh_ns_kernel<<<(g + cols - 1) / cols, cols * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* nbh_ns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
