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
// each for the square roots, 2 for the inverse), 0.45 MFLOP per column at
// nb 12 and n 25, 4.5 GFLOP at grid 10^4: 67 us at the f32 peak. The bytes
// are small (zh [g, nb, k] is 19.2 MB at that shape, read once). So what
// bounds it is how many instructions the SMs issue for those FMAs, and how
// many shared-memory accesses feed them: the first design spread each
// product's entries over a warp's lanes, two shared loads an FMA.
//
// Two routes, by nb (the launcher picks; ops/cuda/letkf.py:nbh_ns_plan
// holds the same arithmetic):
// - register route, nb <= 32, nb a template argument (NB): a column takes
//   NB lanes, one lane per row, and a warp packs 32/NB columns (2 at nb 12
//   and 16, 32 at nb 1). Every iterate lives twice: its row r in the
//   registers of lane r, and as a row of the column's shared slice. In a
//   product C = A B, lane r multiplies its row of A by the rows of B, read
//   as 16-byte loads that every lane of the column reads at once (a
//   broadcast): 4 FMAs a load, NB independent chains a lane. Up to nb 16
//   the row of A is the lane's registers and the m loop is unrolled; beyond,
//   unrolled products no longer fit 255 registers (ptxas spills), so the
//   lane reads its row of A from the slice four entries at a time in a
//   rolled loop (one more load for every 4·NB FMAs). Each result row is
//   stored once, and one __syncwarp separates two products; the coupled
//   loop rotates three slices (Y, T, Z) so that no product overwrites the
//   slice it reads, and a fourth holds C for the inverse. The columns'
//   slices are 4 mod 8 floats apart, so the packed columns' broadcasts fall
//   in different banks (up to 8 columns a warp; more, at nb <= 3, take more
//   wavefronts). Sums run in the order of the shared route: m ascending,
//   one FMA each (products, the Gram over k, u, q, v, Zh^T v), and the row
//   sums ascending; only the trace and <q, u> sum in another order
//   (ascending over the column's lanes, where the shared route reduces
//   across the warp). At nb 12 a warp issues about 200 instructions a
//   product for its two columns (144 FMAs, 36 loads), so by reckoning the
//   SMs' issue rate bounds it now, not shared-memory bandwidth.
// - shared route, nb > 32: one warp a column, zh and six nb x nb iterates
//   in the warp's shared slice, lanes spread over the entries of each
//   product (two shared loads an FMA).
// Inputs are columns-first ([g, nb, k], [g, k]), so each column's inputs
// are one contiguous run.

#include <cuda_runtime.h>

#include "cheb_core.cuh"

namespace {

constexpr int kMaxWarps = 4;   // warps a block, both routes
constexpr int kRegMaxNb = 32;  // largest nb of the register route
// Up to this nb a product's left factor comes from the lane's registers,
// its m loop unrolled; beyond, from the lane's row of the slice, four
// entries at a time in a rolled loop (unrolled, those products do not fit
// 255 registers: ptxas spills).
constexpr int kRegRowMaxNb = 16;

using cheb::kFull;
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
  int per_col;        // floats of shared memory per column
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Row stride of the register route's iterates: nb rounded up to an odd
// number of float4s, so that the lanes storing 8 consecutive rows hit 8
// different bank quads.
__host__ __device__ constexpr int mat_ld(int nb) {
  return (round4(nb) / 4) % 2 ? round4(nb) : round4(nb) + 4;
}

// Floats of one column's shared slice on the register route: zh
// transposed [k][round4(nb)], sp [round4(k)], yh, u, v [round4(nb)] each
// and four iterates [nb][mat_ld]; 4 mod 8 in all, so that the slices of
// a warp's columns start in different bank quads.
__host__ __device__ constexpr int reg_col_floats(int k, int nb) {
  const int f = k * round4(nb) + round4(k) + 3 * round4(nb)
                + 4 * nb * mat_ld(nb);
  return f % 8 ? f : f + 4;
}

// ... and on the shared route: zh [nb][k], sp [k], yh, u, q, v [nb] and
// six iterates [nb][nb], rounded up to whole float4s.
__host__ __device__ constexpr int smem_col_floats(int k, int nb) {
  return round4(nb * k + k + 4 * nb + 6 * nb * nb);
}

// -- the shared route (nb > 32) ----------------------------------------------

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

__global__ void __launch_bounds__(kMaxWarps * 32)
nbh_ns_smem_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * (blockDim.x >> 5) + warp;
  if (col >= p.g) return;  // whole warps leave; nothing below syncs blocks

  const int k = p.k, nb = p.nb, nn = nb * nb;
  float* zh = smem + static_cast<size_t>(warp) * p.per_col;  // [nb][k]
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

// -- the register route (nb <= 32) -------------------------------------------

// acc[j] = fma(a, b[j], acc[j]) for j < NB; b is 16-byte aligned shared
// memory, read as float4s that the column's lanes read at once.
template <int NB>
__device__ __forceinline__ void fma_row(float a, const float* b,
                                        float (&acc)[NB]) {
#pragma unroll
  for (int q = 0; q < round4(NB) / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(b)[q];
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < NB) acc[4 * q + i] = fmaf(a, xs[i], acc[4 * q + i]);
  }
}

// acc = a B: the lane's row of a product whose right factor B
// [NB][mat_ld(NB)] lies in shared memory and whose left factor's row is a
// (registers) or, for NB > kRegRowMaxNb, a_sh (the same row in shared
// memory); m ascending, one FMA each.
template <int NB>
__device__ __forceinline__ void row_times(const float (&a)[NB],
                                          const float* a_sh, const float* b,
                                          float (&acc)[NB]) {
  constexpr int ld = mat_ld(NB);
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j] = 0.0f;
  if constexpr (NB <= kRegRowMaxNb) {
#pragma unroll
    for (int m = 0; m < NB; ++m) fma_row<NB>(a[m], b + m * ld, acc);
  } else {
#pragma unroll 1
    for (int m = 0; m < (NB & ~3); m += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_sh + m);
      fma_row<NB>(a4.x, b + m * ld, acc);
      fma_row<NB>(a4.y, b + (m + 1) * ld, acc);
      fma_row<NB>(a4.z, b + (m + 2) * ld, acc);
      fma_row<NB>(a4.w, b + (m + 3) * ld, acc);
    }
    constexpr int m0 = NB & ~3;
    if constexpr (m0 < NB) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_sh + m0);
      const float as[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < NB - m0; ++i)
        fma_row<NB>(as[i], b + (m0 + i) * ld, acc);
    }
  }
}

// Row r of the iterate b [NB][mat_ld(NB)] <- x, by the lanes that own a
// column (the pad entries get 0).
template <int NB>
__device__ __forceinline__ void store_row(float* b, int r,
                                          const float (&x)[NB], bool owner) {
  float4* row = reinterpret_cast<float4*>(b + r * mat_ld(NB));
#pragma unroll
  for (int q = 0; q < round4(NB) / 4; ++q) {
    const int j = 4 * q;
    const float4 v = make_float4(x[j], j + 1 < NB ? x[j + 1] : 0.0f,
                                 j + 2 < NB ? x[j + 2] : 0.0f,
                                 j + 3 < NB ? x[j + 3] : 0.0f);
    if (owner) row[q] = v;
  }
}

// x <- row r of b [NB][mat_ld(NB)].
template <int NB>
__device__ __forceinline__ void load_row(const float* b, int r,
                                         float (&x)[NB]) {
  const float4* row = reinterpret_cast<const float4*>(b + r * mat_ld(NB));
#pragma unroll
  for (int q = 0; q < round4(NB) / 4; ++q) {
    const float4 v = row[q];
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * q + i < NB) x[4 * q + i] = vs[i];
  }
}

// Sum and NaN-keeping maximum of v over the column's NB lanes (base the
// first), ascending, the same in each of them.
template <int NB>
__device__ __forceinline__ float col_sum(float v, int base) {
  float s = 0.0f;
#pragma unroll
  for (int n = 0; n < NB; ++n) s += __shfl_sync(kFull, v, base + n);
  return s;
}
template <int NB>
__device__ __forceinline__ float col_max(float v, int base) {
  float s = 0.0f;
#pragma unroll
  for (int n = 0; n < NB; ++n) s = nan_max(s, __shfl_sync(kFull, v, base + n));
  return s;
}

__device__ __forceinline__ float eye(int r, int j) {
  return r == j ? 1.0f : 0.0f;
}

// x, hidden from the compiler: the identity's entries of row r are then
// made where a loop uses them, not hoisted out of it into NB registers
// (hoisted, they made ptxas spill at some NB).
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

template <int NB>
__global__ void __launch_bounds__(kMaxWarps * 32)
nbh_ns_reg_kernel(const Params p) {
  constexpr int kCols = 32 / NB;  // columns a warp
  constexpr bool kRegRow = NB <= kRegRowMaxNb;
  constexpr int kNbp = round4(NB);
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Lanes past the warp's last column (32 mod NB of them) shadow a row of
  // its last column: they compute what that row's lane computes, read
  // only, and store nothing.
  const bool owner = lane < kCols * NB;
  const int slot = owner ? lane / NB : kCols - 1;
  const int r = lane % NB;
  const int own = r * mat_ld(NB);  // the lane's row in an iterate
  const int base = slot * NB;  // the column's first lane
  const int col = (blockIdx.x * (blockDim.x >> 5) + warp) * kCols + slot;
  const bool in_grid = col < p.g;  // past g: zeros in, nothing out
  const int k = p.k;

  float* zht = smem + static_cast<size_t>(warp * kCols + slot) * p.per_col;
  float* spc = zht + k * kNbp;    // [k]
  float* yhs = spc + round4(k);   // [kNbp]
  float* us = yhs + kNbp;         // [kNbp]
  float* vs = us + kNbp;          // [kNbp]
  float* ysh = vs + kNbp;         // four iterates [NB][mat_ld]
  float* tsh = ysh + NB * mat_ld(NB);
  float* zsh = tsh + NB * mat_ld(NB);
  float* csh = zsh + NB * mat_ld(NB);

  const size_t c = static_cast<size_t>(col);
  if (owner) {
#pragma unroll 1
    for (int n = 0; n < NB; ++n)
#pragma unroll 1
      for (int kk = r; kk < k; kk += NB)
        zht[kk * kNbp + n] = in_grid ? p.zh[(c * NB + n) * k + kk] : 0.0f;
#pragma unroll 1
    for (int kk = r; kk < k; kk += NB)
      spc[kk] = in_grid ? p.sp[c * k + kk] : 0.0f;
    yhs[r] = in_grid ? p.yh[c * NB + r] : 0.0f;
  }
  __syncwarp();

  // row r of X = I + S/reg and u_r = zh_r sp, k ascending
  float acc[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j] = 0.0f;
  float u = 0.0f;
#pragma unroll 1
  for (int kk = 0; kk < k; ++kk) {
    const float a = zht[kk * kNbp + r];
    fma_row<NB>(a, zht + kk * kNbp, acc);
    u = fmaf(a, spc[kk], u);
  }
  float yr[NB], zr[NB], tr[NB];
  float row_sum = 0.0f, diag = 0.0f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    yr[j] = eye(r, j) + acc[j] / p.reg;
    row_sum += fabsf(yr[j]);
    if (j == r) diag = yr[j];
  }
  if (owner) us[r] = u;

  // coupled Newton-Schulz: Y = X/norm, Z = I; T = (3I - Z Y)/2, Y <- Y T,
  // Z <- T Z. T goes to tsh; Z <- T Z reads zsh and goes to tsh, which
  // then becomes zsh.
  const float norm =
      0.5f * (nan_min(col_sum<NB>(diag, base), col_max<NB>(row_sum, base))
              + 1.0f);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    yr[j] = yr[j] / norm;
    zr[j] = eye(r, j);
  }
  store_row<NB>(ysh, r, yr, owner);
  store_row<NB>(zsh, r, zr, owner);
  __syncwarp();
#pragma unroll 1
  for (int it = 0; it < p.iters; ++it) {
    const int ri = opaque(r);
    row_times<NB>(zr, zsh + own, ysh, acc);
#pragma unroll
    for (int j = 0; j < NB; ++j) tr[j] = 0.5f * (3.0f * eye(ri, j) - acc[j]);
    store_row<NB>(tsh, r, tr, owner);
    __syncwarp();
    row_times<NB>(yr, ysh + own, tsh, acc);
#pragma unroll
    for (int j = 0; j < NB; ++j) yr[j] = acc[j];
    store_row<NB>(ysh, r, yr, owner);
    __syncwarp();
    row_times<NB>(tr, tsh + own, zsh, acc);
#pragma unroll
    for (int j = 0; j < NB; ++j) zr[j] = acc[j];
    store_row<NB>(tsh, r, zr, owner);
    float* tmp = tsh;
    tsh = zsh;
    zsh = tmp;
    __syncwarp();
  }

  // yr <- X^{1/2} + I (the matrix C of the inverse, to csh), zr <-
  // X^{-1/2}; q_r = (X^{-1/2} X^{-1/2})_r yh. Where products read their
  // left rows from the slice, Y's row is read back here rather than held
  // in registers through the loop (and V's below).
  if constexpr (!kRegRow) load_row<NB>(ysh, r, yr);
  const float sqrt_norm = sqrtf(norm);
  row_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    yr[j] = yr[j] * sqrt_norm + eye(r, j);
    zr[j] = zr[j] / sqrt_norm;
    row_sum += fabsf(yr[j]);
  }
  store_row<NB>(zsh, r, zr, owner);
  store_row<NB>(csh, r, yr, owner);
  __syncwarp();
  row_times<NB>(zr, zsh + own, zsh, acc);
  float q = 0.0f;
#pragma unroll
  for (int m = 0; m < NB; ++m) q = fmaf(acc[m], yhs[m], q);

  // Newton-Schulz inverse of C: V = scale I; W = I - C V (to tsh),
  // V <- V + V W (to ysh)
  const float scale = 2.0f / (2.0f + col_max<NB>(row_sum, base));
  float* vsh = ysh;
#pragma unroll
  for (int j = 0; j < NB; ++j) tr[j] = scale * eye(r, j);
  store_row<NB>(vsh, r, tr, owner);
  __syncwarp();
#pragma unroll 1
  for (int it = 0; it < p.iters; ++it) {
    const int ri = opaque(r);
    row_times<NB>(yr, csh + own, vsh, acc);
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[j] = eye(ri, j) - acc[j];
    store_row<NB>(tsh, r, acc, owner);
    __syncwarp();
    if constexpr (!kRegRow) load_row<NB>(vsh, r, tr);
    row_times<NB>(tr, vsh + own, tsh, acc);
#pragma unroll
    for (int j = 0; j < NB; ++j) tr[j] = tr[j] + acc[j];
    store_row<NB>(vsh, r, tr, owner);
    __syncwarp();
  }

  // N_r = (C^{-1} X^{-1/2})_r, v_r = N_r u, <q, u>
  row_times<NB>(tr, vsh + own, zsh, acc);
  float v = 0.0f;
#pragma unroll
  for (int m = 0; m < NB; ++m) v = fmaf(acc[m], us[m], v);
  const float mean_upd = col_sum<NB>(q * u, base) / p.reg;
  if (owner) vs[r] = v;
  __syncwarp();

  const float alpha = sqrtf((static_cast<float>(k) - 1.0f) / p.reg);
  const float alpha_reg = alpha / p.reg;
  if (!owner || !in_grid) return;
  const float mean = p.mean[col] + mean_upd;
#pragma unroll 1
  for (int kk = r; kk < k; kk += NB) {
    float zv = 0.0f;
#pragma unroll
    for (int n = 0; n < NB; ++n) zv = fmaf(zht[kk * kNbp + n], vs[n], zv);
    p.out[c * k + kk] = mean + (alpha * spc[kk] - alpha_reg * zv);
  }
}

using Kernel = void (*)(const Params);

int launch(Kernel kernel, const Params& p, int warps, int blocks,
           size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, warps * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_reg(int nb, const Params& p, int warps, int blocks, size_t smem,
               cudaStream_t st) {
  if (nb == NB)
    return launch(nbh_ns_reg_kernel<NB>, p, warps, blocks, smem, st);
  if constexpr (NB < kRegMaxNb) {
    return launch_reg<NB + 1>(nb, p, warps, blocks, smem, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Grid columns one warp takes: 32/nb on the register route, 1 beyond.
int nbh_ns_cols_per_warp(int nb) { return nb <= kRegMaxNb ? 32 / nb : 1; }

// Bytes of shared memory of a block of `warps` warps.
size_t nbh_ns_smem_bytes(int k, int nb, int warps) {
  const int per_col = nb <= kRegMaxNb ? reg_col_floats(k, nb)
                                      : smem_col_floats(k, nb);
  return static_cast<size_t>(warps) * nbh_ns_cols_per_warp(nb) * per_col
         * sizeof(float);
}

// The analysis of every grid column in `blocks` blocks of `warps` warps
// (ops/cuda/letkf.py:nbh_ns_plan); all pointers are device memory. Returns
// the cudaError_t of the launch (0 on success).
int nbh_ns_launch(const float* zh, const float* yh, const float* sp,
                  const float* mean, float* out, int k, int g, int nb,
                  int iters, float reg, int warps, int blocks, void* stream) {
  if (g <= 0) return 0;
  if (nb < 1 || warps < 1 || warps > kMaxWarps || blocks < 1
      || static_cast<long long>(blocks) * warps * nbh_ns_cols_per_warp(nb)
             < g)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = nbh_ns_smem_bytes(k, nb, warps);
  const Params p{zh, yh, sp, mean, out, k, g, nb, iters, reg,
                 nb <= kRegMaxNb ? reg_col_floats(k, nb)
                                 : smem_col_floats(k, nb)};
  if (nb > kRegMaxNb)
    return launch(nbh_ns_smem_kernel, p, warps, blocks, smem, st);
  return launch_reg<1>(nb, p, warps, blocks, smem, st);
}

const char* nbh_ns_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
