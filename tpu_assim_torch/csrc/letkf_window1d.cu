// The whole 1-D window LETKF analysis in one kernel: window selection over
// sorted observation coordinates, Gaspari-Cohn taper, gather, and the
// Chebyshev/Clenshaw solve and weight application, per grid column.
//
// Replaces the TPU kernel tpu_assim/ops/pallas/letkf.py:
// letkf_window_analysis_fused (kernels _letkf_window_dma_kernel and
// _letkf_window_kernel, shared core _window1d_core and _cheb_solve_apply).
// The plain PyTorch twin is tpu_assim_torch/ops/cuda/letkf.py:
// window_analysis_plain.
//
// What bounds it on an H100: latency and instruction issue, not bytes. At
// the benchmark shape (ens 40, grid 10^4, obs 10^3, window 12, degree 12)
// the kernel reads about 1.7 MB (the state perturbations and mean, and the
// observation arrays, which stay in L2) and writes 1.6 MB, for about
// 0.2 GFLOP of work: at 3.35 TB/s and 67 TFLOP/s f32 that is ~1 us and
// ~3 us, far below what a column's chain of dependent steps takes. The
// design therefore keeps each column's whole solve on chip and in one warp:
// one warp per grid column, with the window, the Gram matrix S and the
// Clenshaw vectors in the warp's slice of shared memory, lanes spread over
// ensemble members for the gather and the weight application, over the
// entries of S, and over the (operand, slot) rows of the Clenshaw
// matvecs. Columns are independent, so warps never synchronize with each
// other.
//
// Left behind from the TPU kernel, as workarounds of the TPU's compiler and
// matrix unit: the one-hot selection matmul with its 3-limb bf16 split, the
// per-tile observation blocks (DMA and gather modes, with their "bad tile"
// guard) and the 128-lane transposed tables. Here each column binary-searches
// the whole sorted coordinate array, so the window is exact by
// construction.
//
// Window semantics follow the TPU kernel: start = clip(clip(center - nb/2,
// high - nb, low), 0, o - nb) with clip(x, lo, hi) = min(max(x, lo), hi);
// with fewer observations than slots (o < nb) start is negative, and a slot
// j outside [0, o) contributes nothing, as the one-hot selection matches no
// observation there.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;  // grid columns per block
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* perts;    // [k, o] normalized obs-space perturbations
  const float* innov;    // [o] normalized innovations
  const float* obs_x;    // [o] observation coordinates, sorted ascending
  const float* grid_x;   // [g] grid coordinates
  const float* sp;       // [ns, k, g] state perturbations
  const float* mean;     // [ns, g] state mean
  const float* nodes;    // [d + 1] Chebyshev nodes on [-1, 1]
  const float* dct;      // [d + 1, d + 1] node values -> coefficients
  const int* unsorted;   // set by check_sorted_kernel
  float* out;            // [ns, k, g]
  int k, o, g, ns, nb, degree;
  float reg;             // (K - 1) / rho
  float radius;
  float sup;             // taper support in coordinate units
  float epsilon;
  int taper;             // 0 = GC(z, 1/2, c), 1 = GC(z, inf, c)
  int strict;
  int per_warp;          // floats of shared memory per warp
};

// Gaspari-Cohn polynomials with the constants of tpu_assim.ops.localization
// (Python constants rounded to f32).
__device__ __forceinline__ float gc2_f1(float z) {
  const float z2 = z * z, z3 = z2 * z, z4 = z2 * z2, z5 = z4 * z;
  return -0.25f * z5 + 0.5f * z4 + 0.625f * z3 - (5.0f / 3.0f) * z2 + 1.0f;
}
__device__ __forceinline__ float gc2_f2(float z) {
  const float z2 = z * z, z3 = z2 * z, z4 = z2 * z2, z5 = z4 * z;
  return (1.0f / 12.0f) * z5 - 0.5f * z4 + 0.625f * z3 + (5.0f / 3.0f) * z2
         - 5.0f * z + 4.0f - (2.0f / 3.0f) / z;
}
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

// Taper weight of a normalized distance, cut to 0 at or below epsilon. The
// off-branch argument is clamped so the 1/z terms stay finite.
__device__ __forceinline__ float taper_weight(float z, int taper, float eps) {
  float w;
  if (taper == 0) {
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
  return (w > eps) ? w : 0.0f;
}

// Number of sorted coordinates v with v <= key (or v < key).
__device__ int count_below(const float* x, int n, float key, bool inclusive) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float v = x[mid];
    if (inclusive ? (v <= key) : (v < key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Unsorted coordinates (or NaN) poison the whole output, as the TPU
// wrapper's sortedness guard does.
__global__ void check_sorted_kernel(const float* __restrict__ x, int n,
                                    int* __restrict__ unsorted) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i + 1 < n && !(x[i + 1] >= x[i])) *unsorted = 1;
}

__global__ void __launch_bounds__(kWarps * 32)
window1d_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kWarps + warp;
  if (col >= p.g) return;  // whole warps leave; nothing below syncs blocks

  const int k = p.k, o = p.o, nb = p.nb, ns = p.ns, dp1 = p.degree + 1;
  const int n_ops = 1 + ns;          // Clenshaw operands: yh, then u_i
  const int n_ent = n_ops * nb;

  // this warp's slice of shared memory
  float* zh = smem + static_cast<size_t>(warp) * p.per_warp;  // [nb][k]
  float* s_mat = zh + nb * k;        // [nb][nb]
  float* spc = s_mat + nb * nb;      // [ns][k] this column's perturbations
  float* w_all = spc + ns * k;       // [n_ops][nb] yh, u_1..u_ns
  float* b0 = w_all + n_ent;         // three Clenshaw buffers
  float* b1 = b0 + n_ent;
  float* b2 = b1 + n_ent;
  float* c1 = b2 + n_ent;            // [d + 1] coefficients of 1/x
  float* c2 = c1 + dp1;              // [d + 1] of 1/(sqrt(x)(1 + sqrt(x)))
  float* f1x = c2 + dp1;             // [d + 1] node values
  float* f2x = f1x + dp1;
  float* sw = f2x + dp1;             // [nb] sqrt taper weights

  const float gx = p.grid_x[col];

  // 1. window start from three ranks over the whole sorted obs_x
  int rank = 0;
  if (lane == 0) rank = count_below(p.obs_x, o, gx, true);
  if (lane == 1) rank = count_below(p.obs_x, o, gx - p.sup, true);
  if (lane == 2) rank = count_below(p.obs_x, o, gx + p.sup, false);
  const int center = __shfl_sync(kFull, rank, 0);
  const int low = __shfl_sync(kFull, rank, 1);
  const int high = __shfl_sync(kFull, rank, 2);
  int start = min(max(center - nb / 2, high - nb), low);
  start = min(max(start, 0), o - nb);
  // strict guard: more in-support observations than slots poisons the column
  const float poison_y =
      (p.strict && o > nb && high - low > nb) ? nanf("") : 0.0f;
  const float poison_m = (*p.unsorted) ? nanf("") : 0.0f;

  // 2-3. gather the window, taper, sqrt-weight scaling
  for (int j = lane; j < nb; j += 32) {
    const int idx = start + j;
    float w = 0.0f, y = 0.0f;
    if (idx >= 0 && idx < o) {
      w = taper_weight(fabsf(p.obs_x[idx] - gx) / p.radius, p.taper,
                       p.epsilon);
      y = p.innov[idx];
    }
    const float s = sqrtf(w);
    sw[j] = s;
    w_all[j] = y * s + poison_y;
  }
  __syncwarp();
  for (int f = lane; f < k * nb; f += 32) {
    const int kk = f / nb, j = f - kk * nb;  // consecutive lanes, consecutive obs
    const int idx = start + j;
    const float v = (idx >= 0 && idx < o)
                        ? p.perts[static_cast<size_t>(kk) * o + idx] : 0.0f;
    zh[j * k + kk] = v * sw[j];
  }
  for (int f = lane; f < ns * k; f += 32)
    spc[f] = p.sp[static_cast<size_t>(f) * p.g + col];
  __syncwarp();

  // 4. Gram matrix S = zh zh^T and u_i = zh sp_i
  for (int e = lane; e < nb * nb; e += 32) {
    const int n = e / nb, m = e - n * nb;
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk) acc += zh[n * k + kk] * zh[m * k + kk];
    s_mat[e] = acc;
  }
  for (int e = lane; e < ns * nb; e += 32) {
    const int i = e / nb, n = e - i * nb;
    float acc = 0.0f;
    for (int kk = 0; kk < k; ++kk) acc += zh[n * k + kk] * spc[i * k + kk];
    w_all[nb + e] = acc;
  }
  for (int e = lane; e < n_ent; e += 32) {
    b1[e] = 0.0f;
    b2[e] = 0.0f;
  }
  __syncwarp();

  // spectral upper bound of X = I + S/reg: 1 + min(||S||_inf, tr S)/reg,
  // floored at 1.05
  float row_max = 0.0f, diag = 0.0f;
  for (int n = lane; n < nb; n += 32) {
    float r = 0.0f;
    for (int m = 0; m < nb; ++m) r += fabsf(s_mat[n * nb + m]);
    row_max = fmaxf(row_max, r);
    diag += s_mat[n * nb + n];
  }
  const float inf_norm = warp_max(row_max);
  const float trace = warp_sum(diag);
  const float lam_ub = fmaxf(1.0f + fminf(inf_norm, trace) / p.reg, 1.05f);

  // 5. Chebyshev coefficients on [1, lam_ub] from the mapped nodes
  const float half_w = 0.5f * (lam_ub - 1.0f);
  for (int j = lane; j < dp1; j += 32) {
    const float x = (1.0f + half_w) + half_w * p.nodes[j];
    const float sq = sqrtf(x);
    f1x[j] = 1.0f / x;
    f2x[j] = 1.0f / (sq * (1.0f + sq));
  }
  __syncwarp();
  for (int m = lane; m < dp1; m += 32) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int j = 0; j < dp1; ++j) {
      const float d = p.dct[m * dp1 + j];
      a1 += d * f1x[j];
      a2 += d * f2x[j];
    }
    c1[m] = a1;
    c2[m] = a2;
  }
  __syncwarp();

  // 6. one joint Clenshaw recurrence over [yh; u_1..u_ns] with the
  // normalized operator Xt v = (2/(lam_ub - 1)/reg) S v - v
  const float a2_sc = 2.0f / (lam_ub - 1.0f) / p.reg;
  for (int mi = p.degree; mi >= 1; --mi) {
    for (int e = lane; e < n_ent; e += 32) {
      const int op = e / nb, n = e - op * nb;
      const float* v = b1 + op * nb;
      float sv = 0.0f;
      for (int m = 0; m < nb; ++m) sv += s_mat[n * nb + m] * v[m];
      const float c = (op == 0) ? c1[mi] : c2[mi];
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
    for (int m = 0; m < nb; ++m) sv += s_mat[n * nb + m] * v[m];
    const float c = (op == 0) ? c1[0] : c2[0];
    res[e] = c * w_all[e] + (a2_sc * sv - b1[e]) - b2[e];
  }
  __syncwarp();

  // 7. mean + <u_i, q>/reg + alpha sp_i - (alpha/reg) zh^T v_i
  const float alpha = sqrtf((static_cast<float>(k) - 1.0f) / p.reg);
  const float alpha_reg = alpha / p.reg;
  for (int f = lane; f < ns * k; f += 32) {
    const int i = f / k, kk = f - i * k;
    const float* u = w_all + nb * (1 + i);
    const float* v = res + nb * (1 + i);
    float uq = 0.0f, zv = 0.0f;
    for (int n = 0; n < nb; ++n) {
      uq += u[n] * res[n];
      zv += zh[n * k + kk] * v[n];
    }
    const float m = p.mean[static_cast<size_t>(i) * p.g + col] + poison_m;
    p.out[static_cast<size_t>(f) * p.g + col] =
        m + uq / p.reg + alpha * spc[f] - alpha_reg * zv;
  }
}

}  // namespace

extern "C" {

// Floats of shared memory one column's warp uses.
int window1d_floats_per_warp(int k, int nb, int ns, int degree) {
  const int n_ent = (1 + ns) * nb;
  const int floats = nb * k + nb * nb + ns * k + 4 * n_ent
                     + 4 * (degree + 1) + nb;
  return (floats + 3) & ~3;
}

size_t window1d_smem_bytes(int k, int nb, int ns, int degree) {
  return static_cast<size_t>(kWarps) *
         window1d_floats_per_warp(k, nb, ns, degree) * sizeof(float);
}

// The analysis of every grid column; all pointers are device memory,
// unsorted_flag one int of scratch. Returns the cudaError_t of the launches
// (0 on success).
int window1d_launch(const float* perts, const float* innov, const float* obs_x,
                    const float* grid_x, const float* sp, const float* mean,
                    const float* nodes, const float* dct, int* unsorted_flag,
                    float* out, int k, int o, int g, int ns, int nb,
                    int degree, float reg, float radius, float sup,
                    float epsilon, int taper, int strict, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(unsorted_flag, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (o > 1) {
    const int threads = 256;
    check_sorted_kernel<<<(o - 1 + threads - 1) / threads, threads, 0, st>>>(
        obs_x, o, unsorted_flag);
  }
  if (g <= 0) return static_cast<int>(cudaGetLastError());
  Params p{perts, innov, obs_x, grid_x, sp, mean, nodes, dct, unsorted_flag,
           out, k, o, g, ns, nb, degree, reg, radius, sup, epsilon, taper,
           strict, window1d_floats_per_warp(k, nb, ns, degree)};
  const size_t smem = window1d_smem_bytes(k, nb, ns, degree);
  err = cudaFuncSetAttribute(window1d_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (g + kWarps - 1) / kWarps;
  window1d_kernel<<<blocks, kWarps * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* window1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
