// The whole 1-D window LETKF analysis in one kernel: window selection over
// sorted observation coordinates, Gaspari-Cohn taper, gather, and the
// Chebyshev/Clenshaw solve and weight application, per grid column.
//
// Replaces the TPU kernel tpu_assim/ops/pallas/letkf.py:
// letkf_window_analysis_fused (kernels _letkf_window_dma_kernel and
// _letkf_window_kernel, shared core _window1d_core and _cheb_solve_apply).
// The plain PyTorch twin is tpu_assim_torch/ops/cuda/letkf.py:
// window_analysis_plain. The solve and weight application (steps 4-7
// below) are cheb_core.cuh, which the neighborhood kernel
// letkf_nbh_cheb.cu shares; the taper is taper.cuh, shared with the 2-D
// window kernel letkf_window2d.cu.
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

#include "cheb_core.cuh"
#include "taper.cuh"

namespace {

constexpr int kWarps = 4;  // grid columns per block
using cheb::kFull;

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

  const int k = p.k, o = p.o, nb = p.nb, ns = p.ns;

  // this warp's slice of shared memory: the solve's workspace, then the
  // sqrt taper weights [nb]
  float* base = smem + static_cast<size_t>(warp) * p.per_warp;
  const cheb::Workspace ws = cheb::carve(base, k, nb, ns, p.degree);
  float* sw = base + cheb::workspace_floats(k, nb, ns, p.degree);

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
      w = taper::weight(fabsf(p.obs_x[idx] - gx) / p.radius, p.taper,
                        p.epsilon);
      y = p.innov[idx];
    }
    const float s = sqrtf(w);
    sw[j] = s;
    ws.w_all[j] = y * s + poison_y;
  }
  __syncwarp();
  for (int f = lane; f < k * nb; f += 32) {
    const int kk = f / nb, j = f - kk * nb;  // consecutive lanes, consecutive obs
    const int idx = start + j;
    const float v = (idx >= 0 && idx < o)
                        ? p.perts[static_cast<size_t>(kk) * o + idx] : 0.0f;
    ws.zh[j * ws.ld + kk] = v * sw[j];
  }
  for (int f = lane; f < ns * k; f += 32)
    ws.spc[f] = p.sp[static_cast<size_t>(f) * p.g + col];
  for (int i = lane; i < ns; i += 32)
    ws.meanc[i] = p.mean[static_cast<size_t>(i) * p.g + col] + poison_m;
  __syncwarp();

  // 4-7. Gram matrix, spectral bound, Chebyshev coefficients, the joint
  // Clenshaw recurrence and mean + <u_i, q>/reg + alpha sp_i - (alpha/reg)
  // zh^T v_i, into ws.spc
  cheb::solve_apply(ws, p.nodes, p.dct, k, nb, ns, p.degree, p.reg, lane);
  for (int f = lane; f < ns * k; f += 32)
    p.out[static_cast<size_t>(f) * p.g + col] = ws.spc[f];
}

}  // namespace

extern "C" {

// Floats of shared memory one column's warp uses.
int window1d_floats_per_warp(int k, int nb, int ns, int degree) {
  return (cheb::workspace_floats(k, nb, ns, degree) + nb + 3) & ~3;
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
