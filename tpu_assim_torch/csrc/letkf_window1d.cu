// The whole 1-D window LETKF analysis in one kernel: window selection over
// sorted observation coordinates, Gaspari-Cohn taper, gather, and the
// Chebyshev/Clenshaw solve and weight application, per grid column.
//
// Replaces the TPU kernel tpu_assim/ops/pallas/letkf.py:
// letkf_window_analysis_fused (kernels _letkf_window_dma_kernel and
// _letkf_window_kernel, shared core _window1d_core and _cheb_solve_apply).
// The plain PyTorch twin is tpu_assim_torch/ops/cuda/letkf.py:
// window_analysis_plain. The taper is taper.cuh, shared with the 2-D
// window kernel letkf_window2d.cu.
//
// What bounds it on an H100: instruction issue and latency, not bytes. At
// the benchmark shape (ens 40, grid 10^4, obs 10^3, window 12, degree 12)
// the kernel reads about 1.7 MB (the state perturbations and mean, and the
// observation arrays, which stay in L2) and writes 1.6 MB, for about
// 0.2 GFLOP of work: at 3.35 TB/s and 67 TFLOP/s f32 that is ~1 us and
// ~3 us, far below what a column's chain of dependent steps takes. Each
// column's whole solve stays on chip.
//
// Two routes, by nb (the launcher picks; ops/cuda/letkf.py:window1d_plan
// holds the same arithmetic):
//  - the register route, nb <= 64 (cheb_pack.cuh): NBC = nb rounded up to
//    4 is a template argument; S lives in registers, the window's
//    perturbations transposed in shared memory for 16-byte broadcasts, and
//    windows of up to 16 are packed several columns to a warp (4 at the
//    benchmark's exact window 8, 2 at 12), each column on its own lanes. A
//    block of up to 8 warps takes consecutive columns: its threads copy the
//    columns' state perturbations and means in by asynchronous copies
//    (cp.async, all in flight at once), and the analyses out, each warp
//    instruction covering whole 32-byte sectors of several rows, where a
//    warp reading its own column touched one sector per float. Meanwhile
//    each column's lanes find its window and gather it (consecutive lanes,
//    consecutive observations, 8 members' loads in flight at a time); then
//    the solve. At the benchmark's shapes the grid's warps fit the card at
//    once (5 blocks of 8 warps an SM at nb 12: 48 registers and 5.5 KB of
//    shared memory a warp), so no second wave trails the first.
//  - the shared route, nb > 64 (cheb_core.cuh): one warp a column, S and
//    the Clenshaw vectors in the warp's slice of shared memory.
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
#include "cheb_pack.cuh"
#include "taper.cuh"

namespace {

constexpr int kMaxWarps = 8;  // warps a block, both routes
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
// wrapper's sortedness guard does. One block writes the flag, 0 or 1, so no
// reset launch goes before it.
constexpr int kCheckThreads = 1024;

__global__ void __launch_bounds__(kCheckThreads)
check_sorted_kernel(const float* __restrict__ x, int n,
                    int* __restrict__ unsorted) {
  int bad = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i + 1 < n; i += kCheckThreads)
    bad |= !(x[i + 1] >= x[i]);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) *unsorted = bad;
}

// A column's window: its first observation and the strict guard's poison
// (NaN when more in-support observations than slots), from three ranks over
// the whole sorted obs_x that lanes base, base + 1 and base + 2 search.
struct Window {
  int start;
  float poison_y;
};

__device__ __forceinline__ Window find_window(const Params& p, float gx,
                                              bool in_grid, int r, int base) {
  const int o = p.o, nb = p.nb;
  int rank = 0;
  if (in_grid) {
    if (r == 0) rank = count_below(p.obs_x, o, gx, true);
    if (r == 1) rank = count_below(p.obs_x, o, gx - p.sup, true);
    if (r == 2) rank = count_below(p.obs_x, o, gx + p.sup, false);
  }
  const int center = __shfl_sync(kFull, rank, base);
  const int low = __shfl_sync(kFull, rank, base + 1);
  const int high = __shfl_sync(kFull, rank, base + 2);
  int start = min(max(center - nb / 2, high - nb), low);
  Window win;
  win.start = min(max(start, 0), o - nb);
  win.poison_y = (p.strict && o > nb && high - low > nb) ? nanf("") : 0.0f;
  return win;
}

// The register route: NBC = nb rounded up to 4, S in registers, columns
// packed 32 / lanes_per_col(NBC) a warp. Up to NBC 16 the grid's warps
// outnumber what an SM holds, so the kernel is built for 5 blocks an SM
// (40 warps, the most the shared memory of NBC 12 allows).
template <int NBC>
__global__ void __launch_bounds__(kMaxWarps * 32, NBC <= 16 ? 5 : 1)
window1d_reg_kernel(const Params p) {
  constexpr int P = cheb_pack::cols_per_warp(NBC);
  constexpr int L = cheb_pack::lanes_per_col(NBC);
  constexpr int W = P * NBC;
  constexpr int R = NBC > 32 ? 2 : 1;  // window slots a lane: r, r + 32
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / L, r = lane % L;
  const int cols = (blockDim.x >> 5) * P;  // columns of the block
  const int col0 = blockIdx.x * cols;
  const int col = col0 + warp * P + slot;
  const bool in_grid = col < p.g;  // past g: zeros in, nothing out
  const int k = p.k, o = p.o, g = p.g, nb = p.nb, ns = p.ns;
  const int degree = p.degree;
  const int own = cheb_pack::col_block(k, NBC, ns, degree, 0);
  const int pc = cheb_pack::col_floats(k, NBC, ns, degree);

  // the block's state perturbations and means into each column's own
  // block by asynchronous copies, consecutive threads on consecutive
  // columns of a row (each thread keeps one column)
  const int c_t = threadIdx.x % cols, gc_t = col0 + c_t;
  float* own_t = smem + static_cast<size_t>(c_t / P) * p.per_warp + own
                 + (c_t % P) * pc;
  const int stride = blockDim.x / cols;
  for (int f = threadIdx.x / cols; f < ns * (k + 1); f += stride) {
    const float* src = (f < ns * k)
                           ? p.sp + static_cast<size_t>(f) * g
                           : p.mean + static_cast<size_t>(f - ns * k) * g;
    cheb_pack::copy_async(own_t + f, gc_t < g ? src + gc_t : src, gc_t < g);
  }
  __pipeline_commit();

  // meanwhile each column's window, taper and gather: lane r takes slots r
  // (and r + 32); pad slots and columns past g are zero
  const cheb_pack::Col ws = cheb_pack::carve<NBC>(
      smem + static_cast<size_t>(warp) * p.per_warp, slot, k, ns, degree);
  const float gx = in_grid ? p.grid_x[col] : 0.0f;
  const Window win = find_window(p, gx, in_grid, r, slot * L);
  int idx[R];
  float sw[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int j = r + 32 * q;
    idx[q] = -1;
    sw[q] = 0.0f;
    float y = 0.0f;
    if (in_grid && j < nb) {
      const int i = win.start + j;
      if (i >= 0 && i < o) {
        idx[q] = i;
        sw[q] = sqrtf(taper::weight(fabsf(p.obs_x[i] - gx) / p.radius,
                                    p.taper, p.epsilon));
        y = p.innov[i];
      }
    }
    if (j < NBC) ws.w_all[j] = (in_grid && j < nb) ? y * sw[q] + win.poison_y
                                                   : 0.0f;
  }
  // the window's perturbations, kBatch members' loads in flight at a time,
  // scaled by the sqrt weights
  constexpr int kBatch = 8;
  const float* src[R];
#pragma unroll
  for (int q = 0; q < R; ++q) src[q] = p.perts + max(idx[q], 0);
#pragma unroll 1
  for (int kk0 = 0; kk0 < k; kk0 += kBatch) {
    float v[kBatch][R];
#pragma unroll
    for (int t = 0; t < kBatch; ++t)
#pragma unroll
      for (int q = 0; q < R; ++q)
        v[t][q] = (idx[q] >= 0 && kk0 + t < k)
                      ? __ldg(src[q] + static_cast<size_t>(t) * o) : 0.0f;
#pragma unroll
    for (int t = 0; t < kBatch; ++t)
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (r + 32 * q < NBC && kk0 + t < k)
          ws.zt[(kk0 + t) * W + r + 32 * q] = v[t][q] * sw[q];
#pragma unroll
    for (int q = 0; q < R; ++q) src[q] += static_cast<size_t>(kBatch) * o;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (*p.unsorted)  // unsorted coordinates poison every mean
    for (int i = r; i < ns; i += L) ws.meanc[i] += nanf("");

  // Gram matrix, spectral bound, Chebyshev coefficients, the joint
  // Clenshaw recurrence and the weight application, into the column's spc
  cheb_pack::solve_apply<NBC>(ws, p.nodes, p.dct, k, nb, ns, degree, p.reg,
                              r);
  __syncthreads();

  if (gc_t < g)
    for (int f = threadIdx.x / cols; f < ns * k; f += stride)
      p.out[static_cast<size_t>(f) * g + gc_t] = own_t[f];
}

// The shared route: one warp a column, the workspace of cheb_core.cuh.
__global__ void __launch_bounds__(kMaxWarps * 32)
window1d_smem_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * (blockDim.x >> 5) + warp;
  if (col >= p.g) return;  // whole warps leave; nothing below syncs blocks

  const int k = p.k, o = p.o, nb = p.nb, ns = p.ns;

  // this warp's slice of shared memory: the solve's workspace, then the
  // sqrt taper weights [nb]
  float* base = smem + static_cast<size_t>(warp) * p.per_warp;
  const cheb::Workspace ws = cheb::carve(base, k, nb, ns, p.degree);
  float* sw = base + cheb::workspace_floats(k, nb, ns, p.degree);

  const float gx = p.grid_x[col];
  const Window win = find_window(p, gx, true, lane, 0);
  const int start = win.start;
  const float poison_m = (*p.unsorted) ? nanf("") : 0.0f;

  // gather the window, taper, sqrt-weight scaling
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
    ws.w_all[j] = y * s + win.poison_y;
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

  cheb::solve_apply(ws, p.nodes, p.dct, k, nb, ns, p.degree, p.reg, lane);
  for (int f = lane; f < ns * k; f += 32)
    p.out[static_cast<size_t>(f) * p.g + col] = ws.spc[f];
}

// Floats of shared memory one warp uses on the route of nb.
int floats_per_warp(int k, int nb, int ns, int degree) {
  if (nb <= cheb_pack::kMaxNb)
    return cheb_pack::warp_floats(k, cheb_pack::padded_nb(nb), ns, degree);
  // the solve's workspace and the sqrt taper weights [nb]
  return (cheb::workspace_floats(k, nb, ns, degree) + nb + 3) & ~3;
}

using Kernel = void (*)(const Params);

// A launch; above the default 48 KB of dynamic shared memory the kernel's
// limit is raised first.
cudaError_t launch(Kernel kernel, const Params& p, int warps, int blocks,
                   size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, warps * 32, smem, st>>>(p);
  return cudaGetLastError();
}

// The register kernel of NBC = nbc (4, 8, .., 64).
template <int NBC>
cudaError_t launch_reg(int nbc, const Params& p, int warps, int blocks,
                       size_t smem, cudaStream_t st) {
  if (nbc == NBC) return launch(window1d_reg_kernel<NBC>, p, warps, blocks, smem, st);
  if constexpr (NBC < cheb_pack::kMaxNb) {
    return launch_reg<NBC + 4>(nbc, p, warps, blocks, smem, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Grid columns one warp takes: 32 / lanes_per_col(NBC) on the register
// route (8, 4, 2 up to NBC 4, 8, 16), else 1.
int window1d_cols_per_warp(int nb) {
  return nb <= cheb_pack::kMaxNb
             ? cheb_pack::cols_per_warp(cheb_pack::padded_nb(nb)) : 1;
}

// Bytes of shared memory of a block of `warps` warps.
size_t window1d_smem_bytes(int k, int nb, int ns, int degree, int warps) {
  return static_cast<size_t>(warps) * floats_per_warp(k, nb, ns, degree) *
         sizeof(float);
}

// The analysis of every grid column in `blocks` blocks of `warps` warps
// (ops/cuda/letkf.py:window1d_plan); all pointers are device memory,
// unsorted_flag one int of scratch (no reset needed). Returns the
// cudaError_t of the launches (0 on success).
int window1d_launch(const float* perts, const float* innov, const float* obs_x,
                    const float* grid_x, const float* sp, const float* mean,
                    const float* nodes, const float* dct, int* unsorted_flag,
                    float* out, int k, int o, int g, int ns, int nb,
                    int degree, float reg, float radius, float sup,
                    float epsilon, int taper, int strict, int warps,
                    int blocks, void* stream) {
  if (nb < 1 || warps < 1 || warps > kMaxWarps
      || static_cast<long long>(blocks) * warps * window1d_cols_per_warp(nb)
             < g)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  check_sorted_kernel<<<1, kCheckThreads, 0, st>>>(obs_x, o, unsorted_flag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g <= 0) return static_cast<int>(err);
  const Params p{perts, innov, obs_x, grid_x, sp, mean, nodes, dct,
                 unsorted_flag, out, k, o, g, ns, nb, degree, reg, radius,
                 sup, epsilon, taper, strict,
                 floats_per_warp(k, nb, ns, degree)};
  const size_t smem = window1d_smem_bytes(k, nb, ns, degree, warps);
  err = nb <= cheb_pack::kMaxNb
            ? launch_reg<4>(cheb_pack::padded_nb(nb), p, warps, blocks, smem,
                            st)
            : launch(window1d_smem_kernel, p, warps, blocks, smem, st);
  return static_cast<int>(err);
}

const char* window1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
