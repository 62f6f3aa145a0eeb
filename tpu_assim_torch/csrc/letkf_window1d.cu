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
// the headline shape (ens 40, grid 10^4, obs 10^3, window 12, degree 12)
// the kernel reads about 1.7 MB and writes 1.6 MB for about 0.2 GFLOP: at
// 3.35 TB/s and 67 TFLOP/s f32 that is ~1 us and ~3 us, far below what a
// column's chain of dependent steps takes. At 100 members (bench.py config
// 5: 2^20 columns, 2^16 observations, window 8, degree 16) the work is 1.9
// GFLOP against 0.87 GB: 0.283 ms of operations, 0.261 ms of bytes. There
// a per-column copy of each window (k x nb floats of shared memory a
// column) made a block of 8 warps 136 KB, so an SM held one block: nothing
// hid the latency of each column's k x nb gathers from L2, its serial Gram
// loop over k and its three binary searches, and K1 took 6.4 ms. Each
// column's whole solve stays on chip.
//
// Three routes (the launcher picks; ops/cuda/letkf.py:window1d_plan holds
// the same arithmetic):
//  - the union route, nb <= 32: NBC = nb rounded up to 4 is a template
//    argument; S lives in registers, and windows of up to 16 are packed
//    several columns to a warp (4 at the benchmark's exact window 8, 2 at
//    12), each column on its own lanes. A block of up to 8 warps takes
//    consecutive columns, so their windows overlap (32 columns reach 10-11
//    observations at config 5, which stages 16). Its threads copy the
//    columns' state perturbations and means in by asynchronous copies
//    (cp.async, all in flight at once), and the analyses out, each warp
//    instruction covering whole 32-byte sectors of several rows.
//    Meanwhile each column's lanes find its window; the block stages the
//    union of its windows once, raw, and computes its Gram matrix once;
//    each column's S is its block of that matrix scaled by its sqrt taper
//    weights, and u and the apply read the staged union. A block of 8
//    warps is 42.8 KB at config 5, so an SM holds 5 (40 warps) where a
//    per-column copy of each window held 1, and K1 takes 1.8-1.9 ms, 6.7x
//    its bound (4 blocks at windows 9-16, which spill within 48
//    registers). A block whose windows spread beyond its staged slots (an
//    unsorted grid, more observations than columns) reads each column's
//    window from global memory instead, a choice made per block from the
//    windows it finds. Flag[1] counts the blocks that staged.
//  - the register route, nb 33..64 (cheb_pack.cuh): one column a warp, its
//    window's perturbations tapered and transposed in shared memory, S in
//    registers (two rows a lane). Windows of up to 32 take it nowhere.
//  - the shared route, nb > 64, or nb <= 32 where a union block does not
//    fit (k above about 1300) (cheb_core.cuh): one warp a column, S and
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

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "cheb_core.cuh"
#include "cheb_pack.cuh"
#include "taper.cuh"

namespace {

constexpr int kMaxWarps = 8;  // warps a block, every route
constexpr int kMaxUnionNb = 32;  // largest window of the union route
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
  int* union_blocks;     // blocks on the union route (zeroed by it too)
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
// wrapper's sortedness guard does. One block writes the flag, 0 or 1, and
// zeroes the count of blocks on the union route after it (flag[1]), so no
// reset launch goes before them.
constexpr int kCheckThreads = 1024;

__global__ void __launch_bounds__(kCheckThreads)
check_sorted_kernel(const float* __restrict__ x, int n,
                    int* __restrict__ flag) {
  int bad = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i + 1 < n; i += kCheckThreads)
    bad |= !(x[i + 1] >= x[i]);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    flag[0] = bad;
    flag[1] = 0;
  }
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

// The register route, windows of 33 to 64: NBC = nb rounded up to 4, S in
// registers, one column a warp, two rows of S a lane.
template <int NBC>
__global__ void __launch_bounds__(kMaxWarps * 32)
window1d_reg_kernel(const Params p) {
  static_assert(NBC > kMaxUnionNb, "smaller windows take the union route");
  constexpr int P = cheb_pack::cols_per_warp(NBC);
  constexpr int L = cheb_pack::lanes_per_col(NBC);
  constexpr int W = P * NBC;
  constexpr int R = cheb_pack::lane_rows(NBC);  // slots a lane: r, r + 32
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

// The union route: the register route's packing and solve, with the
// window perturbations shared by the block. Up to NBC 32 (one row of S a
// lane). A block's columns are consecutive, so their windows overlap: the
// block stages the union of its windows, perts[:, lo : lo + U) with U =
// union_slots(NBC), raw (untapered) and once, and computes its Gram matrix
// G = P_u^T P_u once; a column's S is then sw_i sw_m G[off + i][off + m]
// (off = its start - lo), and u_i and the apply read the staged columns,
// the sqrt weights folded in at use. A block whose windows spread beyond U
// (an unsorted grid, more observations than columns, many tied
// coordinates) takes each column's window from global memory instead, a
// member's row at a time across the column's lanes: S by the register
// route's arithmetic through shared memory, the apply by sums over the
// lanes.

// Window slots a block stages on the union route, and their row stride in
// shared memory (odd, so the lanes of a column reading rows kk, kk + 1, ..
// fall in distinct banks).
__host__ __device__ constexpr int union_slots(int nbc) { return nbc + 8; }
__host__ __device__ constexpr int union_ld(int nbc) {
  return union_slots(nbc) + 1;
}

// Floats of one warp's slice on the union route: w_all and the three
// Clenshaw buffers [1 + ns][W], the sqrt taper weights [W], then the
// columns' own blocks (no zt).
__host__ __device__ constexpr int union_warp_floats(int k, int nbc, int ns,
                                                    int degree) {
  return cheb_pack::cols_per_warp(nbc)
         * (nbc * (4 * (1 + ns) + 1)
            + cheb_pack::col_floats(k, nbc, ns, degree));
}

// Floats of the block's shared part: the staged union [k][union_ld], its
// Gram matrix [U][union_ld] and the warps' window bounds (2 * kMaxWarps
// ints).
__host__ __device__ constexpr int union_block_floats(int k, int nbc) {
  return (k + union_slots(nbc)) * union_ld(nbc) + 2 * kMaxWarps;
}

// A column's view of its warp's slice on the union route; zt holds the
// column's sqrt taper weights [NBC] (a row of W after the Clenshaw rows).
template <int NBC>
__device__ __forceinline__ cheb_pack::Col carve_union(float* warp_base,
                                                      int slot, int k, int ns,
                                                      int degree) {
  constexpr int W = cheb_pack::cols_per_warp(NBC) * NBC;
  const int n_rows = 1 + ns, dp1 = degree + 1;
  cheb_pack::Col w;
  w.w_all = warp_base + slot * NBC;
  w.b0 = w.w_all + n_rows * W;
  w.b1 = w.b0 + n_rows * W;
  w.b2 = w.b1 + n_rows * W;
  w.zt = w.b2 + n_rows * W;
  w.spc = warp_base + (4 * n_rows + 1) * W
          + slot * cheb_pack::col_floats(k, NBC, ns, degree);
  w.meanc = w.spc + ns * k;
  w.c1 = w.meanc + ns;
  w.c2 = w.c1 + dp1;
  w.f1x = w.c2 + dp1;
  w.f2x = w.f1x + dp1;
  return w;
}

// u_i = zh sp_i for the column's row r < nb, from its raw perturbations
// z(kk, r), four partial sums, times the row's sqrt weight; into rows 1..
// of w_all. Rows nb.. are zero.
template <int NBC, class Z>
__device__ __forceinline__ void union_u(const cheb_pack::Col& w, const Z& z,
                                        float sw, int k, int nb, int ns,
                                        int r) {
  constexpr int W = cheb_pack::cols_per_warp(NBC) * NBC;
  if (r >= NBC) return;
#pragma unroll 1
  for (int i = 0; i < ns; ++i) {
    float u = 0.0f;
    if (r < nb) {
      const float* sp = w.spc + i * k;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int kk = 0;
#pragma unroll 1
      for (; kk + 4 <= k; kk += 4) {
        a0 = fmaf(z(kk, r), sp[kk], a0);
        a1 = fmaf(z(kk + 1, r), sp[kk + 1], a1);
        a2 = fmaf(z(kk + 2, r), sp[kk + 2], a2);
        a3 = fmaf(z(kk + 3, r), sp[kk + 3], a3);
      }
      for (; kk < k; ++kk) a0 = fmaf(z(kk, r), sp[kk], a0);
      u = sw * ((a0 + a1) + (a2 + a3));
    }
    w.w_all[(1 + i) * W + r] = u;
  }
}

// spc_i <- mean_i + alpha sp_i - (alpha/reg) z^T v'_i, with v'_i (the
// sqrt weights folded into v_i) in rows 1.. of res, z the column's window
// in the staged union (row stride ULD) and slots nb.. read as zero; each
// lane writes only its own entries.
template <int NBC, int ULD>
__device__ __forceinline__ void union_apply(const cheb_pack::Col& w,
                                            const float* res, const float* z,
                                            int k, int nb, int ns, float reg,
                                            int r) {
  constexpr int L = cheb_pack::lanes_per_col(NBC);
  constexpr int W = cheb_pack::cols_per_warp(NBC) * NBC;
  const float alpha = sqrtf((static_cast<float>(k) - 1.0f) / reg);
  const float alpha_reg = alpha / reg;
#pragma unroll 1
  for (int f = r; f < ns * k; f += L) {
    const int i = f / k, kk = f - i * k;
    const float* v = res + (1 + i) * W;
    const float* zk = z + kk * ULD;
    float zv = 0.0f;
#pragma unroll
    for (int n = 0; n < NBC; n += 4) {
      const float4 vn = cheb_pack::ld4(v + n);
      zv = fmaf(n < nb ? zk[n] : 0.0f, vn.x, zv);
      zv = fmaf(n + 1 < nb ? zk[n + 1] : 0.0f, vn.y, zv);
      zv = fmaf(n + 2 < nb ? zk[n + 2] : 0.0f, vn.z, zv);
      zv = fmaf(n + 3 < nb ? zk[n + 3] : 0.0f, vn.w, zv);
    }
    w.spc[f] = w.meanc[i] + alpha * w.spc[f] - alpha_reg * zv;
  }
  __syncwarp();
}

// The same apply from global memory, for a block whose windows spread
// beyond its staged slots: member kk's window row is read by the column's
// lanes, slot r by lane r (consecutive observations, one sector a column;
// kBatch members' loads in flight), z(kk, r) v'_i[r] summed over them, and
// lane kk mod L writes the entry. The window starts at observation
// `start`; slots outside [0, o) and from nb on read as zero.
template <int NBC>
__device__ __forceinline__ void global_apply(const cheb_pack::Col& w,
                                             const float* res,
                                             const float* perts, int start,
                                             int o, int k, int nb, int ns,
                                             float reg, int r) {
  constexpr int L = cheb_pack::lanes_per_col(NBC);
  constexpr int W = cheb_pack::cols_per_warp(NBC) * NBC;
  constexpr int kBatch = 8;
  const float alpha = sqrtf((static_cast<float>(k) - 1.0f) / reg);
  const float alpha_reg = alpha / reg;
  const int j = start + r;
  const bool ok = r < nb && j >= 0 && j < o;
  const float* const src = perts + max(j, 0);
#pragma unroll 1
  for (int i = 0; i < ns; ++i) {
    const float vr = r < NBC ? res[(1 + i) * W + r] : 0.0f;
    float* const spc = w.spc + i * k;
#pragma unroll 1
    for (int kk0 = 0; kk0 < k; kk0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        v[t] = (ok && kk0 + t < k)
                   ? __ldg(src + static_cast<size_t>(kk0 + t) * o) : 0.0f;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const float zv = cheb_pack::col_sum<L>(v[t] * vr);
        const int kk = kk0 + t;
        if (kk < k && kk % L == r)
          spc[kk] = w.meanc[i] + alpha * spc[kk] - alpha_reg * zv;
      }
    }
  }
  __syncwarp();
}

template <int NBC>
__global__ void __launch_bounds__(kMaxWarps * 32,
                                  NBC <= 8 ? 5 : NBC <= 16 ? 4 : 2)
window1d_union_kernel(const Params p) {
  static_assert(NBC <= kMaxUnionNb, "one row of S a lane");
  constexpr int P = cheb_pack::cols_per_warp(NBC);
  constexpr int L = cheb_pack::lanes_per_col(NBC);
  constexpr int W = P * NBC;
  constexpr int U = union_slots(NBC);
  constexpr int ULD = union_ld(NBC);
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int slot = lane / L, r = lane % L, base = slot * L;
  const int cols = warps * P;  // columns of the block
  const int col0 = blockIdx.x * cols;
  const int col = col0 + warp * P + slot;
  const bool in_grid = col < p.g;  // past g: zeros in, nothing out
  const int k = p.k, o = p.o, g = p.g, nb = p.nb, ns = p.ns;
  const int degree = p.degree;
  const int rows = (4 * (1 + ns) + 1) * W;  // a warp's rows
  const int pc = cheb_pack::col_floats(k, NBC, ns, degree);
  float* const pk = smem + static_cast<size_t>(warps) * p.per_warp;
  float* const gram = pk + k * ULD;
  int* const bounds = reinterpret_cast<int*>(gram + U * ULD);

  // the block's state perturbations and means into each column's own
  // block by asynchronous copies, as on the register route
  const int c_t = threadIdx.x % cols, gc_t = col0 + c_t;
  float* own_t = smem + static_cast<size_t>(c_t / P) * p.per_warp + rows
                 + (c_t % P) * pc;
  const int stride = blockDim.x / cols;
  for (int f = threadIdx.x / cols; f < ns * (k + 1); f += stride) {
    const float* src = (f < ns * k)
                           ? p.sp + static_cast<size_t>(f) * g
                           : p.mean + static_cast<size_t>(f - ns * k) * g;
    cheb_pack::copy_async(own_t + f, gc_t < g ? src + gc_t : src, gc_t < g);
  }
  __pipeline_commit();

  // meanwhile each column's window and sqrt taper weights: lane r takes
  // slot r; pad slots and columns past g are zero
  const cheb_pack::Col ws = carve_union<NBC>(
      smem + static_cast<size_t>(warp) * p.per_warp, slot, k, ns, degree);
  const float gx = in_grid ? p.grid_x[col] : 0.0f;
  const Window win = find_window(p, gx, in_grid, r, base);
  const int i_obs = win.start + r;
  const bool valid = in_grid && r < nb && i_obs >= 0 && i_obs < o;
  float sw = 0.0f, y = 0.0f;
  if (valid) {
    sw = sqrtf(taper::weight(fabsf(p.obs_x[i_obs] - gx) / p.radius, p.taper,
                             p.epsilon));
    y = p.innov[i_obs];
  }
  if (r < NBC) {
    ws.w_all[r] = (in_grid && r < nb) ? y * sw + win.poison_y : 0.0f;
    ws.zt[r] = sw;
  }

  // the block's window starts [lo, hi]: its union is [lo, hi + nb)
  int lo = __reduce_min_sync(kFull, in_grid ? win.start : INT_MAX);
  int hi = __reduce_max_sync(kFull, in_grid ? win.start : INT_MIN);
  if (lane == 0) {
    bounds[warp] = lo;
    bounds[kMaxWarps + warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < warps; ++w) {
    lo = min(lo, bounds[w]);
    hi = max(hi, bounds[kMaxWarps + w]);
  }
  // uniform across the block; a block wholly past g stages nothing useful
  const bool fits = lo > hi || hi - lo <= U - NBC;
  if (!(lo <= hi)) lo = 0;
  if (fits) {
    // the union's raw perturbations, zero outside [0, o), by asynchronous
    // copies (consecutive threads, consecutive observations)
    for (int f = threadIdx.x; f < k * U; f += blockDim.x) {
      const int kk = f / U, j = f - kk * U, i = lo + j;
      const bool ok = i >= 0 && i < o;
      cheb_pack::copy_async(pk + kk * ULD + j,
                            p.perts + static_cast<size_t>(kk) * o
                                + (ok ? i : 0),
                            ok);
    }
    __pipeline_commit();
    if (threadIdx.x == 0) atomicAdd(p.union_blocks, 1);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (*p.unsorted)  // unsorted coordinates poison every mean
    for (int i = r; i < ns; i += L) ws.meanc[i] += nanf("");

  // the column's raw window perturbations z(kk, j), j < nb: the staged
  // union's from its offset in it, or global memory's from its start
  const float* const perts = p.perts;
  const int at = fits ? (in_grid ? win.start - lo : 0) : win.start;
  const auto z_union = [=](int kk, int j) { return pk[kk * ULD + at + j]; };
  const auto z_global = [=](int kk, int j) {
    const int i = at + j;
    return (i >= 0 && i < o) ? __ldg(perts + static_cast<size_t>(kk) * o + i)
                             : 0.0f;
  };
  float s[1][NBC];
  if (fits) {
    // G = P_u^T P_u, an entry a thread, four partial sums over members;
    // G[a][b] and G[b][a] are the same sums, so S stays exactly symmetric
    for (int e = threadIdx.x; e < U * U; e += blockDim.x) {
      const int a = e / U, b = e - a * U;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int kk = 0;
#pragma unroll 1
      for (; kk + 4 <= k; kk += 4) {
        const float* x = pk + kk * ULD;
        a0 = fmaf(x[a], x[b], a0);
        a1 = fmaf(x[ULD + a], x[ULD + b], a1);
        a2 = fmaf(x[2 * ULD + a], x[2 * ULD + b], a2);
        a3 = fmaf(x[3 * ULD + a], x[3 * ULD + b], a3);
      }
      for (; kk < k; ++kk) a0 = fmaf(pk[kk * ULD + a], pk[kk * ULD + b], a0);
      gram[a * ULD + b] = (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
    // the column's S row r: sw_r sw_m G[at + r][at + m], zero beyond nb;
    // sw_m by broadcasts of the column's weights
    const float* grow = gram + (at + r) * ULD + at;
#pragma unroll
    for (int m = 0; m < NBC; m += 4) {
      const float4 swm = cheb_pack::ld4(ws.zt + m);
      const float sws[4] = {swm.x, swm.y, swm.z, swm.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float gv = 0.0f;
        if (r < nb && m + t < nb) gv = grow[m + t];
        s[0][m + t] = sw * sws[t] * gv;
      }
    }
    union_u<NBC>(ws, z_union, sw, k, nb, ns, r);
  } else {
    // the column's window from global memory: S = zh zh^T over the scaled
    // rows, a member at a time through the column's entries of w_all's row
    // 1 (u's, written after), read back as broadcasts; kBatch members'
    // loads in flight
#pragma unroll
    for (int m = 0; m < NBC; ++m) s[0][m] = 0.0f;
    constexpr int kBatch = 8;
    const float* src = perts + max(i_obs, 0);
    float* const zrow = ws.w_all + W;
#pragma unroll 1
    for (int kk0 = 0; kk0 < k; kk0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t)
        v[t] = (valid && kk0 + t < k)
                   ? __ldg(src + static_cast<size_t>(kk0 + t) * o) : 0.0f;
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const float a = v[t] * sw;
        if (r < NBC) zrow[r] = a;
        __syncwarp();
#pragma unroll
        for (int m = 0; m < NBC; m += 4) {
          const float4 z = cheb_pack::ld4(zrow + m);
          s[0][m] = fmaf(a, z.x, s[0][m]);
          s[0][m + 1] = fmaf(a, z.y, s[0][m + 1]);
          s[0][m + 2] = fmaf(a, z.z, s[0][m + 2]);
          s[0][m + 3] = fmaf(a, z.w, s[0][m + 3]);
        }
        __syncwarp();
      }
    }
    union_u<NBC>(ws, z_global, sw, k, nb, ns, r);
  }
#pragma unroll 1
  for (int e = r; e < (1 + ns) * NBC; e += L) {
    const int i = (e / NBC) * W + e % NBC;
    ws.b1[i] = 0.0f;
    ws.b2[i] = 0.0f;
  }
  __syncwarp();

  // the spectral bound, coefficients, Clenshaw recurrence and the mean
  float* res = cheb_pack::clenshaw<NBC>(ws, s, p.nodes, p.dct, nb, ns,
                                        degree, p.reg, r);
  // v'_i = sw v_i, then the apply from the raw perturbations
  if (r < NBC)
    for (int i = 0; i < ns; ++i) res[(1 + i) * W + r] *= ws.zt[r];
  __syncwarp();
  if (fits)
    union_apply<NBC, ULD>(ws, res, pk + at, k, nb, ns, p.reg, r);
  else
    global_apply<NBC>(ws, res, perts, at, o, k, nb, ns, p.reg, r);
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

// Whether nb takes a kernel of cheb_pack.cuh: the union route where
// `unite`, or the register route (windows of 33 to 64); else the shared
// route.
bool pack_route(int nb, bool unite) {
  return unite || (nb > kMaxUnionNb && nb <= cheb_pack::kMaxNb);
}

// Floats of shared memory one warp uses on the route of nb.
int floats_per_warp(int k, int nb, int ns, int degree, bool unite) {
  if (unite)
    return union_warp_floats(k, cheb_pack::padded_nb(nb), ns, degree);
  if (pack_route(nb, false))
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

// The kernel of NBC = nbc: the union kernel up to 32, the register kernel
// from 36 to 64.
template <int NBC>
cudaError_t launch_nbc(int nbc, const Params& p, int warps, int blocks,
                       size_t smem, cudaStream_t st) {
  if (nbc == NBC) {
    if constexpr (NBC <= kMaxUnionNb)
      return launch(window1d_union_kernel<NBC>, p, warps, blocks, smem, st);
    else
      return launch(window1d_reg_kernel<NBC>, p, warps, blocks, smem, st);
  }
  if constexpr (NBC < cheb_pack::kMaxNb) {
    return launch_nbc<NBC + 4>(nbc, p, warps, blocks, smem, st);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Grid columns one warp takes: 32 / lanes_per_col(NBC) on the union route
// (8, 4, 2 up to NBC 4, 8, 16; `slots` is its window1d_union_slots(nb), 0
// off it), else 1.
int window1d_cols_per_warp(int nb, int slots) {
  return pack_route(nb, slots > 0)
             ? cheb_pack::cols_per_warp(cheb_pack::padded_nb(nb)) : 1;
}

// Window slots a block stages on the union route (union_slots of nb
// rounded up to 4), or 0 where nb has no union route (above 32).
int window1d_union_slots(int nb) {
  return nb <= kMaxUnionNb ? union_slots(cheb_pack::padded_nb(nb)) : 0;
}

// Bytes of shared memory of a block of `warps` warps; `slots` is the
// union route's window1d_union_slots(nb), 0 off it.
size_t window1d_smem_bytes(int k, int nb, int ns, int degree, int warps,
                           int slots) {
  const bool unite = slots > 0;
  return (static_cast<size_t>(warps) * floats_per_warp(k, nb, ns, degree,
                                                       unite)
          + (unite ? union_block_floats(k, cheb_pack::padded_nb(nb)) : 0))
         * sizeof(float);
}

// The analysis of every grid column in `blocks` blocks of `warps` warps
// (ops/cuda/letkf.py:window1d_plan), on the union route where `slots` is
// window1d_union_slots(nb) (0: the register route for windows of 33 to
// 64, the shared route for the rest); all pointers are device memory, flag
// two ints of scratch (no reset needed): the sortedness flag, then the
// count of blocks on the union route. Returns the cudaError_t of the
// launches (0 on success).
int window1d_launch(const float* perts, const float* innov, const float* obs_x,
                    const float* grid_x, const float* sp, const float* mean,
                    const float* nodes, const float* dct, int* flag,
                    float* out, int k, int o, int g, int ns, int nb,
                    int degree, float reg, float radius, float sup,
                    float epsilon, int taper, int strict, int warps,
                    int blocks, int slots, void* stream) {
  if (nb < 1 || warps < 1 || warps > kMaxWarps
      || (slots != 0 && slots != window1d_union_slots(nb))
      || static_cast<long long>(blocks) * warps
             * window1d_cols_per_warp(nb, slots) < g)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  check_sorted_kernel<<<1, kCheckThreads, 0, st>>>(obs_x, o, flag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g <= 0) return static_cast<int>(err);
  const bool unite = slots > 0;
  const Params p{perts, innov, obs_x, grid_x, sp, mean, nodes, dct, flag,
                 flag + 1, out, k, o, g, ns, nb, degree, reg, radius, sup,
                 epsilon, taper, strict,
                 floats_per_warp(k, nb, ns, degree, unite)};
  const size_t smem = window1d_smem_bytes(k, nb, ns, degree, warps, slots);
  err = pack_route(nb, unite)
            ? launch_nbc<4>(cheb_pack::padded_nb(nb), p, warps, blocks, smem,
                            st)
            : launch(window1d_smem_kernel, p, warps, blocks, smem, st);
  return static_cast<int>(err);
}

const char* window1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
