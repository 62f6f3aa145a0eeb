// The whole 2-D window LETKF analysis in one kernel (K6): per 128-column
// grid tile, the y-band of observations; per grid column, an x-window of nb
// observations inside the band, the product of the per-dimension
// Gaspari-Cohn tapers, and the Chebyshev/Clenshaw solve and weight
// application.
//
// Replaces the TPU kernel tpu_assim/ops/pallas/letkf.py:
// letkf_window_analysis_fused_2d (kernels _letkf_window2d_dma_kernel, the
// banded one, and _letkf_window2d_kernel, the whole-table one; core
// _window2d_core). The plain PyTorch twin is
// tpu_assim_torch/ops/cuda/letkf.py:window2d_plain. The taper is
// taper.cuh (shared with K1).
//
// Input: one y-sorted observation table [n_rows, rows], a row per
// observation slot (k perturbations, innovation, x, y, extra coordinates),
// and per tile (off, a, b): the tile reads the slots [off, off + width) and
// sees the x of slots outside [a, b) as +FLT_MAX, so that only its band's
// observations take part in the x-ranks and counts. The whole-table mode
// of the JAX package is the same kernel with (0, 0, o) for every tile.
//
// What bounds it on an H100: the per-column work, not bytes. At bench
// config 8 (2^20 columns, ens 40, degree 16) the Gram matrices, the joint
// Clenshaw recurrences over 1 + ns operands and the applies over each
// column's 3-46 observations of nonzero weight come to ~6.2e10 FLOP
// (port_bench/work/k6.py), >= ~0.92 ms at the 67 TFLOP/s f32 rate outside
// the tensor cores (~3.3e11 FLOP, ~4.9 ms, at the window of 52 for every
// column), against ~0.1 ms for the 336 MB of state the kernel reads and
// writes. Each column's chain of dependent steps runs in one warp; what
// limits the rate is how many instructions a column issues, how many warps
// an SM holds to hide the chains' latency, and the column's reads of its
// window's table rows and its state column.
//
// Two routes, both kernels, picked by the wrapper's window2d_plan
// (tpu_assim_torch/ops/cuda/letkf.py) from (k, nb, ns, degree, width, the
// tiles and the coordinates):
//  - the register route, nb <= 64 (cheb_reg.cuh): S in registers, 8 FMAs
//    per 16-byte shared load in the Gram step and the mat-vec. A column
//    is solved on its observations of nonzero weight alone: the warp
//    compacts its window's slots of nonzero weight in rank order (a ballot
//    per slot row) and solves them at their count rounded up to 8, NBCc,
//    one of 8, 16, ..., NBC (NBC = nb rounded up to 8, a template
//    argument), chosen per column. The window is taken wider than one
//    column's support (its nb x-ranks span the tile's whole y-band), so
//    most slots weigh zero: at bench config 8 (nb 52, NBC 56) a column
//    holds 3-46 observations of weight, and 99% of columns solve at 16-32.
//    A zero-weight slot adds only zeros to every sum of the solve, so the
//    result is the whole window's to the bit. The block counts the columns
//    solved at each width (the launch's `counts`). ~12.8 KB of shared
//    memory per column at NBC 56 and k 40.
//    All of a tile's columns take their windows from the same band, so
//    the block stages its slice of the table, whole rows at an odd stride
//    (stage_ld), in shared memory once where the plan finds room
//    (`staged`): copied by cp.async, all in flight while the band is
//    sorted, and read by the columns' slot weights and their kept rows'
//    perturbations, where each column would otherwise gather its window
//    from the table a lane a row (~20 cache lines a load instruction; at
//    config 8 a tile's 128 columns read 52 slot rows each of a band of
//    59-184). A staged block has 6 warps (4 at NBC 64), 2 blocks an SM; an
//    unstaged one 4 warps, 3 (2 at NBC 64) an SM: the same warps an SM by
//    registers at NBC 40-64. The launch bounds build both for 168
//    registers a lane at NBC <= 56, 255 at 64. nvcc 12.8 gives
//    (chip_smoke.py phase 1, which fails on any spill of this route): 167
//    registers at NBC 48 and 56 and 163 at 40, so 12 warps an SM (bench
//    configs 8 and 7); 126 at 32; 100-121 at 8-24 (16 warps an SM
//    unstaged, which the plan keeps there); 216 at 64 (8 warps); no
//    spills. The shared route takes 64 registers.
//  - the shared route, nb > 64 (cheb_core.cuh, the design of K1 and K4): S
//    in shared memory, one FMA per two shared loads, up to 8 warps a block
//    as shared memory allows, its rows from the table.
// Each tile's columns may be spread over `splits` blocks, each of which
// sorts the tile's band (and stages it) itself (a few microseconds against
// tens per column), so that grids of few tiles (bench config 7: 128 tiles;
// a 2-D halo tile: 16) fill the card's 132 SMs instead of leaving each
// warp 8-16 columns to walk in turn.
//
// Design against the TPU kernel: the TPU computes every slot's x-rank by an
// [o_b, o_b] comparison and selects the window by a one-hot matmul in three
// bf16 limbs. Here the block sorts its slice once by (x, slot) with a
// bitonic sort of 64-bit keys in shared memory (the slot index in the low
// half breaks ties, as the TPU's index tie-break does), and each column
// finds its window by binary search and reads its nb rows from the staged
// slice or the table directly (a row's k perturbations are contiguous in
// either). The 128-lane padded
// transposed table and the 8-aligned DMA offsets were layout needs of the
// TPU and are gone; the offsets survive only in the wrapper, where they
// decide which slots a tile sees.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "cheb_core.cuh"
#include "cheb_reg.cuh"
#include "taper.cuh"

namespace {

constexpr int kRegWarps = 4;     // warps of an unstaged register-route block
constexpr int kStagedWarps = 6;  // of a staged one below NBC 64 (4 at 64)
constexpr int kSmemWarps = 8;    // most warps of a shared-route block
// The register route's widths: 8, 16, ..., cheb_reg::kMaxNb.
constexpr int kWidths = cheb_reg::kMaxNb / 8;
using cheb::kFull;

struct Params {
  const float* table;  // [n_rows, rows] observation slots, y-sorted
  const int* bands;    // [3, n_tiles]: slice offset, band start, band end
  const float* grid;   // [n_dims, g] grid coordinates
  const float* sp;     // [ns, k, g] state perturbations
  const float* mean;   // [ns, g] state mean
  const float* scal;   // [1 + n_dims]: reg, rx, ry, extra radii
  const float* nodes;  // [d + 1] Chebyshev nodes on [-1, 1]
  const float* dct;    // [d + 1, d + 1] node values -> coefficients
  float* out;          // [ns, k, g]
  int* counts;         // [kWidths + 1] columns the register route solved
                       // at each width, then the blocks that staged their
                       // slice (zeroed before the launch)
  int k, n_dims, n_rows, g, ns, nb, degree;
  int width;           // slots per slice
  int width_pow2;      // the sort's length: width rounded up to a power of 2
  int tile;            // grid columns per tile
  int splits;          // blocks per tile
  int taper;           // 0 = GC(z, 1/2, c), 1 = GC(z, inf, c)
  int strict;
  int warps;
  int per_warp;        // floats of shared memory per warp
  float support_z;     // taper support in units of the radius
  float epsilon;
  int staged;          // 1: register-route blocks stage their slice
};

__host__ __device__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of the band's sorted x and slot indices, 16-aligned, and of the
// block's count of columns at each width (register route). The sort's
// 64-bit keys lie behind them (and behind a staged slice), in the space
// the warps' workspaces take once the band is sorted.
__host__ __device__ size_t band_bytes(int width) {
  return ((8u * width + 15) & ~static_cast<size_t>(15)) +
         sizeof(int) * kWidths;
}
__device__ int* width_counts(unsigned char* smem, int width) {
  return reinterpret_cast<int*>(smem + band_bytes(width)) - kWidths;
}
__host__ __device__ size_t key_bytes(int width) {
  return 8u * pow2_at_least(width);
}

// Row stride of a staged slice: the table's row length made odd, so that
// lanes reading one offset of different rows spread over the banks.
__host__ __device__ int stage_ld(int rows) { return rows | 1; }

// Bytes of a staged slice of `width` rows, 16-aligned (0 unstaged). It
// lies behind the band, before the keys and the warps' workspaces.
__host__ __device__ size_t stage_bytes(int width, int rows, bool staged) {
  return staged ? (4u * width * stage_ld(rows) + 15) &
                      ~static_cast<size_t>(15)
                : 0;
}

// Floats of shared memory per warp of each route.
int floats_per_warp(int route, int k, int nb, int ns, int degree) {
  // the solve's workspace at the widest width, and the kept slots' table
  // rows and sqrt weights [NBC]
  const int nbc = cheb_reg::padded_nb(nb);
  if (route == 0)
    return cheb_reg::workspace_floats(k, nbc, ns, degree) + 2 * nbc;
  // the solve's workspace, the sqrt taper weights [nb] and the table rows of
  // the window [nb]
  return (cheb::workspace_floats(k, nb, ns, degree) + 2 * nb + 3) & ~3;
}

// Order-preserving map of a float onto unsigned ints (-0 as +0, as the
// comparisons of the TPU kernel see them).
__device__ __forceinline__ uint32_t order_bits(float x) {
  if (x == 0.0f) x = 0.0f;
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Number of sorted values v with v <= key (or v < key).
__device__ int count_below(const float* x, int n, float key, bool inclusive) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float v = x[mid];
    if (inclusive ? (v <= key) : (v < key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The block's part of its tile: tile t, columns [c0, c0 + cols) of it.
struct Part {
  int t, c0, cols;
  const float* slice;  // the tile's slots, or nullptr (the tile is NaN)
  const float* xs;     // [width] the band's x in rank order
  const int* slot_of;  // [width] the slot of each rank
};

// Sorts the tile's slice by (masked x, slot) into the front of shared
// memory, and where the launch stages (kMayStage, the register route, and
// p.staged) copies the slice's rows behind the band (row stride
// stage_ld), or NaN-poisons the block's columns when the slice leaves the
// table (never reading past it).
template <bool kMayStage>
__device__ Part sort_band(const Params& p, unsigned char* smem) {
  const int n_tiles = gridDim.x / p.splits;
  Part part;
  part.t = blockIdx.x / p.splits;
  part.cols = p.tile / p.splits;
  part.c0 = (blockIdx.x - part.t * p.splits) * part.cols;
  const int k = p.k, width = p.width, rows = k + 1 + p.n_dims;
  const int off = p.bands[part.t];
  const int a = p.bands[n_tiles + part.t];
  const int b = p.bands[2 * n_tiles + part.t];
  if (off < 0 || off + width > p.n_rows) {
    for (int e = threadIdx.x; e < p.ns * k * part.cols; e += blockDim.x) {
      const int f = e / part.cols, c = e - f * part.cols;
      p.out[static_cast<size_t>(f) * p.g + part.t * p.tile + part.c0 + c] =
          nanf("");
    }
    part.slice = nullptr;
    return part;
  }
  const float* slice = p.table + static_cast<size_t>(off) * rows;
  const bool staged = kMayStage && p.staged;
  if (staged) {
    // the slice by asynchronous copies (consecutive threads, consecutive
    // floats), all in flight while the band is sorted
    float* stage = reinterpret_cast<float*>(smem + band_bytes(width));
    const int ld = stage_ld(rows);
    for (int i = threadIdx.x; i < width * rows; i += blockDim.x) {
      const int r = i / rows;
      __pipeline_memcpy_async(stage + r * ld + (i - r * rows), slice + i,
                              sizeof(float));
    }
    __pipeline_commit();
  }
  float* xs = reinterpret_cast<float*>(smem);
  int* slot_of = reinterpret_cast<int*>(xs + width);
  uint64_t* keys = reinterpret_cast<uint64_t*>(
      smem + band_bytes(width) + stage_bytes(width, rows, staged));
  const int n = p.width_pow2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint64_t key = ~0ull;
    if (i < width) {
      const float x = (i >= a && i < b)
                          ? slice[static_cast<size_t>(i) * rows + k + 1]
                          : FLT_MAX;
      key = (static_cast<uint64_t>(order_bits(x)) << 32) |
            static_cast<uint32_t>(i);
    }
    keys[i] = key;
  }
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const uint64_t x = keys[lo], y = keys[hi];
        if ((x > y) == ((lo & size) == 0)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const int s = static_cast<int>(keys[i] & 0xffffffffu);
    slot_of[i] = s;
    xs[i] = (s >= a && s < b) ? slice[static_cast<size_t>(s) * rows + k + 1]
                              : FLT_MAX;
  }
  if (staged) __pipeline_wait_prior(0);
  __syncthreads();
  part.slice = slice;
  part.xs = xs;
  part.slot_of = slot_of;
  return part;
}

// A column's window: its first rank, and the strict guard's poison (NaN
// when more band observations lie in the x-cutoff than the window holds).
struct Window {
  int start;
  float poison_y;
};

__device__ Window find_window(const Params& p, const Part& part, float gx,
                              float sup, int lane) {
  const int width = p.width, nb = p.nb;
  int r = 0;
  if (lane == 0) r = count_below(part.xs, width, gx, true);
  if (lane == 1) r = count_below(part.xs, width, gx - sup, true);
  if (lane == 2) r = count_below(part.xs, width, gx + sup, false);
  const int center = __shfl_sync(kFull, r, 0);
  const int low = __shfl_sync(kFull, r, 1);
  const int high = __shfl_sync(kFull, r, 2);
  int start = min(max(center - nb / 2, high - nb), low);
  start = min(max(start, 0), width - nb);
  Window win;
  win.start = start;
  win.poison_y =
      (p.strict && width > nb && high - low > nb) ? nanf("") : 0.0f;
  return win;
}

// Slot j of a column's window: its row of the slice (-1 outside it), its
// sqrt product-taper weight and its innovation, read from `band`, the
// slice's rows: the block's staged copy (kStaged) or the table's.
template <bool kStaged>
__device__ __forceinline__ void window_slot(const Params& p,
                                            const Part& part,
                                            const float* band, int pos,
                                            int col, float gx, float gy,
                                            int* row_out, float* sw,
                                            float* y) {
  const int k = p.k, rows = k + 1 + p.n_dims;
  const int ld = kStaged ? stage_ld(rows) : rows;
  float w = 0.0f;
  int row = -1;
  *y = 0.0f;
  if (pos >= 0 && pos < p.width) {
    row = part.slot_of[pos];
    const float* o = band + static_cast<size_t>(row) * ld;
    w = taper::weight(fabsf(part.xs[pos] - gx) / p.scal[1], p.taper, 0.0f) *
        taper::weight(fabsf(o[k + 2] - gy) / p.scal[2], p.taper, 0.0f);
    for (int e = 0; e < p.n_dims - 2; ++e)
      w = w * taper::weight(
                  fabsf(o[k + 3 + e] -
                        p.grid[static_cast<size_t>(2 + e) * p.g + col]) /
                      p.scal[3 + e],
                  p.taper, 0.0f);
    w = (w > p.epsilon) ? w : 0.0f;
    *y = o[k];
  }
  *row_out = row;
  *sw = sqrtf(w);
}

// cheb_reg::solve_apply at the width nbc, a multiple of 8 up to NBC.
template <int NBC>
__device__ __forceinline__ void solve_at(int nbc,
                                         const cheb_reg::Workspace& ws,
                                         const Params& p, int m, float reg,
                                         int lane) {
  if constexpr (NBC > 8) {
    if (nbc < NBC) {
      solve_at<NBC - 8>(nbc, ws, p, m, reg, lane);
      return;
    }
  }
  cheb_reg::solve_apply<NBC>(ws, p.nodes, p.dct, p.k, m, p.ns, p.degree, reg,
                             lane);
}

// A register-route column's window, read from `band` (the slice's rows:
// the block's staged copy, kStaged, or the table's): its slots weighed,
// lane l taking slots l and l + 32; those
// of nonzero weight compacted in rank order into the workspace at `base`
// at the width max(8, m rounded up to 8), with their rows, sqrt weights
// and weighted innovations; and their scaled perturbations into zt.
// Returns m, the count of slots of nonzero weight.
template <int NBC, bool kStaged>
__device__ __forceinline__ int gather_window(const Params& p,
                                             const Part& part,
                                             const float* band,
                                             const Window& win, int col,
                                             float gx, float gy, float* base,
                                             int lane) {
  constexpr int R = NBC > 32 ? 2 : 1;  // window slots per lane
  const int k = p.k, nb = p.nb, ns = p.ns, rows = k + 1 + p.n_dims;
  const int ld = kStaged ? stage_ld(rows) : rows;
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  int* kept_row = reinterpret_cast<int*>(
      base + cheb_reg::workspace_floats(k, NBC, ns, p.degree));
  float* kept_sw = reinterpret_cast<float*>(kept_row + NBC);
  // the warp keeps the slots of nonzero weight, rank order kept: slot j
  // goes to row at[r]
  int row[R], at[R];
  float sw[R], y[R];
  int m = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = lane + 32 * r;
    row[r] = -1;
    sw[r] = 0.0f;
    y[r] = 0.0f;
    if (j < nb)
      window_slot<kStaged>(p, part, band, win.start + j, col, gx, gy,
                           &row[r], &sw[r], &y[r]);
    const unsigned keep = __ballot_sync(kFull, sw[r] > 0.0f);
    at[r] = m + __popc(keep & below);
    m += __popc(keep);
  }
  const int nbc = max(8, (m + 7) & ~7);
  const cheb_reg::Workspace ws = cheb_reg::carve(base, k, nbc, ns, p.degree);
  ws.diag[lane] = 0.0f;
  ws.diag[lane + 32] = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!(sw[r] > 0.0f)) continue;
    ws.slot[at[r]] = lane + 32 * r;
    kept_row[at[r]] = row[r];
    kept_sw[at[r]] = sw[r];
    ws.w_all[at[r]] = y[r] * sw[r] + win.poison_y;
  }
  // the strict guard's NaN reaches every output, also where m is 0
  for (int e = m + lane; e < nbc; e += 32) ws.w_all[e] = win.poison_y;
  __syncwarp();
  const int zs = cheb_reg::zt_ld(nbc);
  for (int e = lane; e < nbc; e += 32) {
    const bool kept = e < m;
    const float* o = band + static_cast<size_t>(kept ? kept_row[e] : 0) * ld;
    const float s = kept ? kept_sw[e] : 0.0f;
    for (int kk = 0; kk < k; ++kk)
      ws.zt[kk * zs + e] = kept ? o[kk] * s : 0.0f;
  }
  return m;
}

// The register route: NBC = nb rounded up to 8, S in registers, each
// column solved at the width of its observations of nonzero weight, its
// window read from the block's staged slice (p.staged) or the table.
template <int NBC>
__global__ void __launch_bounds__((NBC >= 64 ? kRegWarps : kStagedWarps) *
                                      32,
                                  2)
window2d_reg_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.k, ns = p.ns, rows = k + 1 + p.n_dims;
  int* width_count = width_counts(smem, p.width);
  if (threadIdx.x < kWidths) width_count[threadIdx.x] = 0;
  const Part part = sort_band<true>(p, smem);
  if (part.slice == nullptr) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* base = reinterpret_cast<float*>(
                    smem + band_bytes(p.width) +
                    stage_bytes(p.width, rows, p.staged)) +
                static_cast<size_t>(warp) * p.per_warp;
  // the staged slice, behind the band (read where p.staged)
  const float* stage =
      reinterpret_cast<const float*>(smem + band_bytes(p.width));
  const float reg = p.scal[0];
  const float sup = __fmul_rn(p.support_z, p.scal[1]);  // f32(z*) f32(rx)

  for (int c = part.c0 + warp; c < part.c0 + part.cols; c += p.warps) {
    const int col = part.t * p.tile + c;
    const float gx = p.grid[col];
    const float gy = p.grid[p.g + col];
    const Window win = find_window(p, part, gx, sup, lane);
    // two inlined copies, so that the staged one's reads compile to
    // shared loads
    const int m = p.staged ? gather_window<NBC, true>(p, part, stage, win,
                                                      col, gx, gy, base, lane)
                           : gather_window<NBC, false>(p, part, part.slice,
                                                       win, col, gx, gy,
                                                       base, lane);
    const int nbc = max(8, (m + 7) & ~7);
    const cheb_reg::Workspace ws = cheb_reg::carve(base, k, nbc, ns, p.degree);
    for (int f = lane; f < ns * k; f += 32)
      ws.spc[f] = p.sp[static_cast<size_t>(f) * p.g + col];
    for (int i = lane; i < ns; i += 32)
      ws.meanc[i] = p.mean[static_cast<size_t>(i) * p.g + col];
    if (lane == 0) atomicAdd(&width_count[nbc / 8 - 1], 1);
    __syncwarp();

    solve_at<NBC>(nbc, ws, p, m, reg, lane);
    for (int f = lane; f < ns * k; f += 32)
      p.out[static_cast<size_t>(f) * p.g + col] = ws.spc[f];
    __syncwarp();
  }
  __syncthreads();
  // the columns at each width, then whether the block staged its slice
  if (p.counts != nullptr && threadIdx.x <= kWidths) {
    const int n = threadIdx.x < kWidths ? width_count[threadIdx.x]
                                        : static_cast<int>(p.staged != 0);
    if (n > 0) atomicAdd(&p.counts[threadIdx.x], n);
  }
}

// The shared route: the workspace of cheb_core.cuh, S in shared memory.
__global__ void __launch_bounds__(kSmemWarps * 32)
window2d_smem_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Part part = sort_band<false>(p, smem);
  if (part.slice == nullptr) return;
  const int k = p.k, nb = p.nb, ns = p.ns, rows = k + 1 + p.n_dims;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* base = reinterpret_cast<float*>(smem + band_bytes(p.width)) +
                static_cast<size_t>(warp) * p.per_warp;
  const cheb::Workspace ws = cheb::carve(base, k, nb, ns, p.degree);
  float* sw = base + cheb::workspace_floats(k, nb, ns, p.degree);
  int* win_row = reinterpret_cast<int*>(sw + nb);
  const float reg = p.scal[0];
  const float sup = __fmul_rn(p.support_z, p.scal[1]);  // f32(z*) f32(rx)

  for (int c = part.c0 + warp; c < part.c0 + part.cols; c += p.warps) {
    const int col = part.t * p.tile + c;
    const float gx = p.grid[col];
    const float gy = p.grid[p.g + col];
    const Window win = find_window(p, part, gx, sup, lane);
    for (int j = lane; j < nb; j += 32) {
      float y;
      window_slot<false>(p, part, part.slice, win.start + j, col, gx, gy,
                         &win_row[j], &sw[j], &y);
      ws.w_all[j] = y * sw[j] + win.poison_y;
    }
    __syncwarp();
    // consecutive lanes read consecutive perturbations of one row
    for (int f = lane; f < nb * k; f += 32) {
      const int j = f / k, kk = f - j * k;
      const int row = win_row[j];
      const float v =
          (row >= 0) ? part.slice[static_cast<size_t>(row) * rows + kk]
                     : 0.0f;
      ws.zh[j * ws.ld + kk] = v * sw[j];
    }
    for (int f = lane; f < ns * k; f += 32)
      ws.spc[f] = p.sp[static_cast<size_t>(f) * p.g + col];
    for (int i = lane; i < ns; i += 32)
      ws.meanc[i] = p.mean[static_cast<size_t>(i) * p.g + col];
    __syncwarp();

    cheb::solve_apply(ws, p.nodes, p.dct, k, nb, ns, p.degree, reg, lane);
    for (int f = lane; f < ns * k; f += 32)
      p.out[static_cast<size_t>(f) * p.g + col] = ws.spc[f];
    __syncwarp();
  }
}

template <int NBC>
cudaError_t launch_reg(const Params& p, int blocks, size_t smem,
                       cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      window2d_reg_kernel<NBC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  window2d_reg_kernel<NBC><<<blocks, p.warps * 32, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory of a block of `warps` columns on `route` (0 the
// register route, 1 the shared route), its slice of rows of k + 1 + n_dims
// floats staged (register route) or not.
size_t window2d_smem_bytes(int route, int k, int nb, int ns, int degree,
                           int width, int warps, int n_dims, int staged) {
  const size_t work = static_cast<size_t>(warps) *
                      floats_per_warp(route, k, nb, ns, degree) *
                      sizeof(float);
  const size_t keys = key_bytes(width);
  return band_bytes(width) + stage_bytes(width, k + 1 + n_dims, staged) +
         (work > keys ? work : keys);
}

// The analysis of every grid column; all pointers are device memory, g a
// multiple of tile, tile a multiple of splits. `counts` (int32[9], or
// null) is zeroed on the stream, then takes the columns the register
// route solved at each width 8, 16, ..., 64 and, last, the blocks that
// staged their slice. `route`, `warps`, `splits` and `staged` come from
// the wrapper's plan (window2d_plan). Returns the cudaError_t of the
// launch (0 on success).
int window2d_launch(const float* table, const int* bands, const float* grid,
                    const float* sp, const float* mean, const float* scal,
                    const float* nodes, const float* dct, float* out,
                    int* counts, int k, int n_dims, int n_rows, int g,
                    int ns, int nb, int degree, int width, int tile,
                    int taper, int strict,
                    float support_z, float epsilon, int route, int warps,
                    int splits, int staged, void* stream) {
  if (g <= 0) return 0;
  const int reg_warps =
      staged && cheb_reg::padded_nb(nb) < cheb_reg::kMaxNb ? kStagedWarps
                                                           : kRegWarps;
  if (tile <= 0 || g % tile || width < 1 || n_dims < 2 || splits < 1 ||
      tile % splits || warps < 1 || staged < 0 || staged > 1 ||
      (route == 0 && (warps > reg_warps || nb > cheb_reg::kMaxNb)) ||
      (route == 1 && (warps > kSmemWarps || staged)) || route < 0 ||
      route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = window2d_smem_bytes(route, k, nb, ns, degree, width,
                                          warps, n_dims, staged);
  if (counts != nullptr) {
    const cudaError_t err =
        cudaMemsetAsync(counts, 0, (kWidths + 1) * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Params p{table, bands, grid, sp, mean, scal, nodes, dct, out, counts,
           k, n_dims, n_rows, g, ns, nb, degree, width,
           pow2_at_least(width), tile, splits, taper, strict, warps,
           floats_per_warp(route, k, nb, ns, degree), support_z, epsilon,
           staged};
  const int blocks = (g / tile) * splits;
  cudaError_t err;
  if (route == 1) {
    err = cudaFuncSetAttribute(window2d_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    window2d_smem_kernel<<<blocks, warps * 32, smem, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  switch (cheb_reg::padded_nb(nb)) {
    case 8: err = launch_reg<8>(p, blocks, smem, st); break;
    case 16: err = launch_reg<16>(p, blocks, smem, st); break;
    case 24: err = launch_reg<24>(p, blocks, smem, st); break;
    case 32: err = launch_reg<32>(p, blocks, smem, st); break;
    case 40: err = launch_reg<40>(p, blocks, smem, st); break;
    case 48: err = launch_reg<48>(p, blocks, smem, st); break;
    case 56: err = launch_reg<56>(p, blocks, smem, st); break;
    case 64: err = launch_reg<64>(p, blocks, smem, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* window2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
