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
// tpu_assim_torch/ops/cuda/letkf.py:window2d_plain. The solve is
// cheb_core.cuh (shared with K1 and K4), the taper taper.cuh (shared with
// K1).
//
// Input: one y-sorted observation table [n_rows, rows], a row per
// observation slot (k perturbations, innovation, x, y, extra coordinates),
// and per tile (off, a, b): the tile reads the slots [off, off + width) and
// sees the x of slots outside [a, b) as +FLT_MAX, so that only its band's
// observations take part in the x-ranks and counts. The whole-table mode
// of the JAX package is the same kernel with (0, 0, o) for every tile.
//
// What bounds it on an H100: the per-column work, not bytes. At bench
// config 8 (2^20 columns, ens 40, nb 40-48, degree 16) a column costs the
// Gram matrix (2 nb^2 k FLOP), the joint Clenshaw recurrence ((d + 1)(1 +
// ns) nb (2 nb + 4)) and the apply (4 ns nb k): ~3.5e5 FLOP, ~0.35 TFLOP in
// all, >= ~5 ms at the 67 TFLOP/s f32 rate outside the tensor cores,
// against ~0.1 ms for the 336 MB of state the kernel reads and writes. Each
// column's chain of dependent steps runs in one warp, as in K1, with the
// Gram matrix and the Clenshaw vectors in the warp's slice of shared
// memory; a block of up to 8 warps shares its tile's sorted band.
//
// Design against the TPU kernel: the TPU computes every slot's x-rank by an
// [o_b, o_b] comparison and selects the window by a one-hot matmul in three
// bf16 limbs. Here the block sorts its slice once by (x, slot) with a
// bitonic sort of 64-bit keys in shared memory (the slot index in the low
// half breaks ties, as the TPU's index tie-break does), and each column
// finds its window by binary search and gathers the nb table rows
// directly (a row's k perturbations are contiguous). The 128-lane padded
// transposed table and the 8-aligned DMA offsets were layout needs of the
// TPU and are gone; the offsets survive only in the wrapper, where they
// decide which slots a tile sees.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "cheb_core.cuh"
#include "taper.cuh"

namespace {

constexpr int kMaxWarps = 8;  // columns in flight per block
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
  int k, n_dims, n_rows, g, ns, nb, degree;
  int width;           // slots per slice
  int width_pow2;      // the sort's length: width rounded up to a power of 2
  int tile;            // grid columns per block
  int taper;           // 0 = GC(z, 1/2, c), 1 = GC(z, inf, c)
  int strict;
  int warps;
  int per_warp;        // floats of shared memory per warp
  float support_z;     // taper support in units of the radius
  float epsilon;
};

__host__ __device__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of the band's sort keys, sorted x and slot indices, 16-aligned.
__host__ __device__ size_t band_bytes(int width) {
  const size_t b = 8u * pow2_at_least(width) + 8u * width;
  return (b + 15) & ~static_cast<size_t>(15);
}

int floats_per_warp(int k, int nb, int ns, int degree) {
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

__global__ void __launch_bounds__(kMaxWarps * 32)
window2d_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_tiles = gridDim.x;
  const int t = blockIdx.x;
  const int k = p.k, nb = p.nb, ns = p.ns, width = p.width;
  const int rows = k + 1 + p.n_dims;
  const int off = p.bands[t];
  const int a = p.bands[n_tiles + t];
  const int b = p.bands[2 * n_tiles + t];

  // a slice outside the table poisons its tile (never read past the table)
  if (off < 0 || off + width > p.n_rows) {
    for (int e = threadIdx.x; e < ns * k * p.tile; e += blockDim.x) {
      const int f = e / p.tile, c = e - f * p.tile;
      p.out[static_cast<size_t>(f) * p.g + t * p.tile + c] = nanf("");
    }
    return;
  }
  const float* slice = p.table + static_cast<size_t>(off) * rows;

  // 1. sort the slice's slots by (masked x, slot)
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  float* xs = reinterpret_cast<float*>(keys + p.width_pow2);
  int* slot_of = reinterpret_cast<int*>(xs + width);
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
  __syncthreads();

  // 2. one warp per column of the tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* base = reinterpret_cast<float*>(smem + band_bytes(width)) +
                static_cast<size_t>(warp) * p.per_warp;
  const cheb::Workspace ws = cheb::carve(base, k, nb, ns, p.degree);
  float* sw = base + cheb::workspace_floats(k, nb, ns, p.degree);
  int* win_row = reinterpret_cast<int*>(sw + nb);
  const float reg = p.scal[0], rx = p.scal[1], ry = p.scal[2];
  const float sup = __fmul_rn(p.support_z, rx);  // f32(z*) f32(rx), no FMA

  for (int c = warp; c < p.tile; c += p.warps) {
    const int col = t * p.tile + c;
    const float gx = p.grid[col];
    const float gy = p.grid[p.g + col];
    // window start from three counts over the sorted band
    int r = 0;
    if (lane == 0) r = count_below(xs, width, gx, true);
    if (lane == 1) r = count_below(xs, width, gx - sup, true);
    if (lane == 2) r = count_below(xs, width, gx + sup, false);
    const int center = __shfl_sync(kFull, r, 0);
    const int low = __shfl_sync(kFull, r, 1);
    const int high = __shfl_sync(kFull, r, 2);
    int start = min(max(center - nb / 2, high - nb), low);
    start = min(max(start, 0), width - nb);
    // strict guard: more band observations in the x-cutoff than slots
    const float poison_y =
        (p.strict && width > nb && high - low > nb) ? nanf("") : 0.0f;

    // gather the window's rows, product taper, sqrt-weight scaling
    for (int j = lane; j < nb; j += 32) {
      const int pos = start + j;
      float w = 0.0f, y = 0.0f;
      int row = -1;
      if (pos >= 0 && pos < width) {
        row = slot_of[pos];
        const float* o = slice + static_cast<size_t>(row) * rows;
        w = taper::weight(fabsf(xs[pos] - gx) / rx, p.taper, 0.0f) *
            taper::weight(fabsf(o[k + 2] - gy) / ry, p.taper, 0.0f);
        for (int e = 0; e < p.n_dims - 2; ++e)
          w = w * taper::weight(
                      fabsf(o[k + 3 + e] -
                            p.grid[static_cast<size_t>(2 + e) * p.g + col]) /
                          p.scal[3 + e],
                      p.taper, 0.0f);
        w = (w > p.epsilon) ? w : 0.0f;
        y = o[k];
      }
      const float s = sqrtf(w);
      sw[j] = s;
      win_row[j] = row;
      ws.w_all[j] = y * s + poison_y;
    }
    __syncwarp();
    // consecutive lanes read consecutive perturbations of one row
    for (int f = lane; f < nb * k; f += 32) {
      const int j = f / k, kk = f - j * k;
      const int row = win_row[j];
      const float v =
          (row >= 0) ? slice[static_cast<size_t>(row) * rows + kk] : 0.0f;
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

}  // namespace

extern "C" {

// Bytes of shared memory of a block of `warps` columns.
size_t window2d_smem_bytes(int k, int nb, int ns, int degree, int width,
                           int warps) {
  return band_bytes(width) + static_cast<size_t>(warps) *
                                 floats_per_warp(k, nb, ns, degree) *
                                 sizeof(float);
}

// The analysis of every grid column; all pointers are device memory, g a
// multiple of tile, smem_limit the shared memory one block may use.
// Returns the cudaError_t of the launch (0 on success).
int window2d_launch(const float* table, const int* bands, const float* grid,
                    const float* sp, const float* mean, const float* scal,
                    const float* nodes, const float* dct, float* out, int k,
                    int n_dims, int n_rows, int g, int ns, int nb, int degree,
                    int width, int tile, int taper, int strict,
                    float support_z, float epsilon, int smem_limit,
                    void* stream) {
  if (g <= 0) return 0;
  if (tile <= 0 || g % tile || width < 1 || n_dims < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_warp = floats_per_warp(k, nb, ns, degree);
  const size_t per_warp_bytes = static_cast<size_t>(per_warp) * sizeof(float);
  const size_t band = band_bytes(width);
  if (band + per_warp_bytes > static_cast<size_t>(smem_limit))
    return static_cast<int>(cudaErrorInvalidValue);
  int warps = static_cast<int>((smem_limit - band) / per_warp_bytes);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  warps = warps < tile ? warps : tile;
  const size_t smem = band + warps * per_warp_bytes;
  Params p{table, bands, grid, sp, mean, scal, nodes, dct, out,
           k, n_dims, n_rows, g, ns, nb, degree, width,
           pow2_at_least(width), tile, taper, strict, warps, per_warp,
           support_z, epsilon};
  cudaError_t err = cudaFuncSetAttribute(
      window2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window2d_kernel<<<g / tile, warps * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* window2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
