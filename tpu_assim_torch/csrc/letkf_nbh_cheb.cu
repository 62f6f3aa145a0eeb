// The localized ETKF analysis over gathered observation neighborhoods,
// Chebyshev/Clenshaw form (kernel K4): per grid column, q = X^{-1} yh and
// v_i = f(X) u_i with X = I + Zh Zh^T / reg, u_i = Zh sp_i and
// f(x) = 1/(sqrt(x)(1 + sqrt(x))), applied to ns stacked state slices as
// mean_i + <u_i, q>/reg + alpha sp_i - (alpha/reg) Zh^T v_i.
//
// Replaces the TPU kernel tpu_assim/ops/pallas/letkf.py:
// letkf_nbh_analysis_cheb (kernel _letkf_cheb_kernel, pallas_call in
// _cheb_pallas, core _cheb_solve_apply). The plain PyTorch twin is
// tpu_assim_torch/ops/cuda/letkf.py:nbh_cheb_plain.
//
// What bounds it on an H100: instruction issue and the latency of each
// column's chain of dependent steps (Gram, bound, coefficients, degree-d
// Clenshaw recurrence, apply), not bytes. At the headline shape (nb 12,
// ens 40, grid 10^4, ns 1, degree 12) the kernel reads 21 MB (zh is 19.2
// MB) and writes 1.6 MB, about 7 us at 3.35 TB/s, for 0.2 GFLOP (3 us at
// 67 TFLOP/s f32); at nb 36, ns 6, degree 48 the Clenshaw's 7 operands
// make it 10.6 GFLOP, 0.16 ms.
//
// The inputs are columns-last, as the TPU kernel wants them (zh [nb, k, g],
// yh [nb, g], sp [ns, k, g], mean [ns, g]): one column's values lie g floats
// apart, so a warp reading its own column would touch one 32-byte sector per
// float. A block therefore takes consecutive columns: its threads first
// copy the [rows, columns] slices of every input into the columns'
// workspaces, consecutive threads on consecutive columns of a row (each
// warp instruction covers whole sectors of several rows); after one barrier
// each column runs its solve; after a second barrier the block writes the
// [ns k, columns] result back the same way.
//
// Two routes, by nb (the launcher picks; ops/cuda/letkf.py:nbh_cheb_plan
// holds the same arithmetic):
//  - the register route, nb <= 64 (cheb_pack.cuh): NBC = nb rounded up to
//    4 is a template argument, S lives in registers, zh is copied in
//    transposed (zt [k][NBC] per column, for 16-byte broadcasts) by
//    asynchronous copies (cp.async, all of a thread's in flight at once;
//    one load and one store a float had left each thread waiting on every
//    load in turn), and windows of up to 16 pack several columns to a warp
//    (2 at nb 12, 4 at nb 8), up to 8 warps a block. At nb 12 the grid's
//    warps fit the card at once (5 blocks an SM, 48 registers and 5.5 KB
//    of shared memory a warp). At nb 36, ns 6, degree 48 a column's slice
//    is ~11.6 KB (zt 5.8 KB, the right-hand sides and three Clenshaw
//    buffers of 7 x 36 floats 4 KB, its own block 1.8 KB): shared memory
//    holds 2 blocks of 8 warps an SM, and so do the registers (128 a
//    thread, two rows of S a lane).
//  - the shared route, nb > 64 (cheb_core.cuh): one warp a column, S and
//    the Clenshaw vectors in shared memory, up to 8 warps a block as shared
//    memory allows.

#include <cuda_runtime.h>

#include "cheb_core.cuh"
#include "cheb_pack.cuh"

namespace {

constexpr int kMaxWarps = 8;  // warps a block, both routes

struct Params {
  const float* zh;     // [nb, k, g] scaled neighborhood perturbations
  const float* yh;     // [nb, g] scaled innovations
  const float* sp;     // [ns, k, g] state perturbations
  const float* mean;   // [ns, g] state mean
  const float* nodes;  // [d + 1] Chebyshev nodes on [-1, 1]
  const float* dct;    // [d + 1, d + 1] node values -> coefficients
  float* out;          // [ns, k, g]
  int k, g, ns, nb, degree;
  float reg;           // (K - 1) / rho
  int per_warp;        // floats of shared memory per warp
};

// The register route: NBC = nb rounded up to 4, S in registers, columns
// packed 32 / lanes_per_col(NBC) a warp. Up to NBC 16 the grid's warps
// outnumber what an SM holds, so the kernel is built for 5 blocks an SM
// (40 warps, the most the shared memory of NBC 12 allows).
template <int NBC>
__global__ void __launch_bounds__(kMaxWarps * 32, NBC <= 16 ? 5 : 1)
nbh_cheb_reg_kernel(const Params p) {
  constexpr int P = cheb_pack::cols_per_warp(NBC);
  constexpr int L = cheb_pack::lanes_per_col(NBC);
  constexpr int W = P * NBC;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cols = (blockDim.x >> 5) * P;  // columns of the block
  const int col0 = blockIdx.x * cols;
  const int k = p.k, g = p.g, ns = p.ns, nb = p.nb, degree = p.degree;
  const int own = cheb_pack::col_block(k, NBC, ns, degree, 0);
  const int pc = cheb_pack::col_floats(k, NBC, ns, degree);

  // the block's inputs into its columns' slices by asynchronous copies,
  // consecutive threads on consecutive columns of a row (each thread keeps
  // one column): zh row j k + kk into zt[kk][j] of its column, yh into row
  // 0 of w_all (pad slots zero), sp and mean into the column's own block;
  // columns past g read zeros
  const int c_t = threadIdx.x % cols, gc_t = col0 + c_t;
  const bool in_grid = gc_t < g;
  const int stride = blockDim.x / cols;
  float* warp_t = smem + static_cast<size_t>(c_t / P) * p.per_warp;
  for (int q = threadIdx.x / cols; q < (k + 1) * NBC; q += stride) {
    const int kk = q / NBC, j = q - kk * NBC;  // kk == k: yh
    const float* src = (kk < k)
                           ? p.zh + (static_cast<size_t>(j) * k + kk) * g
                           : p.yh + static_cast<size_t>(j) * g;
    const bool valid = in_grid && j < nb;
    cheb_pack::copy_async(warp_t + (c_t % P) * NBC + kk * W + j,
                          valid ? src + gc_t : p.zh, valid);
  }
  float* own_t = warp_t + own + (c_t % P) * pc;
  for (int f = threadIdx.x / cols; f < ns * (k + 1); f += stride) {
    const float* src = (f < ns * k)
                           ? p.sp + static_cast<size_t>(f) * g
                           : p.mean + static_cast<size_t>(f - ns * k) * g;
    cheb_pack::copy_async(own_t + f, in_grid ? src + gc_t : src, in_grid);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int slot = lane / L;
  const cheb_pack::Col ws = cheb_pack::carve<NBC>(
      smem + static_cast<size_t>(warp) * p.per_warp, slot, k, ns, degree);
  cheb_pack::solve_apply<NBC>(ws, p.nodes, p.dct, k, nb, ns, degree, p.reg,
                              lane % L);
  __syncthreads();

  if (in_grid)
    for (int f = threadIdx.x / cols; f < ns * k; f += stride)
      p.out[static_cast<size_t>(f) * g + gc_t] = own_t[f];
}

// Rows [rows, g] of a columns-last input, columns col0..col0 + cols - 1,
// into each column's workspace at float `offset`, row r at offset + (r /
// run) ld + r % run (zh's padded rows; run = ld = rows for the others):
// consecutive threads take consecutive columns of a row (a ragged last
// block reads zeros).
__device__ __forceinline__ void load_cols(float* smem, const float* src,
                                          int rows, int offset, int run,
                                          int ld, const Params& p, int col0) {
  const int cols = blockDim.x >> 5;
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, c = e - r * cols;
    const int col = col0 + c;
    smem[static_cast<size_t>(c) * p.per_warp + offset + (r / run) * ld +
         r % run] = (col < p.g) ? src[static_cast<size_t>(r) * p.g + col]
                                : 0.0f;
  }
}

// The shared route: one warp a column, the workspace of cheb_core.cuh.
__global__ void __launch_bounds__(kMaxWarps * 32)
nbh_cheb_smem_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cols = blockDim.x >> 5;
  const int col0 = blockIdx.x * cols;
  const int k = p.k, g = p.g, ns = p.ns, nb = p.nb;

  // the offsets of the workspace's parts within a column's slice
  const cheb::Workspace ws0 = cheb::carve(smem, k, nb, ns, p.degree);
  const int spc_off = static_cast<int>(ws0.spc - smem);
  load_cols(smem, p.zh, nb * k, static_cast<int>(ws0.zh - smem), k, ws0.ld,
            p, col0);
  load_cols(smem, p.yh, nb, static_cast<int>(ws0.w_all - smem), nb, nb, p,
            col0);
  load_cols(smem, p.sp, ns * k, spc_off, ns * k, ns * k, p, col0);
  load_cols(smem, p.mean, ns, static_cast<int>(ws0.meanc - smem), ns, ns, p,
            col0);
  __syncthreads();

  const int col = col0 + warp;
  if (col < g) {
    const cheb::Workspace ws = cheb::carve(
        smem + static_cast<size_t>(warp) * p.per_warp, k, nb, ns, p.degree);
    cheb::solve_apply(ws, p.nodes, p.dct, k, nb, ns, p.degree, p.reg, lane);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < ns * k * cols; e += blockDim.x) {
    const int r = e / cols, c = e - r * cols;
    const int oc = col0 + c;
    if (oc < g)
      p.out[static_cast<size_t>(r) * g + oc] =
          smem[static_cast<size_t>(c) * p.per_warp + spc_off + r];
  }
}

// Floats of shared memory one warp uses on the route of nb.
int floats_per_warp(int k, int nb, int ns, int degree) {
  if (nb <= cheb_pack::kMaxNb)
    return cheb_pack::warp_floats(k, cheb_pack::padded_nb(nb), ns, degree);
  return cheb::workspace_floats(k, nb, ns, degree);
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
  if (nbc == NBC) return launch(nbh_cheb_reg_kernel<NBC>, p, warps, blocks, smem, st);
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
int nbh_cheb_cols_per_warp(int nb) {
  return nb <= cheb_pack::kMaxNb
             ? cheb_pack::cols_per_warp(cheb_pack::padded_nb(nb)) : 1;
}

// Bytes of shared memory of a block of `warps` warps.
size_t nbh_cheb_smem_bytes(int k, int nb, int ns, int degree, int warps) {
  return static_cast<size_t>(warps) * floats_per_warp(k, nb, ns, degree) *
         sizeof(float);
}

// The analysis of every grid column in `blocks` blocks of `warps` warps
// (ops/cuda/letkf.py:nbh_cheb_plan); all pointers are device memory.
// Returns the cudaError_t of the launch (0 on success).
int nbh_cheb_launch(const float* zh, const float* yh, const float* sp,
                    const float* mean, const float* nodes, const float* dct,
                    float* out, int k, int g, int ns, int nb, int degree,
                    float reg, int warps, int blocks, void* stream) {
  if (g <= 0) return 0;
  if (nb < 1 || warps < 1 || warps > kMaxWarps
      || static_cast<long long>(blocks) * warps * nbh_cheb_cols_per_warp(nb)
             < g)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p{zh, yh, sp, mean, nodes, dct, out, k, g, ns, nb, degree,
                 reg, floats_per_warp(k, nb, ns, degree)};
  const size_t smem = nbh_cheb_smem_bytes(k, nb, ns, degree, warps);
  cudaError_t err;
  err = nb <= cheb_pack::kMaxNb
            ? launch_reg<4>(cheb_pack::padded_nb(nb), p, warps, blocks, smem,
                            st)
            : launch(nbh_cheb_smem_kernel, p, warps, blocks, smem, st);
  return static_cast<int>(err);
}

const char* nbh_cheb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
