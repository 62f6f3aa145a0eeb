// The localized ETKF analysis over gathered observation neighborhoods,
// Chebyshev/Clenshaw form (kernel K4): per grid column, q = X^{-1} yh and
// v_i = f(X) u_i with X = I + Zh Zh^T / reg, u_i = Zh sp_i and
// f(x) = 1/(sqrt(x)(1 + sqrt(x))), applied to ns stacked state slices as
// mean_i + <u_i, q>/reg + alpha sp_i - (alpha/reg) Zh^T v_i.
//
// Replaces the TPU kernel tpu_assim/ops/pallas/letkf.py:
// letkf_nbh_analysis_cheb (kernel _letkf_cheb_kernel, pallas_call in
// _cheb_pallas, core _cheb_solve_apply). The plain PyTorch twin is
// tpu_assim_torch/ops/cuda/letkf.py:nbh_cheb_plain. The solve itself is
// cheb_core.cuh, shared with the window kernel letkf_window1d.cu.
//
// What bounds it on an H100: the latency of each column's chain of
// dependent steps (Gram, bound, coefficients, degree-d Clenshaw
// recurrence, apply), not bytes. At the headline shape (nb 12, ens 40,
// grid 10^4, ns 1, degree 12) the kernel reads 21 MB (zh is 19.2 MB) and
// writes 1.6 MB, about 7 us at 3.35 TB/s, for 0.2 GFLOP (3 us at 67
// TFLOP/s f32), where one column's chain takes tens of microseconds.
//
// The inputs are columns-last, as the TPU kernel wants them (zh [nb, k, g],
// yh [nb, g], sp [ns, k, g], mean [ns, g]): one column's values lie g floats
// apart, so a warp reading its own column would touch one 32-byte sector per
// float. The design therefore gives a block C consecutive columns (C = 8,
// fewer when the workspace does not fit): the block's threads first copy the
// [rows, C] slices of every input into the columns' workspaces, each warp
// instruction covering 4 rows x 8 columns = 4 whole sectors; after one
// barrier each warp runs K1's per-column solve on its own column; after a
// second barrier the block writes the [ns k, C] result back the same way.

#include <cuda_runtime.h>

#include "cheb_core.cuh"

namespace {

constexpr int kMaxCols = 8;  // grid columns (warps) per block

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
  int cols;            // grid columns per block
  int per_warp;        // floats of shared memory per column
};

// Rows [rows, g] of a columns-last input, columns col0..col0 + cols - 1,
// into each column's workspace at float `offset`, row r at offset + (r /
// run) ld + r % run (zh's padded rows; run = ld = rows for the others):
// consecutive threads take consecutive columns of a row (a ragged last
// block reads zeros).
__device__ __forceinline__ void load_cols(float* smem, const float* src,
                                          int rows, int offset, int run,
                                          int ld, const Params& p, int col0) {
  const int cols = p.cols;
  for (int e = threadIdx.x; e < rows * cols; e += cols * 32) {
    const int r = e / cols, c = e - r * cols;
    const int col = col0 + c;
    smem[static_cast<size_t>(c) * p.per_warp + offset + (r / run) * ld +
         r % run] = (col < p.g) ? src[static_cast<size_t>(r) * p.g + col]
                                : 0.0f;
  }
}

__global__ void nbh_cheb_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cols = p.cols;
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

  for (int e = threadIdx.x; e < ns * k * cols; e += cols * 32) {
    const int r = e / cols, c = e - r * cols;
    const int oc = col0 + c;
    if (oc < g)
      p.out[static_cast<size_t>(r) * g + oc] =
          smem[static_cast<size_t>(c) * p.per_warp + spc_off + r];
  }
}

int cols_per_block(int per_warp_bytes, int smem_limit) {
  int cols = kMaxCols;
  while (cols > 1 && cols * per_warp_bytes > smem_limit) cols >>= 1;
  return cols;
}

}  // namespace

extern "C" {

// Bytes of shared memory one grid column's workspace takes; a block holds
// up to 8 of them.
size_t nbh_cheb_smem_bytes_per_col(int k, int nb, int ns, int degree) {
  return static_cast<size_t>(cheb::workspace_floats(k, nb, ns, degree)) *
         sizeof(float);
}

// The analysis of every grid column; all pointers are device memory.
// smem_limit is the shared memory one block may use. Returns the
// cudaError_t of the launch (0 on success).
int nbh_cheb_launch(const float* zh, const float* yh, const float* sp,
                    const float* mean, const float* nodes, const float* dct,
                    float* out, int k, int g, int ns, int nb, int degree,
                    float reg, int smem_limit, void* stream) {
  if (g <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_warp = cheb::workspace_floats(k, nb, ns, degree);
  const int cols = cols_per_block(per_warp * static_cast<int>(sizeof(float)),
                                  smem_limit);
  const size_t smem = static_cast<size_t>(cols) * per_warp * sizeof(float);
  Params p{zh, yh, sp, mean, nodes, dct, out, k, g, ns, nb, degree, reg,
           cols, per_warp};
  cudaError_t err = cudaFuncSetAttribute(
      nbh_cheb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nbh_cheb_kernel<<<(g + cols - 1) / cols, cols * 32, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* nbh_cheb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
