// Batched square SVD by one-sided (Hestenes) Jacobi with Brent-Luk
// tournament ordering, one launch for a whole [B, K, K] f32 batch.
//
// Replaces the TPU kernel tpu_assim/ops/pallas/svd.py:_svd_kernel (entry
// svd_jacobi), which carries 128 matrices in the lanes of a transposed
// [K_col, K_row, 128] tile and re-seats columns with rolls because Mosaic
// has no gather. Here a block owns one matrix and a seat -> column table in
// shared memory does the re-seating, so no column ever moves.
//
// What bounds it on an H100: latency, not bytes or FLOPs. A [10^4, 40, 40]
// batch is 64 MB in and 128 MB out, read and written once; a sweep is
// K - 1 = 39 dependent rounds, and every round is a norm/dot reduction, a
// square root and a division, then the rotation, then a block barrier. The
// design keeps everything on chip for all sweeps and runs the K/2 column
// pairs of a round in parallel, one warp per pair.
//
// Layout per block (Kp = K rounded up to even; Kp/2 warps):
//   shared A[Kp][Kp]   the columns of A, column-major (A[j*Kp + i] = A_ij);
//                      odd K gets one zero pad row and column
//   shared V[Kp][Kp]   the accumulated rotations, column-major, from I
//   shared seat[2][Kp] seat -> column, ping-ponged between rounds
//   shared inv[Kp]     1/sigma per column, for the output pass
//
// Per round, warp w takes the pair at seats (2w, 2w+1), columns p and q:
//   alpha = |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q (lanes stride the
//   rows; xor-butterfly reductions, which leave every lane the same bits);
//   the pair freezes (c = 1, s = 0) when |gamma| <= feps sqrt(alpha)
//   sqrt(beta) + tiny, feps = 8 eps (the TPU kernel's 8 Kp eps leaves U
//   too far from orthogonal for f32; ops/cuda/svd.py says why); else
//   tau = (beta - alpha) / (2 gamma),
//   t = sign(tau) / (|tau| + sqrt(1 + tau^2)) (t = 1 when tau == 0),
//   c = 1/sqrt(1 + t^2) with an exactly rounded square root and division
//   (an approximate reciprocal square root compounds non-orthogonality),
//   s = t c; then a_p <- c a_p - s a_q, a_q <- c a_q + s a_p, and the same
//   for V's columns. The rotation is applied even to a frozen pair, as the
//   TPU kernel does, so a NaN spreads to exactly the same entries.
// The seats then move one step around the Brent-Luk ring (seat 0 fixed),
// which composes to the identity every Kp - 1 rounds: one sweep. A matrix
// stops after the first sweep with no live rotation, or after `sweeps`.
//
// Output: sigma_j = |a_j|, u_j = a_j / sigma_j where sigma_j > tiny, else
// a zero column, V; in seat (= column) order, row-major [B, Kp, Kp] and
// [B, Kp]. The wrapper sorts and slices.
//
// Products and sums of the round are explicitly rounded intrinsics in the
// order of the plain PyTorch version (tpu_assim_torch/ops/cuda/svd.py:
// svd_jacobi_plain), so that the compiler contracts nothing into FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Brent-Luk re-seating: the column at seat p after a round is the one that
// sat at seat_source(p) before it.
__device__ __forceinline__ int seat_source(int p, int kp) {
  if (kp == 2 || p == 0) return p;
  if (p == 2 || p == kp - 1) return p - 1;
  return (p % 2 == 0) ? p - 2 : p + 2;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__global__ void svd_jacobi_kernel(const float* __restrict__ a,
                                  float* __restrict__ u_out,
                                  float* __restrict__ s_out,
                                  float* __restrict__ v_out, int k, int kp,
                                  int sweeps, float feps, float tiny) {
  extern __shared__ float smem[];
  float* A = smem;
  float* V = A + kp * kp;
  float* inv = V + kp * kp;
  int* seat = reinterpret_cast<int*>(inv + kp);
  const int nn = kp * kp;
  const float* ab = a + static_cast<size_t>(blockIdx.x) * k * k;

  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / kp, j = e % kp;
    A[j * kp + i] = (i < k && j < k) ? ab[i * k + j] : 0.0f;
    V[j * kp + i] = (i == j) ? 1.0f : 0.0f;
  }
  if (threadIdx.x < kp) seat[threadIdx.x] = threadIdx.x;
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  int* cur = seat;
  int* nxt = seat + kp;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    int live_any = 0;
    for (int r = 0; r < kp - 1; ++r) {
      // nobody reads nxt or writes cur during the round
      if (threadIdx.x < kp) nxt[threadIdx.x] = cur[seat_source(threadIdx.x, kp)];
      float* ap = A + cur[2 * warp] * kp;
      float* aq = A + cur[2 * warp + 1] * kp;
      float alp = 0.0f, bet = 0.0f, gam = 0.0f;
      for (int i = lane; i < kp; i += kWarp) {
        const float x = ap[i], y = aq[i];
        alp = __fadd_rn(alp, __fmul_rn(x, x));
        bet = __fadd_rn(bet, __fmul_rn(y, y));
        gam = __fadd_rn(gam, __fmul_rn(x, y));
      }
      alp = warp_sum(alp);
      bet = warp_sum(bet);
      gam = warp_sum(gam);
      const float tol = __fadd_rn(
          __fmul_rn(feps, __fmul_rn(__fsqrt_rn(alp), __fsqrt_rn(bet))), tiny);
      const bool live = fabsf(gam) > tol;  // false for a NaN gamma
      float c = 1.0f, s = 0.0f;
      if (live) {
        const float tau = __fdiv_rn(__fsub_rn(bet, alp), __fmul_rn(2.0f, gam));
        float t = 1.0f;  // tau == 0: 45 degrees (the even seat's sign)
        if (tau != 0.0f) {
          const float sq = __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)));
          t = __fdiv_rn(copysignf(1.0f, tau), __fadd_rn(fabsf(tau), sq));
        }
        c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
        s = __fmul_rn(t, c);
      }
      live_any |= live;
      float* vp = V + (ap - A);
      float* vq = V + (aq - A);
      for (int i = lane; i < kp; i += kWarp) {
        const float x = ap[i], y = aq[i];
        ap[i] = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
        aq[i] = __fadd_rn(__fmul_rn(c, y), __fmul_rn(s, x));
        const float vx = vp[i], vy = vq[i];
        vp[i] = __fsub_rn(__fmul_rn(c, vx), __fmul_rn(s, vy));
        vq[i] = __fadd_rn(__fmul_rn(c, vy), __fmul_rn(s, vx));
      }
      __syncthreads();
      int* t = cur;
      cur = nxt;
      nxt = t;
    }
    if (!__syncthreads_or(live_any)) break;
  }

  // whole sweeps re-seat to the identity: column j sits at A + j*kp
  float* sb = s_out + static_cast<size_t>(blockIdx.x) * kp;
  for (int j = warp; j < kp; j += blockDim.x / kWarp) {
    float nrm2 = 0.0f;
    for (int i = lane; i < kp; i += kWarp) {
      const float x = A[j * kp + i];
      nrm2 = __fadd_rn(nrm2, __fmul_rn(x, x));
    }
    const float sig = __fsqrt_rn(warp_sum(nrm2));
    if (lane == 0) {
      sb[j] = sig;
      inv[j] = sig > tiny ? __fdiv_rn(1.0f, fmaxf(sig, tiny)) : 0.0f;
    }
  }
  __syncthreads();
  float* ub = u_out + static_cast<size_t>(blockIdx.x) * nn;
  float* vb = v_out + static_cast<size_t>(blockIdx.x) * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / kp, j = e % kp;
    ub[e] = __fmul_rn(A[j * kp + i], inv[j]);
    vb[e] = V[j * kp + i];
  }
}

}  // namespace

extern "C" {

// Threads of one block: one warp per column pair.
int svd_jacobi_threads(int kp) { return (kp / 2) * kWarp; }

// Shared memory one block needs for a Kp x Kp matrix.
size_t svd_jacobi_smem_bytes(int kp) {
  return (2 * static_cast<size_t>(kp) * kp + kp) * sizeof(float) +
         2 * static_cast<size_t>(kp) * sizeof(int);
}

// SVD of `batch` contiguous row-major K x K f32 matrices `a`; writes
// u [batch, Kp, Kp], s [batch, Kp], v [batch, Kp, Kp] (Kp = K + K % 2),
// columns in seat order, unsorted. Returns the cudaError_t of the launch
// (0 on success).
int svd_jacobi_launch(const float* a, float* u, float* s, float* v,
                      int batch, int k, int sweeps, float feps, float tiny,
                      void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int kp = k + (k % 2);
  const size_t smem = svd_jacobi_smem_bytes(kp);
  cudaError_t err = cudaFuncSetAttribute(
      svd_jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  svd_jacobi_kernel<<<batch, svd_jacobi_threads(kp), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      a, u, s, v, k, kp, sweeps, feps, tiny);
  return static_cast<int>(cudaGetLastError());
}

const char* svd_jacobi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
