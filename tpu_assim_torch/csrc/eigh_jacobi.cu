// Batched symmetric eigendecomposition by two-sided cyclic Jacobi with
// Brent-Luk tournament ordering, one launch for a whole [B, Kp, Kp] f32
// batch (Kp even; the wrapper pads odd K with one decoupled seat).
//
// Replaces the TPU kernel tpu_assim/ops/pallas/jacobi.py:_jacobi_kernel
// (entry eigh_jacobi), which carries 128 matrices in the lanes of a
// [K, K, 128] tile and re-seats rows and columns with rolls and a (K/2, 2)
// split, because Mosaic has no gather. Here a block owns one matrix, and a
// seat -> row table in shared memory does the re-seating, so no row or
// column of A or V ever moves.
//
// What bounds it on an H100: latency, not bytes or FLOPs. A [10^4, 40, 40]
// batch is 64 MB in and 64 MB out, read and written once, and 7 sweeps are
// 2.6e10 FLOP (A symmetric: the 2 x 2 blocks of its upper triangle and V's
// columns, ~6 Kp^2 a round; 0.38 ms at the f32 rate); but a sweep is
// Kp - 1 dependent rounds, each a rotation per pair, then a pass over two
// rows per pair, then over two columns per pair, with a block barrier
// after each. The
// design keeps A and V^T in shared memory for all sweeps, spreads each
// pass over all 256 threads of the block (one element pair per thread and
// step), and gives the rows an odd stride (ld = Kp | 1), so that the
// column pass, whose threads walk down a column, hits 32 distinct banks.
//
// Per round, thread i < Kp/2 takes the pair at seats (2i, 2i+1), rows p
// and q (the even seat is p):
//   o = (a_pq + a_qp) / 2, tau = (d_q - d_p) / (2 o) (o -> 1 where
//   |o| <= tiny), t = sign(tau) / (|tau| + sqrt(1 + tau^2)), t = 1 where
//   tau == 0, c = 1/sqrt(1 + t^2) with an exactly rounded square root and
//   division (not rsqrtf: an approximate one compounds non-orthogonality
//   over hundreds of rotations), s = t c; the pair is frozen (c = 1,
//   s = 0) unless |o| > feps (|d_p| + |d_q|) + tiny, feps = 8 eps (the
//   TPU kernel's 8 Kp eps leaves the f32 analysis of indefinite Grams
//   above its error budget; ops/cuda/jacobi.py says why).
//   The odd seat's rotation is (c, -s): tau, and so t and s, are exactly
//   antisymmetric in the pair.
// Then rows p, q of A and of V^T, then columns p, q of A:
//   x_p <- c x_p - s x_q,  x_q <- c x_q + s x_p.
// The seats then move one step around the ring (seat 0 fixed), which
// composes to the identity every Kp - 1 rounds: one sweep. Before each
// sweep a matrix stops once every off-diagonal |a_ij| <= feps (|a_ii| +
// |a_jj|) + tiny, or after `sweeps` sweeps; `run` gets the sweeps it ran
// (sweeps + 1 if the cap stopped it while still rotating).
//
// Output: evals [B, Kp] = diag(A), vecs [B, Kp, Kp] = V, row-major, in
// index order (whole sweeps re-seat to the identity), unsorted. The
// wrapper sorts and slices.
//
// Products and sums are explicitly rounded intrinsics in the order of the
// plain PyTorch version (tpu_assim_torch/ops/cuda/jacobi.py:
// eigh_jacobi_plain), so that the compiler contracts nothing into FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Brent-Luk re-seating: the row at seat p after a round is the one that
// sat at seat_source(p) before it.
__device__ __forceinline__ int seat_source(int p, int kp) {
  if (kp == 2 || p == 0) return p;
  if (p == 2 || p == kp - 1) return p - 1;
  return (p % 2 == 0) ? p - 2 : p + 2;
}

// Whether any off-diagonal entry of A is above its pair's freeze
// threshold; every thread of the block gets the answer.
__device__ bool any_unfrozen(const float* A, int kp, int ld, float feps,
                             float tiny) {
  int unfrozen = 0;
  for (int e = threadIdx.x; e < kp * kp; e += blockDim.x) {
    const int i = e / kp, j = e % kp;
    if (i == j) continue;
    const float tol = __fadd_rn(
        __fmul_rn(feps, __fadd_rn(fabsf(A[i * ld + i]), fabsf(A[j * ld + j]))),
        tiny);
    unfrozen |= fabsf(A[i * ld + j]) > tol;  // false for a NaN
  }
  return __syncthreads_or(unfrozen) != 0;
}

__global__ void __launch_bounds__(kThreads)
eigh_jacobi_kernel(const float* __restrict__ a, float* __restrict__ evals,
                   float* __restrict__ vecs, int* __restrict__ run, int kp,
                   int sweeps, float feps, float tiny) {
  extern __shared__ float smem[];
  const int ld = kp | 1;
  const int half = kp / 2;
  float* A = smem;                 // A[i * ld + j] = A_ij
  float* Vt = A + kp * ld;         // Vt[j * ld + i] = V_ij
  float* cs = Vt + kp * ld;        // per pair: cosine
  float* sn = cs + half;           // per pair: the even seat's sine
  int* seat = reinterpret_cast<int*>(sn + half);  // [2][kp]
  const size_t nn = static_cast<size_t>(kp) * kp;
  const float* ab = a + blockIdx.x * nn;

  for (int e = threadIdx.x; e < kp * kp; e += blockDim.x) {
    const int i = e / kp, j = e % kp;
    A[i * ld + j] = ab[e];
    Vt[i * ld + j] = (i == j) ? 1.0f : 0.0f;
  }
  if (threadIdx.x < kp) seat[threadIdx.x] = threadIdx.x;
  __syncthreads();

  int* cur = seat;
  int* nxt = seat + kp;
  int sweep = 0;
  for (; sweep < sweeps; ++sweep) {
    if (!any_unfrozen(A, kp, ld, feps, tiny)) break;
    for (int r = 0; r < kp - 1; ++r) {
      // nobody reads nxt or writes cur during the round
      if (threadIdx.x < kp) nxt[threadIdx.x] = cur[seat_source(threadIdx.x, kp)];
      if (threadIdx.x < half) {
        const int p = cur[2 * threadIdx.x], q = cur[2 * threadIdx.x + 1];
        const float dp = A[p * ld + p], dq = A[q * ld + q];
        const float o = __fmul_rn(0.5f, __fadd_rn(A[p * ld + q], A[q * ld + p]));
        const float o_safe = fabsf(o) > tiny ? o : 1.0f;
        const float tau = __fdiv_rn(__fsub_rn(dq, dp), __fmul_rn(2.0f, o_safe));
        float t = 1.0f;  // tau == 0: 45 degrees, +1 at the even seat
        if (tau != 0.0f) {
          const float sq = __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)));
          t = __fdiv_rn(copysignf(1.0f, tau), __fadd_rn(fabsf(tau), sq));
        }
        const float c =
            __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
        const float tol = __fadd_rn(
            __fmul_rn(feps, __fadd_rn(fabsf(dp), fabsf(dq))), tiny);
        const bool live = fabsf(o) > tol;  // false for a NaN
        cs[threadIdx.x] = live ? c : 1.0f;
        sn[threadIdx.x] = live ? __fmul_rn(t, c) : 0.0f;
      }
      __syncthreads();
      // rows p, q of A and of V^T; x_q <- c x_q - (-s) x_p is c x_q + s x_p
      for (int e = threadIdx.x; e < half * kp; e += blockDim.x) {
        const int i = e / kp, j = e % kp;
        const int p = cur[2 * i] * ld + j, q = cur[2 * i + 1] * ld + j;
        const float c = cs[i], s = sn[i];
        const float x = A[p], y = A[q];
        A[p] = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
        A[q] = __fadd_rn(__fmul_rn(c, y), __fmul_rn(s, x));
        const float vx = Vt[p], vy = Vt[q];
        Vt[p] = __fsub_rn(__fmul_rn(c, vx), __fmul_rn(s, vy));
        Vt[q] = __fadd_rn(__fmul_rn(c, vy), __fmul_rn(s, vx));
      }
      __syncthreads();
      // columns p, q of A
      for (int e = threadIdx.x; e < half * kp; e += blockDim.x) {
        const int i = e / kp, row = (e % kp) * ld;
        const int p = row + cur[2 * i], q = row + cur[2 * i + 1];
        const float c = cs[i], s = sn[i];
        const float x = A[p], y = A[q];
        A[p] = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
        A[q] = __fadd_rn(__fmul_rn(c, y), __fmul_rn(s, x));
      }
      __syncthreads();
      int* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  // a cap that stopped a matrix still rotating counts one sweep more
  const bool capped = sweep == sweeps && any_unfrozen(A, kp, ld, feps, tiny);
  if (threadIdx.x == 0) run[blockIdx.x] = capped ? sweeps + 1 : sweep;

  float* eb = evals + static_cast<size_t>(blockIdx.x) * kp;
  float* vb = vecs + blockIdx.x * nn;
  if (threadIdx.x < kp) eb[threadIdx.x] = A[threadIdx.x * ld + threadIdx.x];
  for (int e = threadIdx.x; e < kp * kp; e += blockDim.x) {
    const int i = e / kp, j = e % kp;
    vb[e] = Vt[j * ld + i];
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a Kp x Kp matrix.
size_t eigh_jacobi_smem_bytes(int kp) {
  const size_t ld = static_cast<size_t>(kp | 1);
  return (2 * static_cast<size_t>(kp) * ld + kp) * sizeof(float) +
         2 * static_cast<size_t>(kp) * sizeof(int);
}

// Eigendecomposition of `batch` contiguous row-major Kp x Kp symmetric f32
// matrices `a` (Kp even); writes evals [batch, Kp], vecs [batch, Kp, Kp]
// (eigenvector columns, unsorted) and run [batch] (sweeps run). Returns the
// cudaError_t of the launch (0 on success).
int eigh_jacobi_launch(const float* a, float* evals, float* vecs, int* run,
                       int batch, int kp, int sweeps, float feps, float tiny,
                       void* stream) {
  if (batch <= 0 || kp <= 0) return 0;
  if (kp % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = eigh_jacobi_smem_bytes(kp);
  cudaError_t err = cudaFuncSetAttribute(
      eigh_jacobi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  eigh_jacobi_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      a, evals, vecs, run, kp, sweeps, feps, tiny);
  return static_cast<int>(cudaGetLastError());
}

const char* eigh_jacobi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
