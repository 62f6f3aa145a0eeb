// Batched square SVD by one-sided (Hestenes) Jacobi with Brent-Luk
// tournament ordering, one launch for a whole [B, K, K] f32 batch.
//
// Replaces the TPU kernel tpu_assim/ops/pallas/svd.py:_svd_kernel (entry
// svd_jacobi), which carries 128 matrices in the lanes of a transposed
// [K_col, K_row, 128] tile and re-seats columns with rolls because Mosaic
// has no gather. Here a block owns one matrix and a seat -> column table in
// shared memory does the re-seating, so no column ever moves.
//
// What bounded the first design on an H100: issue slots, not bytes or
// FLOPs of device memory. A [10^4, 40,
// 40] batch is 64 MB in and 128 MB out, read and written once, and its
// useful FLOPs take ~0.75 ms at the f32 rate; but a sweep is Kp - 1 = 39
// dependent rounds, and every round is a norm/dot reduction, a chain of
// exactly rounded square roots and divisions (4 and 3, each a sequence of
// instructions), then the rotation and a barrier. The first design ran one
// warp per column pair (20 warps, 640 threads a matrix): each warp issued
// five-level butterflies and the whole scalar chain for one pair, and three
// rows of its 40 left 24 of 32 lanes idle in the row pass, ~6k warp
// instructions a matrix and round (17.3 ms for the batch).
//
// This design: a team of 4 lanes per column pair, 8 pairs per warp, so one
// warp issues the scalar chain once for 8 pairs; ceil(Kp/16) warps a matrix
// (3 at Kp = 40, 96 threads), one small block per matrix, so the round's
// barrier is among that matrix's warps only and an SM holds 12 such blocks
// (36 warps) whose rounds interleave: registers bound it (56 a thread at
// K = 40 with nvcc 12.8; 39-64 over K <= 64, no spills); shared memory
// would allow 13 (15.8 KB a matrix). A team lane holds 4 consecutive rows
// of each chunk of 16 of its two columns in registers (one 16-byte load
// per chunk and column), from the dot products through the rotation; the
// reductions are two shuffle levels. The rows are padded with zeros to
// Mp = Kp rounded up to 16, and the column stride ld = Mp or Mp + 16,
// ld = 16 (mod 32), puts columns of odd distance in opposite halves of the
// banks. K <= 64: at most 4 chunks, 16 rows a lane.
//
// What bounds this design, by reckoning: each round loads and stores both
// columns of every pair of A and of V, 8 x 48 floats a pair at K = 40,
// ~31 KB a matrix and round through shared memory at 128 bytes a cycle:
// >= 240 SM cycles a matrix-round, about half of what the batch takes
// (6.9 ms). Fewer shared bytes (V's update deferred, or columns passed
// between teams by shuffles) are the next step.
//
// Layout per block:
//   shared A[Kp][ld]   the columns of A (A[j*ld + i] = A_ij), rows >= K zero;
//                      odd K gets one zero pad column
//   shared V[Kp][ld]   the accumulated rotations, column-major, from I
//   shared inv[Kp]     1/sigma per column, for the output pass
//   shared seat[2][Kp] seat -> column, ping-ponged between rounds
//
// Per round, the team of pair w takes seats (2w, 2w+1), columns p and q:
//   alpha = |a_p|^2, beta = |a_q|^2, gamma = a_p . a_q (each lane sums its
//   rows in order, then xor shuffles over the team, which leave its four
//   lanes the same bits);
//   the pair freezes (c = 1, s = 0) when |gamma| <= feps sqrt(alpha)
//   sqrt(beta) + tiny, feps = 8 eps (the TPU kernel's 8 Kp eps leaves U
//   too far from orthogonal for f32; ops/cuda/svd.py says why); else
//   tau = (beta - alpha) / (2 gamma),
//   t = sign(tau) / (|tau| + sqrt(1 + tau^2)) (t = 1 when tau == 0),
//   c = 1/sqrt(1 + t^2) with an exactly rounded square root and division
//   (an approximate reciprocal square root compounds non-orthogonality),
//   s = t c; then a_p <- c a_p - s a_q, a_q <- c a_q + s a_p, and the same
//   for V's columns. The rotation is applied even to a frozen pair, as the
//   TPU kernel does, so a NaN spreads to exactly the same entries, row by
//   row, and never leaves its matrix.
// The seats then move one step around the Brent-Luk ring (seat 0 fixed),
// which composes to the identity every Kp - 1 rounds: one sweep. A matrix
// stops after the first sweep with no live rotation, or after `sweeps`.
//
// Output: sigma_j = |a_j|, u_j = a_j / sigma_j where sigma_j > tiny, else
// a zero column, V; in seat (= column) order, row-major [B, Kp, Kp] and
// [B, Kp]. The wrapper sorts and slices.
//
// Products and sums are explicitly rounded intrinsics, so that the
// compiler contracts nothing into FMAs. The sums' order differs from the
// plain PyTorch version's (tpu_assim_torch/ops/cuda/svd.py:
// svd_jacobi_plain), so s agrees with it within rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTeam = 4;                  // lanes per column pair
constexpr int kPairsPerWarp = kWarp / kTeam;
constexpr int kChunk = 4 * kTeam;         // rows per 16-byte team load
constexpr unsigned kFull = 0xffffffffu;

// Brent-Luk re-seating: the column at seat p after a round is the one that
// sat at seat_source(p) before it.
__device__ __forceinline__ int seat_source(int p, int kp) {
  if (kp == 2 || p == 0) return p;
  if (p == 2 || p == kp - 1) return p - 1;
  return (p % 2 == 0) ? p - 2 : p + 2;
}

__host__ __device__ inline int padded_rows(int kp) {
  return (kp + kChunk - 1) / kChunk * kChunk;
}

// Column stride: the padded rows, or 16 more, so that ld = 16 (mod 32).
__host__ __device__ inline int col_stride(int kp) {
  const int mp = padded_rows(kp);
  return (mp % 32 == 16) ? mp : mp + 16;
}

__device__ __forceinline__ float team_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(kFull, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// c x - s y and c y + s x, explicitly rounded.
__device__ __forceinline__ float rot_p(float c, float s, float x, float y) {
  return __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
}
__device__ __forceinline__ float rot_q(float c, float s, float x, float y) {
  return __fadd_rn(__fmul_rn(c, y), __fmul_rn(s, x));
}
__device__ __forceinline__ void rotate(float c, float s, float4& x,
                                       float4& y) {
  const float4 x0 = x;
  x.x = rot_p(c, s, x0.x, y.x);
  x.y = rot_p(c, s, x0.y, y.y);
  x.z = rot_p(c, s, x0.z, y.z);
  x.w = rot_p(c, s, x0.w, y.w);
  y.x = rot_q(c, s, x0.x, y.x);
  y.y = rot_q(c, s, x0.y, y.y);
  y.z = rot_q(c, s, x0.z, y.z);
  y.w = rot_q(c, s, x0.w, y.w);
}

// NJ = padded rows / 16: the chunks a team lane holds per column.
template <int NJ>
__global__ void svd_jacobi_kernel(const float* __restrict__ a,
                                  float* __restrict__ u_out,
                                  float* __restrict__ s_out,
                                  float* __restrict__ v_out, int k, int kp,
                                  int sweeps, float feps, float tiny) {
  extern __shared__ __align__(16) float smem[];
  const int ld = col_stride(kp);
  float* A = smem;
  float* V = A + kp * ld;
  float* inv = V + kp * ld;
  int* seat = reinterpret_cast<int*>(inv + kp);
  const float* ab = a + static_cast<size_t>(blockIdx.x) * k * k;

  for (int e = threadIdx.x; e < kp * ld; e += blockDim.x) {
    const int j = e / ld, i = e - j * ld;
    A[e] = 0.0f;
    V[e] = (i == j) ? 1.0f : 0.0f;
  }
  if (threadIdx.x < kp) seat[threadIdx.x] = threadIdx.x;
  __syncthreads();
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) {  // coalesced reads
    const int i = e / k, j = e - i * k;
    A[j * ld + i] = ab[e];
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int pair = (threadIdx.x / kWarp) * kPairsPerWarp + lane / kTeam;
  const bool active = pair < kp / 2;
  const int row0 = (lane % kTeam) * 4;  // first of this lane's rows a chunk
  int* cur = seat;
  int* nxt = seat + kp;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    int live_any = 0;
    for (int r = 0; r < kp - 1; ++r) {
      // nobody reads nxt or writes cur during the round
      if (threadIdx.x < kp)
        nxt[threadIdx.x] = cur[seat_source(threadIdx.x, kp)];
      const int cp = active ? cur[2 * pair] : 0;
      const int cq = active ? cur[2 * pair + 1] : 0;
      float* ap = A + cp * ld + row0;
      float* aq = A + cq * ld + row0;
      float4 x[NJ], y[NJ];
      float alp = 0.0f, bet = 0.0f, gam = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        x[j] = ld4(ap + j * kChunk);
        y[j] = ld4(aq + j * kChunk);
        const float xs[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
        const float ys[4] = {y[j].x, y[j].y, y[j].z, y[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          alp = __fadd_rn(alp, __fmul_rn(xs[e], xs[e]));
          bet = __fadd_rn(bet, __fmul_rn(ys[e], ys[e]));
          gam = __fadd_rn(gam, __fmul_rn(xs[e], ys[e]));
        }
      }
      alp = team_sum(alp);
      bet = team_sum(bet);
      gam = team_sum(gam);
      const float tol = __fadd_rn(
          __fmul_rn(feps, __fmul_rn(__fsqrt_rn(alp), __fsqrt_rn(bet))), tiny);
      const bool live = active && fabsf(gam) > tol;  // false for a NaN gamma
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
      if (active) {
        float* vp = V + (ap - A);
        float* vq = V + (aq - A);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          rotate(c, s, x[j], y[j]);
          st4(ap + j * kChunk, x[j]);
          st4(aq + j * kChunk, y[j]);
          float4 vx = ld4(vp + j * kChunk), vy = ld4(vq + j * kChunk);
          rotate(c, s, vx, vy);
          st4(vp + j * kChunk, vx);
          st4(vq + j * kChunk, vy);
        }
      }
      __syncthreads();
      int* t = cur;
      cur = nxt;
      nxt = t;
    }
    if (!__syncthreads_or(live_any)) break;
  }

  // whole sweeps re-seat to the identity: column j sits at A + j*ld; a
  // team per column
  float* sb = s_out + static_cast<size_t>(blockIdx.x) * kp;
  const int teams = blockDim.x / kTeam;
  for (int j0 = 0; j0 < kp; j0 += teams) {
    const int j = j0 + threadIdx.x / kTeam;
    const float* col = A + (j < kp ? j : 0) * ld + row0;
    float nrm2 = 0.0f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const float4 x = ld4(col + c * kChunk);
      nrm2 = __fadd_rn(nrm2, __fmul_rn(x.x, x.x));
      nrm2 = __fadd_rn(nrm2, __fmul_rn(x.y, x.y));
      nrm2 = __fadd_rn(nrm2, __fmul_rn(x.z, x.z));
      nrm2 = __fadd_rn(nrm2, __fmul_rn(x.w, x.w));
    }
    const float sig = __fsqrt_rn(team_sum(nrm2));
    if (j < kp && lane % kTeam == 0) {
      sb[j] = sig;
      inv[j] = sig > tiny ? __fdiv_rn(1.0f, fmaxf(sig, tiny)) : 0.0f;
    }
  }
  __syncthreads();
  const int nn = kp * kp;
  float* ub = u_out + static_cast<size_t>(blockIdx.x) * nn;
  float* vb = v_out + static_cast<size_t>(blockIdx.x) * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / kp, j = e - i * kp;
    ub[e] = __fmul_rn(A[j * ld + i], inv[j]);
    vb[e] = V[j * ld + i];
  }
}

template <int NJ>
cudaError_t launch(const float* a, float* u, float* s, float* v, int batch,
                   int k, int kp, int threads, size_t smem, int sweeps,
                   float feps, float tiny, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      svd_jacobi_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  svd_jacobi_kernel<NJ><<<batch, threads, smem, st>>>(a, u, s, v, k, kp,
                                                      sweeps, feps, tiny);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads of one block: a warp per 8 column pairs.
int svd_jacobi_threads(int kp) {
  return (kp / 2 + kPairsPerWarp - 1) / kPairsPerWarp * kWarp;
}

// Shared memory one block needs for a Kp x Kp matrix.
size_t svd_jacobi_smem_bytes(int kp) {
  return (2 * static_cast<size_t>(kp) * col_stride(kp) + kp) * sizeof(float) +
         2 * static_cast<size_t>(kp) * sizeof(int);
}

// SVD of `batch` contiguous row-major K x K f32 matrices `a` (K <= 64);
// writes u [batch, Kp, Kp], s [batch, Kp], v [batch, Kp, Kp] (Kp = K +
// K % 2), columns in seat order, unsorted. Returns the cudaError_t of the
// launch (0 on success).
int svd_jacobi_launch(const float* a, float* u, float* s, float* v,
                      int batch, int k, int sweeps, float feps, float tiny,
                      void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  const int kp = k + (k % 2);
  const int threads = svd_jacobi_threads(kp);
  const size_t smem = svd_jacobi_smem_bytes(kp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (padded_rows(kp) / kChunk) {
    case 1: err = launch<1>(a, u, s, v, batch, k, kp, threads, smem, sweeps,
                            feps, tiny, st); break;
    case 2: err = launch<2>(a, u, s, v, batch, k, kp, threads, smem, sweeps,
                            feps, tiny, st); break;
    case 3: err = launch<3>(a, u, s, v, batch, k, kp, threads, smem, sweeps,
                            feps, tiny, st); break;
    case 4: err = launch<4>(a, u, s, v, batch, k, kp, threads, smem, sweeps,
                            feps, tiny, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* svd_jacobi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
