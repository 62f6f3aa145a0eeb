// Batched symmetric eigendecomposition by two-sided cyclic Jacobi with
// Brent-Luk tournament ordering, one launch for a whole [B, Kp, Kp] f32
// batch (Kp even; the wrapper pads odd K with one decoupled seat).
//
// Replaces the TPU kernel tpu_assim/ops/pallas/jacobi.py:_jacobi_kernel
// (entry eigh_jacobi), which carries 128 matrices in the lanes of a
// [K, K, 128] tile and re-seats rows and columns with rolls and a (K/2, 2)
// split, because Mosaic has no gather. Here a warp owns one matrix, and
// each lane holds the rows of one seat pair, so no row or column of A
// ever moves.
//
// Bytes and FLOPs bound neither design on an H100: a [10^4, 40, 40] batch
// is 64 MB in and 64 MB out, and 7 sweeps are 2.6e10 FLOP (A symmetric;
// 0.38 ms at the f32 rate), but a sweep is Kp - 1 dependent rounds. The
// first design (a block of 256 threads a matrix) ran three passes a round,
// each closed by a block barrier, with seven warps idle through the pair
// chain and A through shared memory twice a round: 9.5 ms for that batch.
//
// This design: one warp a matrix, Kp a template argument (no runtime
// division), one block of 32 threads per matrix, so a round's
// synchronisation is two __syncwarp of that matrix alone. Lane l < Kp/2
// holds seat pair l: its rows p (even seat) and q in registers, and it
// computes that pair's rotation (c, s) itself and publishes (p ld, q ld,
// c, s) as one float4 in a pair table in shared memory. The seats move by
// three shuffles (Brent-Luk: each lane takes its rows from its neighbours).
// A round's rotation J is block-diagonal over the pairs, so J^T A J is
// computed one 2 x 2 block at a time: lane j (column pair p_j, q_j) walks
// the row pairs i, loads rows (p_i, q_i) x columns (p_j, q_j), rotates its
// two rows by (c_i, s_i), then its two columns by (c_j, s_j), in registers,
// and stores them. Every element goes through the operations, in the order,
// of a row pass followed by a column pass, and A crosses shared memory once
// a round. Both triangles of A are kept, so that the rounding is the plain
// version's. V^T's rows are rotated in the same walk: lane m holds column m
// of V^T in registers, one per seat, rotated with the (c_i, s_i) that the
// walk loaded anyway and re-seated by register moves (whole sweeps leave
// every row at its own seat, so the registers are in index order at the
// exit). Columns 32.. of V^T (32 < Kp <= 42) ride in A's rows as extra
// columns, each the first column of an idle lane's (l >= Kp/2) block
// column pair, the second being a column of zeros; with that lane's
// rotation (1, 0), x - 0 * 0 and 0 + 0 * x are exact, so the walk needs no
// branch. Above 42 a lane holds a second V^T column in registers. Rows of A
// have an odd stride ld, so a column walk hits 32 distinct banks. Shared
// memory holds A and the pair table: 8.2 KB a matrix at Kp = 40.
//
// What bounds this design, by reckoning at Kp = 40: issue slots. Only 20 of
// 32 lanes have a column pair of A (4 carry V^T columns, 8 the zero column),
// and a round issues ~20 x 37 warp instructions for the blocks (one
// broadcast float4 load, 4 loads, 24 rounded multiplies and adds, 4 stores,
// 4 address sums each), ~160 for V^T's registers (the rotations and 40
// moves to re-seat) and ~100 for the pair chain and the shuffles: ~1k warp
// instructions a matrix and round, ~250 SM cycles at 4 issued a cycle.
// Shared memory sees ~190 accesses a matrix and round, some 2-way conflicts
// where two even-seat rows differ by 32. Registers bound the matrices in
// flight (~88 a lane at Kp = 40: 23 warps an SM). Fewer instructions per
// element need a lane for every column pair (Kp/2 = 32) or half the
// elements: A's upper triangle alone, which rounds otherwise (ROADMAP).
//
// Per round, the lane of pair (2i, 2i+1), rows p and q:
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
// Rows p, q, then columns p, q:  x_p <- c x_p - s x_q,  x_q <- c x_q + s x_p.
// The seats then move one step around the ring (seat 0 fixed), which
// composes to the identity every Kp - 1 rounds: one sweep. Before each
// sweep a matrix stops once every off-diagonal |a_ij| <= feps (|a_ii| +
// |a_jj|) + tiny, or after `sweeps` sweeps; `run` gets the sweeps it ran
// (sweeps + 1 if the cap stopped it while still rotating).
//
// Output: evals [B, Kp] = diag(A), vecs [B, Kp, Kp] = V, row-major, in
// index order, unsorted. The wrapper sorts and slices.
//
// Products and sums are explicitly rounded intrinsics in the order of the
// plain PyTorch version (tpu_assim_torch/ops/cuda/jacobi.py:
// eigh_jacobi_plain), so that the compiler contracts nothing into FMAs and
// the kernel agrees with it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Brent-Luk re-seating: the row at seat s after a round is the one that
// sat at seat_source(s) before it.
template <int KP>
__device__ constexpr int seat_source(int s) {
  return (KP == 2 || s == 0)            ? s
         : (s == 2 || s == KP - 1)      ? s - 1
         : (s % 2 == 0)                 ? s - 2
                                        : s + 2;
}

// V^T columns 32.. that ride in the rows of A, as extra columns, for 32 <
// Kp <= 42: each lane past Kp/2, idle in the update of A, takes one of them
// as the first column of its block's column pair, the second being the zero
// column. Above 42 too few lanes are idle, and a lane holds a second V^T
// column in registers instead.
__host__ __device__ constexpr int extra_columns(int kp) {
  return (kp > kWarp && kp - kWarp <= kWarp - kp / 2) ? kp - kWarp : 0;
}

// The row stride of A: its Kp columns, the extra V^T columns and the zero
// column, odd.
__host__ __device__ constexpr int row_stride(int kp) {
  return (kp + extra_columns(kp)) | 1;
}

// x <- c x - s y, y <- c y + s x, every product and sum rounded on its own.
__device__ __forceinline__ void rotate(float c, float s, float& x, float& y) {
  const float nx = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
  y = __fadd_rn(__fmul_rn(c, y), __fmul_rn(s, x));
  x = nx;
}

// The rotation (c, s) of the pair on rows p (even seat) and q, the even
// seat's sine; (1, 0) where the pair is frozen.
template <int LD>
__device__ __forceinline__ float2 pair_rotation(const float* A, int p, int q,
                                                float feps, float tiny) {
  const float dp = A[p * LD + p], dq = A[q * LD + q];
  const float o = __fmul_rn(0.5f, __fadd_rn(A[p * LD + q], A[q * LD + p]));
  const float o_safe = fabsf(o) > tiny ? o : 1.0f;
  const float tau = __fdiv_rn(__fsub_rn(dq, dp), __fmul_rn(2.0f, o_safe));
  float t = 1.0f;  // tau == 0: 45 degrees, +1 at the even seat
  if (tau != 0.0f) {
    const float sq = __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(tau, tau)));
    t = __fdiv_rn(copysignf(1.0f, tau), __fadd_rn(fabsf(tau), sq));
  }
  const float c = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t))));
  const float tol =
      __fadd_rn(__fmul_rn(feps, __fadd_rn(fabsf(dp), fabsf(dq))), tiny);
  const bool live = fabsf(o) > tol;  // false for a NaN
  return make_float2(live ? c : 1.0f, live ? __fmul_rn(t, c) : 0.0f);
}

// Whether any off-diagonal entry of A is above its pair's freeze
// threshold; every lane of the warp gets the answer.
template <int KP>
__device__ bool any_unfrozen(const float* A, float feps, float tiny) {
  constexpr int LD = row_stride(KP);
  bool unfrozen = false;
  for (int e = threadIdx.x; e < KP * KP; e += kWarp) {
    const int i = e / KP, j = e % KP;
    if (i == j) continue;
    const float tol = __fadd_rn(
        __fmul_rn(feps, __fadd_rn(fabsf(A[i * LD + i]), fabsf(A[j * LD + j]))),
        tiny);
    unfrozen |= fabsf(A[i * LD + j]) > tol;  // false for a NaN
  }
  return __any_sync(kFull, unfrozen) != 0;
}

template <int KP>
__global__ void __launch_bounds__(kWarp)
eigh_jacobi_kernel(const float* __restrict__ a, float* __restrict__ evals,
                   float* __restrict__ vecs, int* __restrict__ run,
                   int sweeps, float feps, float tiny) {
  constexpr int H = KP / 2;                      // seat pairs, one a lane
  constexpr int XV = extra_columns(KP);          // V^T columns in A's rows
  constexpr int LD = row_stride(KP);
  constexpr int NV = (KP > kWarp && XV == 0) ? 2 : 1;  // in registers
  constexpr size_t nn = static_cast<size_t>(KP) * KP;
  extern __shared__ float4 smem[];
  float4* pairs = smem;  // [H] (p LD, q LD as int bits, c, s)
  float* A = reinterpret_cast<float*>(smem + H);  // A[i * LD + j] = A_ij
  const int lane = threadIdx.x;

  const float* ab = a + blockIdx.x * nn;
  for (int e = lane; e < KP * LD; e += kWarp) {
    const int i = e / LD, j = e % LD;  // column KP + w: V^T column 32 + w
    A[e] = j < KP ? ab[i * KP + j] : (j - KP == i - kWarp ? 1.0f : 0.0f);
  }
  // v[u][s] = V^T at (the row at seat s, column lane + 32 u), from I
  float v[NV][KP];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
#pragma unroll
    for (int s = 0; s < KP; ++s) v[u][s] = (s == lane + kWarp * u) ? 1.0f : 0.0f;
  }
  int p = 2 * lane, q = 2 * lane + 1;  // lane < H: the rows at its seats
  // The column pair of a lane past H: an extra V^T column, or the zero
  // column, then the zero column. Its rotation is (1, 0), and with a zero
  // partner x - 0 * 0 and 0 + 0 * x are exact: V^T's columns get their row
  // rotations alone, and the zero column stays +0 (c, s and V^T are finite).
  const int w = lane - H;
  const int xp = w < XV ? KP + w : KP + XV;
  const int xq = KP + XV;
  __syncwarp();

  int sweep = 0;
  for (; sweep < sweeps; ++sweep) {
    if (!any_unfrozen<KP>(A, feps, tiny)) break;
    for (int r = 0; r < KP - 1; ++r) {
      float c = 1.0f, s = 0.0f;
      if (lane < H) {
        const float2 cs = pair_rotation<LD>(A, p, q, feps, tiny);
        c = cs.x;
        s = cs.y;
        pairs[lane] = make_float4(__int_as_float(p * LD),
                                  __int_as_float(q * LD), c, s);
      }
      __syncwarp();
      // J^T A J by 2 x 2 blocks: row pair i, this lane's column pair; and
      // V^T's rows at seats 2i, 2i + 1
      float* colp = A + (lane < H ? p : xp);
      float* colq = A + (lane < H ? q : xq);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float4 ri = pairs[i];  // the same address for every lane
        const int pi = __float_as_int(ri.x), qi = __float_as_int(ri.y);
        float x00 = colp[pi], x01 = colq[pi];
        float x10 = colp[qi], x11 = colq[qi];
        rotate(ri.z, ri.w, x00, x10);  // rows p_i, q_i
        rotate(ri.z, ri.w, x01, x11);
        rotate(c, s, x00, x01);        // columns p_j, q_j
        rotate(c, s, x10, x11);
        colp[pi] = x00;
        colq[pi] = x01;
        colp[qi] = x10;
        colq[qi] = x11;
#pragma unroll
        for (int u = 0; u < NV; ++u) rotate(ri.z, ri.w, v[u][2 * i], v[u][2 * i + 1]);
      }
      __syncwarp();
      if constexpr (KP > 2) {
        // Brent-Luk: seat 2l takes seat 2l - 2's row (seat 2 seat 1's),
        // seat 2l + 1 seat 2l + 3's (the last seat Kp - 2's)
        const int p_left = __shfl_up_sync(kFull, p, 1);
        const int q_first = __shfl_sync(kFull, q, 0);
        const int q_right = __shfl_down_sync(kFull, q, 1);
        const int np = lane == 0 ? p : (lane == 1 ? q_first : p_left);
        q = lane == H - 1 ? p : q_right;
        p = np;
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          float old[KP];
#pragma unroll
          for (int t = 0; t < KP; ++t) old[t] = v[u][t];
#pragma unroll
          for (int t = 0; t < KP; ++t) v[u][t] = old[seat_source<KP>(t)];
        }
      }
    }
  }
  // a cap that stopped a matrix still rotating counts one sweep more
  const bool capped = sweep == sweeps && any_unfrozen<KP>(A, feps, tiny);
  if (lane == 0) run[blockIdx.x] = capped ? sweeps + 1 : sweep;

  float* eb = evals + static_cast<size_t>(blockIdx.x) * KP;
  for (int i = lane; i < KP; i += kWarp) eb[i] = A[i * LD + i];
  // V_ms = V^T_sm (whole sweeps left row s at seat s): rows 32.. of V from
  // the extra columns, the rest from registers through A's space, so that
  // the stores to vecs coalesce
  float* vb = vecs + blockIdx.x * nn;
  for (int e = lane; e < XV * KP; e += kWarp) {
    const int m = e / KP, t = e % KP;
    vb[(kWarp + m) * KP + t] = A[t * LD + KP + m];
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int m = lane + kWarp * u;
    if (m < KP) {
#pragma unroll
      for (int t = 0; t < KP; ++t) A[m * LD + t] = v[u][t];
    }
  }
  __syncwarp();
  constexpr int kRegRows = KP < kWarp * NV ? KP : kWarp * NV;
  for (int e = lane; e < kRegRows * KP; e += kWarp)
    vb[e] = A[(e / KP) * LD + e % KP];
}

template <int KP>
cudaError_t launch(const float* a, float* evals, float* vecs, int* run,
                   int batch, int sweeps, float feps, float tiny, size_t smem,
                   cudaStream_t stream) {
  // as much of the SM for shared memory as it offers: a matrix is a block
  cudaError_t err = cudaFuncSetAttribute(
      eigh_jacobi_kernel<KP>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  eigh_jacobi_kernel<KP><<<batch, kWarp, smem, stream>>>(a, evals, vecs, run,
                                                         sweeps, feps, tiny);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads of one block: one warp, one matrix.
int eigh_jacobi_threads(int kp) { return kWarp; }

// Shared memory one block needs for a Kp x Kp matrix: the pair table and
// A's rows (with the extra V^T columns and the zero column) at the odd
// stride.
size_t eigh_jacobi_smem_bytes(int kp) {
  return static_cast<size_t>(kp / 2) * sizeof(float4) +
         static_cast<size_t>(kp) * row_stride(kp) * sizeof(float);
}

// Eigendecomposition of `batch` contiguous row-major Kp x Kp symmetric f32
// matrices `a` (Kp even, <= 64); writes evals [batch, Kp], vecs [batch,
// Kp, Kp] (eigenvector columns, unsorted) and run [batch] (sweeps run).
// Returns the cudaError_t of the launch (0 on success).
int eigh_jacobi_launch(const float* a, float* evals, float* vecs, int* run,
                       int batch, int kp, int sweeps, float feps, float tiny,
                       void* stream) {
  if (batch <= 0 || kp <= 0) return 0;
  const size_t smem = eigh_jacobi_smem_bytes(kp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kp) {
#define K7_CASE(KP)                                                        \
  case KP:                                                                 \
    err = launch<KP>(a, evals, vecs, run, batch, sweeps, feps, tiny, smem, \
                     st);                                                  \
    break;
    K7_CASE(2) K7_CASE(4) K7_CASE(6) K7_CASE(8) K7_CASE(10) K7_CASE(12)
    K7_CASE(14) K7_CASE(16) K7_CASE(18) K7_CASE(20) K7_CASE(22) K7_CASE(24)
    K7_CASE(26) K7_CASE(28) K7_CASE(30) K7_CASE(32) K7_CASE(34) K7_CASE(36)
    K7_CASE(38) K7_CASE(40) K7_CASE(42) K7_CASE(44) K7_CASE(46) K7_CASE(48)
    K7_CASE(50) K7_CASE(52) K7_CASE(54) K7_CASE(56) K7_CASE(58) K7_CASE(60)
    K7_CASE(62) K7_CASE(64)
#undef K7_CASE
    default:
      err = cudaErrorInvalidValue;  // odd or above 64
  }
  return static_cast<int>(err);
}

const char* eigh_jacobi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
