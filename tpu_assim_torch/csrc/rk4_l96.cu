// Fused multi-step RK4 forecast of the Lorenz-96 model: every member and
// up to MAX_STEPS steps in one launch.
//
// Replaces the TPU kernel tpu_assim/models/pallas_forecast.py:_rk4_kernel
// (entry fused_rk4_steps), which keeps the whole [..., g] ensemble in VMEM
// and runs every step on chip.
//
// What bounds it on an H100: bytes, by the published rates. A [40, 10^4]
// f32 ensemble is 1.6 MB read and 1.6 MB written once; 4 steps of RK4 are
// about 40 * 10^4 * 4 * 31 = 5e7 FLOP. What stood in the way of that bound
// was latency and shared-memory bandwidth: one block a row kept the row's
// ring in shared memory and passed a block-wide barrier every stage, so
// only `rows` SMs worked.
//
// Design: temporal blocking with a recomputed halo, so that no two warps
// ever exchange data. A stage at point i reads points i-2, i-1, i and i+1
// of its input, so after s RK4 steps (4 stages each) a point depends on the
// 8 s points to its left and the 4 s to its right. One warp owns a tile of
// T = 32 P consecutive ring points of one row, lane l the P points
// l P .. l P + P - 1, in registers: the state x, the running slope sum acc
// and the stage input s. Per stage a lane takes its left neighbour's last
// two stage inputs and its right neighbour's first by three shuffles. The
// values that enter a tile through lanes 0 and 31 are wrong (each takes its
// own); they spoil 2 points on the left and 1 on the right a stage, so a
// tile loads `left` >= 8 s points before the `stride` points it writes and
// at least 4 s after them (the wrapper's rk4_plan). The grid is rows x
// ceil(g / stride) warps, blocks of kWarps warps; nothing is shared between
// warps. Loads and stores go through a warp-private staging row of T floats
// in shared memory: lane-strided (coalesced) in device memory, P
// consecutive points a lane in registers. A row of g points need not be
// 16-byte aligned, so device memory is read and written a float at a time.
// Any g >= 1 works: a tile reads ring index (t0 - left + j) mod g, so a
// tile longer than the ring holds duplicates, which are recomputed to the
// same bits.
//
// The arithmetic is written with explicitly rounded intrinsics in the
// order of the plain PyTorch version (tpu_assim_torch/models/
// cuda_forecast.py:rk4_steps_plain), so the compiler contracts nothing
// into FMAs; every point gets the same bits whichever tile computes it,
// and the kernel agrees with its plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kP = 8;            // points a lane
constexpr int kWarps = 4;        // warps a block
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* in;
  float* out;
  long long warps;   // rows * tiles
  int g;             // points a row
  int tiles;         // tiles (warps) a row
  int left;          // tile points before the first one written
  int stride;        // points a tile writes
  int n_steps;       // RK4 steps of this launch; 8 n_steps <= left
  float h_half, h, h_sixth, forcing;
};

// (x_{i+1} - x_{i-2}) x_{i-1} + (-x_i) + F, as Lorenz96.__call__ rounds it
__device__ __forceinline__ float l96(float m2, float m1, float x0, float p1,
                                     float forcing) {
  const float adv = __fmul_rn(__fsub_rn(p1, m2), m1);
  return __fadd_rn(__fadd_rn(adv, -x0), forcing);
}

// The slopes k of a lane's P points of the stage input s.
template <int P>
__device__ __forceinline__ void slopes(const float (&s)[P], float (&k)[P],
                                       float forcing) {
  const float l2 = __shfl_up_sync(kFull, s[P - 2], 1);
  const float l1 = __shfl_up_sync(kFull, s[P - 1], 1);
  const float r1 = __shfl_down_sync(kFull, s[0], 1);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float m2 = p >= 2 ? s[p - 2] : (p == 1 ? l1 : l2);
    const float m1 = p >= 1 ? s[p - 1] : l1;
    const float p1 = p + 1 < P ? s[p + 1] : r1;
    k[p] = l96(m2, m1, s[p], p1, forcing);
  }
}

template <int P>
__global__ void __launch_bounds__(kWarps * 32)
rk4_l96_kernel(Params prm) {
  static_assert(P >= 2 && P % 4 == 0, "P points a lane, whole float4s");
  constexpr int T = 32 * P;
  __shared__ __align__(16) float staging[kWarps][T];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + wib;
  if (warp >= prm.warps) return;  // the whole warp leaves
  const long long row = warp / prm.tiles;
  const int tile = static_cast<int>(warp - row * prm.tiles);
  const unsigned g = static_cast<unsigned>(prm.g);
  const float* xin = prm.in + row * prm.g;
  float* xout = prm.out + row * prm.g;
  const long long t0 = static_cast<long long>(tile) * prm.stride;
  // ring index of the tile's first point: (t0 - left) mod g, in [0, g)
  const unsigned base = static_cast<unsigned>(
      ((t0 - prm.left) % prm.g + prm.g) % prm.g);
  float* buf = staging[wib];

#pragma unroll
  for (int q = 0; q < P; ++q) {
    const unsigned j = lane + 32 * q;
    buf[j] = xin[(base + j) % g];
  }
  __syncwarp();
  float x[P], acc[P], s[P], k[P];
#pragma unroll
  for (int v = 0; v < P / 4; ++v) {
    const float4 f = reinterpret_cast<const float4*>(buf + lane * P)[v];
    x[4 * v] = f.x;
    x[4 * v + 1] = f.y;
    x[4 * v + 2] = f.z;
    x[4 * v + 3] = f.w;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) s[p] = x[p];

  for (int step = 0; step < prm.n_steps; ++step) {
    // stages 1-3: k_j = f(s), acc += w_j k_j, next stage input x + c_j k_j
    slopes(s, k, prm.forcing);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[p] = k[p];
      s[p] = __fadd_rn(x[p], __fmul_rn(prm.h_half, k[p]));
    }
    slopes(s, k, prm.forcing);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[p] = __fadd_rn(acc[p], __fmul_rn(2.0f, k[p]));
      s[p] = __fadd_rn(x[p], __fmul_rn(prm.h_half, k[p]));
    }
    slopes(s, k, prm.forcing);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      acc[p] = __fadd_rn(acc[p], __fmul_rn(2.0f, k[p]));
      s[p] = __fadd_rn(x[p], __fmul_rn(prm.h, k[p]));
    }
    // stage 4 and the update x + dt/6 (k1 + 2 k2 + 2 k3 + k4), which is
    // also the next step's first stage input
    slopes(s, k, prm.forcing);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      x[p] = __fadd_rn(x[p], __fmul_rn(prm.h_sixth, __fadd_rn(acc[p], k[p])));
      s[p] = x[p];
    }
  }

  __syncwarp();  // every lane has read its points before any is overwritten
#pragma unroll
  for (int v = 0; v < P / 4; ++v) {
    reinterpret_cast<float4*>(buf + lane * P)[v] =
        make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int j = lane + 32 * q;
    if (j < prm.stride && t0 + j < prm.g) xout[t0 + j] = buf[prm.left + j];
  }
}

}  // namespace

extern "C" {

// Points a warp's tile holds (32 P); the wrapper's plan must agree.
int rk4_l96_tile_points() { return 32 * kP; }

// n_steps of RK4 for each of `rows` contiguous rows of g points, tiled as
// rk4_plan says: `tiles` warps a row, each writing `stride` points after
// `left` halo points (left >= 8 n_steps, left + stride + 4 n_steps <= 32 P,
// tiles * stride >= g). `in` and `out` are [rows, g] f32 on the device and
// must not overlap. dt and forcing arrive in double so that dt/2, dt/6
// round to f32 once, as a Python scalar does when it multiplies an f32
// tensor. Returns the cudaError_t of the launch (0 on success).
int rk4_l96_launch(const float* in, float* out, int rows, int g, int tiles,
                   int left, int stride, int n_steps, double dt,
                   double forcing, void* stream) {
  if (rows <= 0 || g <= 0) return 0;
  Params prm;
  prm.in = in;
  prm.out = out;
  prm.warps = static_cast<long long>(rows) * tiles;
  prm.g = g;
  prm.tiles = tiles;
  prm.left = left;
  prm.stride = stride;
  prm.n_steps = n_steps;
  prm.h_half = static_cast<float>(dt / 2.0);
  prm.h = static_cast<float>(dt);
  prm.h_sixth = static_cast<float>(dt / 6.0);
  prm.forcing = static_cast<float>(forcing);
  const long long blocks = (prm.warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rk4_l96_kernel<kP><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

const char* rk4_l96_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
