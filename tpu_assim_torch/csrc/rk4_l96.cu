// Fused multi-step RK4 forecast of the Lorenz-96 model, one launch for the
// whole ensemble and all steps.
//
// Replaces the TPU kernel tpu_assim/models/pallas_forecast.py:_rk4_kernel
// (entry fused_rk4_steps), which keeps the whole [..., g] ensemble in VMEM
// and runs every step on chip.
//
// What bounds it on an H100: neither bytes nor FLOPs. A [40, 10^4] f32
// ensemble is 1.6 MB read and written once; 4 steps of RK4 are about
// 40 * 10^4 * 4 * 4 * 10 = 6.4e7 FLOP. The time goes to latency: every RK4
// stage reads the stage input's ring neighbours, so each of the 4 stages
// of every step ends in a block-wide barrier. The design keeps all of it
// on chip: one block per ensemble row holds the row's ring in dynamic
// shared memory, so the state is read from device memory once and written
// once however many steps run.
//
// Layout per block (row r, g grid points, blockDim threads, thread t owns
// the points i = t, t + blockDim, ...):
//   shared acc[g]        running k1 + 2 k2 + 2 k3 + k4 of the current step
//   shared s_a[g], s_b[g] stage inputs, ping-ponged: a stage reads its
//                         input's neighbours from one and writes the next
//                         stage's input into the other
//   out[r, :]            the state x itself; only the owning thread reads
//                         or writes x[i], so it needs no shared copy
// Three shared rows are 120 KB at g = 10^4, above the 48 KB default, so
// the launch raises the block's dynamic shared memory limit first.
//
// The arithmetic is written with explicitly rounded intrinsics in the
// order of the plain PyTorch version (tpu_assim_torch/models/
// cuda_forecast.py:rk4_steps_plain), so the compiler contracts nothing into
// FMAs and the two agree to the last bit where PyTorch rounds the same way.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float l96_slope(const float* s, int i, int g,
                                           float forcing) {
  const int ip1 = (i + 1 == g) ? 0 : i + 1;
  const int im1 = (i == 0) ? g - 1 : i - 1;
  const int im2 = (i >= 2) ? i - 2 : i - 2 + g;
  // (x_{i+1} - x_{i-2}) x_{i-1} + (-x_i) + F
  const float adv = __fmul_rn(__fsub_rn(s[ip1], s[im2]), s[im1]);
  return __fadd_rn(__fadd_rn(adv, -s[i]), forcing);
}

__global__ void __launch_bounds__(kThreads)
rk4_l96_kernel(const float* __restrict__ in, float* __restrict__ out, int g,
               int n_steps, float h_half, float h, float h_sixth,
               float forcing) {
  extern __shared__ float smem[];
  float* acc = smem;
  float* s_in = smem + g;
  float* s_out = smem + 2 * g;
  const size_t row = static_cast<size_t>(blockIdx.x) * g;
  const float* x_in = in + row;
  float* x = out + row;

  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    const float v = x_in[i];
    x[i] = v;
    s_in[i] = v;
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    // stages 1-3: k_j = f(s), acc += w_j k_j, next stage input x + c_j k_j
    for (int stage = 0; stage < 3; ++stage) {
      const float c = (stage == 2) ? h : h_half;
      for (int i = threadIdx.x; i < g; i += blockDim.x) {
        const float k = l96_slope(s_in, i, g, forcing);
        acc[i] = (stage == 0) ? k : __fadd_rn(acc[i], __fmul_rn(2.0f, k));
        s_out[i] = __fadd_rn(x[i], __fmul_rn(c, k));
      }
      __syncthreads();
      float* t = s_in;
      s_in = s_out;
      s_out = t;
    }
    // stage 4 and the update x + dt/6 (k1 + 2 k2 + 2 k3 + k4), which is
    // also the next step's first stage input
    for (int i = threadIdx.x; i < g; i += blockDim.x) {
      const float k = l96_slope(s_in, i, g, forcing);
      const float xn = __fadd_rn(x[i], __fmul_rn(h_sixth,
                                                 __fadd_rn(acc[i], k)));
      x[i] = xn;
      s_out[i] = xn;
    }
    __syncthreads();
    float* t = s_in;
    s_in = s_out;
    s_out = t;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a row of g points.
size_t rk4_l96_smem_bytes(int g) { return 3 * static_cast<size_t>(g) * sizeof(float); }

// n_steps of RK4 for each of `rows` contiguous rows of g points; `in` and
// `out` are [rows, g] f32 on the device and must not overlap. dt and forcing
// arrive in double so that dt/2, dt/6 round to f32 once, as a Python scalar
// does when it multiplies an f32 tensor. Returns the cudaError_t of the
// launch (0 on success).
int rk4_l96_launch(const float* in, float* out, int rows, int g, int n_steps,
                   double dt, double forcing, void* stream) {
  if (rows <= 0 || g <= 0) return 0;
  const size_t smem = rk4_l96_smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      rk4_l96_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rk4_l96_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, g, n_steps, static_cast<float>(dt / 2.0),
      static_cast<float>(dt), static_cast<float>(dt / 6.0),
      static_cast<float>(forcing));
  return static_cast<int>(cudaGetLastError());
}

const char* rk4_l96_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
