// The per-column Chebyshev/Clenshaw solve and weight application of the 2-D
// window kernel (letkf_window2d.cu, K6) on its register route: the same
// arithmetic as cheb_core.cuh (the shared route), with the Gram matrix
// S held in registers. It is the port of _cheb_solve_apply in
// tpu_assim/ops/pallas/letkf.py, and its plain PyTorch twin is
// tpu_assim_torch/ops/cuda/letkf.py:_cheb_solve_apply.
//
// What bounds the shared-memory solve on an H100 (cheb_core.cuh, one warp
// per column): shared loads. Each lane computes whole entries of S at one
// FMA per two shared loads, and the Clenshaw mat-vec reads S and v from
// shared memory for every FMA; at bench config 8 (nb 52, k 40, degree 16)
// that is ~15k shared-load instructions per column against ~6k FMA
// instructions, and S (nb^2 floats) fills half of a column's 22 KB of
// workspace, so an SM holds 8 warps.
//
// This solve: the caller hands it a column's observations of nonzero
// weight, m of them, compacted in the order of their window slots, and
// picks NBC, m rounded up to 8 (at least 8), per column. Lane l owns rows
// l and l + 32 of S (m <= 64), as NBC registers each (the pad entries
// zero). The perturbations lie transposed in shared memory, zt[k][NBC +
// 4], so that
//  - the Gram step reads its own rows' entries zt[kk][l] (consecutive
//    lanes, consecutive banks) and every column as 16-byte broadcasts of
//    zt[kk][m..m+3]: 8 FMAs per shared load (4 at one row a lane);
//  - the Clenshaw mat-vec reads v = b1[op] by 16-byte broadcasts and S
//    never: 8 FMAs per shared load, a lane of one row (NBC <= 32) taking
//    two operands at once, so that each lane runs two chains;
//  - the apply's 16-byte loads of rows zt[kk], consecutive lanes on
//    consecutive kk, meet no bank conflict at the stride of NBC + 4 (up
//    to 8-way at a stride of NBC).
// Both triangles of S are computed (NBC^2 k FMAs against NBC(NBC+1)k/2):
// the mat-vec needs every row whole in its lane, and folding the triangle
// would take S through shared memory again. S's entries are the same
// products summed in the same order (kk = 0..k-1) as in cheb_core.cuh, the
// mat-vec's in the order m = 0..NBC-1, and the apply's n = 0..NBC-1; the
// zero pad adds exact zeros. So a window whose zero-weight slots are left
// out gives the sums of the whole window to the bit: a zero-weight slot
// adds only zeros to each of them. The one sum whose terms would change
// lanes is the trace; it is summed by window slot (w.slot, w.diag), lane
// l adding slots l and l + 32, as the whole window sums it. A column's
// workspace is ~12.3 KB at NBC 56 and k 40, so registers, not shared
// memory, bound the warps per SM (letkf_window2d.cu says how many).
//
// The caller fills slot (the window slot of each of the m rows), zeroes
// diag, fills zt (pad columns zero), spc, meanc and row 0 of w_all, then
// calls solve_apply<NBC> with nb = m, which leaves the column's analysis
// [ns][k] in spc.

#pragma once

#include <cuda_runtime.h>

#include "cheb_core.cuh"

namespace cheb_reg {

using cheb::nan_max;
using cheb::nan_min;

// Largest window of the register route.
constexpr int kMaxNb = 64;

// The register row length of a window of nb: nb rounded up to 8.
__host__ __device__ inline int padded_nb(int nb) { return (nb + 7) & ~7; }

// Row stride of zt at width nbc: 4 more than nbc, an odd multiple of 4
// for every nbc a multiple of 8, so that 16-byte loads of consecutive rows
// by consecutive lanes meet no bank conflict.
__host__ __device__ inline int zt_ld(int nbc) { return nbc + 4; }

// Floats of one column's workspace at width nbc, a multiple of 4.
__host__ __device__ inline int workspace_floats(int k, int nbc, int ns,
                                                int degree) {
  const int n_ent = (1 + ns) * nbc;
  const int floats = 2 * kMaxNb + k * zt_ld(nbc) + 4 * n_ent + ns * k +
                     ns + 4 * (degree + 1);
  return (floats + 3) & ~3;
}

struct Workspace {
  int* slot;     // [kMaxNb] the window slot of each row (in)
  float* diag;   // [kMaxNb] S's diagonal by window slot (zero, in)
  float* zt;     // [k][zt_ld(nbc)] scaled perturbations, transposed (in)
  float* w_all;  // [1 + ns][nbc]: yh (in), then u_i = zh sp_i
  float* b0;     // three Clenshaw buffers of [1 + ns][nbc]
  float* b1;
  float* b2;
  float* spc;    // [ns][k] state perturbations (in), the analysis (out)
  float* meanc;  // [ns] state mean (in)
  float* c1;     // [d + 1] coefficients of 1/x
  float* c2;     // [d + 1] of 1/(sqrt(x)(1 + sqrt(x)))
  float* f1x;    // [d + 1] node values
  float* f2x;
};

// The [kMaxNb] and [nbc]-row arrays come first, so each starts 16-byte
// aligned; slot and diag lie where they lie at every width.
__device__ __forceinline__ Workspace carve(float* base, int k, int nbc,
                                           int ns, int degree) {
  const int n_ent = (1 + ns) * nbc, dp1 = degree + 1;
  Workspace w;
  w.slot = reinterpret_cast<int*>(base);
  w.diag = base + kMaxNb;
  w.zt = w.diag + kMaxNb;
  w.w_all = w.zt + k * zt_ld(nbc);
  w.b0 = w.w_all + n_ent;
  w.b1 = w.b0 + n_ent;
  w.b2 = w.b1 + n_ent;
  w.spc = w.b2 + n_ent;
  w.meanc = w.spc + ns * k;
  w.c1 = w.meanc + ns;
  w.c2 = w.c1 + dp1;
  w.f1x = w.c2 + dp1;
  w.f2x = w.f1x + dp1;
  return w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// sv[r] = sum_m s[r][m] v[m], m = 0..NBC-1 in order, v by broadcasts.
template <int NBC, int R>
__device__ __forceinline__ void matvec(const float (&s)[R][NBC],
                                       const float* v, float (&sv)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) sv[r] = 0.0f;
#pragma unroll
  for (int m = 0; m < NBC; m += 4) {
    const float4 x = ld4(v + m);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sv[r] = fmaf(s[r][m], x.x, sv[r]);
      sv[r] = fmaf(s[r][m + 1], x.y, sv[r]);
      sv[r] = fmaf(s[r][m + 2], x.z, sv[r]);
      sv[r] = fmaf(s[r][m + 3], x.w, sv[r]);
    }
  }
}

// matvec for two operands at once: two independent chains a row, each
// summed as matvec sums it.
template <int NBC, int R>
__device__ __forceinline__ void matvec2(const float (&s)[R][NBC],
                                        const float* v0, const float* v1,
                                        float (&sv0)[R], float (&sv1)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sv0[r] = 0.0f;
    sv1[r] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < NBC; m += 4) {
    const float4 x = ld4(v0 + m);
    const float4 y = ld4(v1 + m);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sv0[r] = fmaf(s[r][m], x.x, sv0[r]);
      sv1[r] = fmaf(s[r][m], y.x, sv1[r]);
      sv0[r] = fmaf(s[r][m + 1], x.y, sv0[r]);
      sv1[r] = fmaf(s[r][m + 1], y.y, sv1[r]);
      sv0[r] = fmaf(s[r][m + 2], x.z, sv0[r]);
      sv1[r] = fmaf(s[r][m + 2], y.z, sv1[r]);
      sv0[r] = fmaf(s[r][m + 3], x.w, sv0[r]);
      sv1[r] = fmaf(s[r][m + 3], y.w, sv1[r]);
    }
  }
}

// The steps of cheb_core.cuh's solve_apply, by the warp of lane `lane`,
// for nb <= NBC observations of nonzero weight.
template <int NBC>
__device__ inline void solve_apply(const Workspace& w, const float* nodes,
                                   const float* dct, int k, int nb, int ns,
                                   int degree, float reg, int lane) {
  constexpr int R = NBC > 32 ? 2 : 1;  // rows of S per lane
  constexpr int ZS = NBC + 4;          // zt_ld(NBC)
  const int dp1 = degree + 1;
  const int n_ent = (1 + ns) * NBC;

  // 1. S = zh zh^T in registers, u_i = zh sp_i
  float s[R][NBC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < NBC; ++m) s[r][m] = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    const float* zrow = w.zt + kk * ZS;
    float a[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      a[r] = (lane + 32 * r < NBC) ? zrow[lane + 32 * r] : 0.0f;
#pragma unroll
    for (int m = 0; m < NBC; m += 4) {
      const float4 z = ld4(zrow + m);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][m] = fmaf(a[r], z.x, s[r][m]);
        s[r][m + 1] = fmaf(a[r], z.y, s[r][m + 1]);
        s[r][m + 2] = fmaf(a[r], z.z, s[r][m + 2]);
        s[r][m + 3] = fmaf(a[r], z.w, s[r][m + 3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + 32 * r;
    if (row >= NBC) continue;
    for (int i = 0; i < ns; ++i) {
      float acc = 0.0f;
      for (int kk = 0; kk < k; ++kk)
        acc = fmaf(w.zt[kk * ZS + row], w.spc[i * k + kk], acc);
      w.w_all[(1 + i) * NBC + row] = acc;
    }
  }
  for (int e = lane; e < n_ent; e += 32) {
    w.b1[e] = 0.0f;
    w.b2[e] = 0.0f;
  }
  __syncwarp();

  // 2. the spectral bound, NaN kept; the trace by window slot
  float row_max = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane + 32 * r;
    if (row >= nb) continue;
    float rs = 0.0f, d = 0.0f;
#pragma unroll
    for (int m = 0; m < NBC; ++m) {
      rs += fabsf(s[r][m]);
      if (m == row) d = s[r][m];
    }
    row_max = nan_max(row_max, rs);
    w.diag[w.slot[row]] = d;
  }
  __syncwarp();
  float diag = 0.0f;
  diag += w.diag[lane];
  diag += w.diag[lane + 32];
  const float inf_norm = cheb::warp_max(row_max);
  const float trace = cheb::warp_sum(diag);
  const float lam_ub = nan_max(1.0f + nan_min(inf_norm, trace) / reg, 1.05f);

  // 3. Chebyshev coefficients on [1, lam_ub]
  const float half_w = 0.5f * (lam_ub - 1.0f);
  for (int j = lane; j < dp1; j += 32) {
    const float x = (1.0f + half_w) + half_w * nodes[j];
    const float sq = sqrtf(x);
    w.f1x[j] = 1.0f / x;
    w.f2x[j] = 1.0f / (sq * (1.0f + sq));
  }
  __syncwarp();
  for (int m = lane; m < dp1; m += 32) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int j = 0; j < dp1; ++j) {
      const float d = dct[m * dp1 + j];
      a1 += d * w.f1x[j];
      a2 += d * w.f2x[j];
    }
    w.c1[m] = a1;
    w.c2[m] = a2;
  }
  __syncwarp();

  // 4. the joint Clenshaw recurrence; where a lane holds one row, two
  // operands' mat-vecs at once, so that it runs two chains (as a lane of
  // two rows does); each lane writes its own rows
  const float a2_sc = 2.0f / (lam_ub - 1.0f) / reg;
  float* b0 = w.b0;
  float* b1 = w.b1;
  float* b2 = w.b2;
  for (int mi = degree; mi >= 0; --mi) {
    const auto step = [&](int op, const float (&sv)[R]) {
      const float c = (op == 0) ? w.c1[mi] : w.c2[mi];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int e = op * NBC + lane + 32 * r;
        if (lane + 32 * r >= NBC) continue;
        b0[e] = (mi > 0)
                    ? c * w.w_all[e] + 2.0f * (a2_sc * sv[r] - b1[e]) - b2[e]
                    : c * w.w_all[e] + (a2_sc * sv[r] - b1[e]) - b2[e];
      }
    };
    int op = 0;
    if constexpr (R == 1) {
      for (; op + 1 <= ns; op += 2) {
        float sv0[R], sv1[R];
        matvec2<NBC, R>(s, b1 + op * NBC, b1 + (op + 1) * NBC, sv0, sv1);
        step(op, sv0);
        step(op + 1, sv1);
      }
    }
    for (; op <= ns; ++op) {
      float sv[R];
      matvec<NBC, R>(s, b1 + op * NBC, sv);
      step(op, sv);
    }
    __syncwarp();
    if (mi > 0) {
      float* t = b2;
      b2 = b1;
      b1 = b0;
      b0 = t;
    }
  }
  const float* res = b0;  // q = X^{-1} yh in row 0, v_i = f2(X) u_i after

  // 5. spc_i <- mean_i + <u_i, q>/reg + alpha sp_i - (alpha/reg) zh^T v_i;
  // each lane reads and writes only its own entries f of spc
  const float alpha = sqrtf((static_cast<float>(k) - 1.0f) / reg);
  const float alpha_reg = alpha / reg;
  for (int f = lane; f < ns * k; f += 32) {
    const int i = f / k, kk = f - i * k;
    const float* u = w.w_all + NBC * (1 + i);
    const float* v = res + NBC * (1 + i);
    const float* z = w.zt + kk * ZS;
    float uq = 0.0f, zv = 0.0f;
#pragma unroll
    for (int n = 0; n < NBC; n += 4) {
      const float4 un = ld4(u + n), qn = ld4(res + n);
      const float4 zn = ld4(z + n), vn = ld4(v + n);
      uq = fmaf(un.x, qn.x, uq);
      uq = fmaf(un.y, qn.y, uq);
      uq = fmaf(un.z, qn.z, uq);
      uq = fmaf(un.w, qn.w, uq);
      zv = fmaf(zn.x, vn.x, zv);
      zv = fmaf(zn.y, vn.y, zv);
      zv = fmaf(zn.z, vn.z, zv);
      zv = fmaf(zn.w, vn.w, zv);
    }
    w.spc[f] = w.meanc[i] + uq / reg + alpha * w.spc[f] - alpha_reg * zv;
  }
  __syncwarp();
}

}  // namespace cheb_reg
