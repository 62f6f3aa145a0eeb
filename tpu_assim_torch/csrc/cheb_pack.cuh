// The per-column Chebyshev/Clenshaw solve and weight application of the
// 1-D window kernel (letkf_window1d.cu, K1) and the neighborhood kernel
// (letkf_nbh_cheb.cu, K4) on their register route, windows of nb <= 64:
// the arithmetic of cheb_core.cuh with the Gram matrix S in registers, as
// in cheb_reg.cuh (K6's register route), and small windows packed several
// to a warp. It is the port of _cheb_solve_apply in
// tpu_assim/ops/pallas/letkf.py; its plain PyTorch twin is
// tpu_assim_torch/ops/cuda/letkf.py:_cheb_solve_apply.
//
// K6 keeps its own copy. Taken through this one (one column a warp, zt
// rows NBC + 4 apart, its trace by window slot) its NBC 56 instance spills
// under its 3 blocks an SM while u_1 rides in the Gram step, and its
// output's bits move: nvcc fuses the products of the Clenshaw update
// c y + 2 (a Sv - b1) - b2 into FMAs differently in each instance, and no
// one form keeps K6's bits (c y rounded first) and K1's and K4's.
//
// What bounded K1 and K4 on cheb_core.cuh (one warp a column, S in shared
// memory) on an H100: shared loads and idle lanes. The Gram step took two
// shared loads an FMA and a division an entry, the Clenshaw mat-vec read S
// and v from shared memory for every FMA in loops of runtime bounds, and
// at the headline windows (nb 12, or 8) a warp's lanes were a third to a
// half idle in the mat-vec rows, the coefficients and u = zh sp.
//
// This solve. NBC = nb rounded up to 4 is a template argument; the pad
// rows of S are zero and add exact zeros.
//  - Packing. A column owns L lanes, NBC rounded up to a power of 2 (at
//    most 32), one row of S a lane; a warp holds P = 32 / L columns: 8 at
//    nb <= 4, 4 at nb <= 8, 2 at nb <= 16 (nb 12: NBC 12 on 16 lanes, a
//    quarter less work and shared memory than rows of 16). Beyond, one
//    column a warp, one row a lane up to NBC 32 and two (rows l and l + 32)
//    above. Every reduction (the trace, the row-sum maximum) runs over the
//    column's own lanes by xor shuffles of offsets below L, so a NaN column
//    never reaches its warp-mates; every per-column loop (coefficients,
//    <u_i, q>, the apply) strides over the column's lanes only.
//  - Layout. A warp's shared slice holds its columns side by side, row by
//    row: zh transposed zt [k][W], the right-hand sides w_all and the three
//    Clenshaw buffers [1 + ns][W], W = P * NBC, column c at entries c * NBC..
//    of every row; then each column's own block (its state perturbations
//    and mean, coefficients and node values). A lane's own entries of a row
//    are then consecutive across the warp (no bank conflict), and the P
//    columns' 16-byte broadcasts of a row fall in distinct bank quads. The
//    own blocks are L mod 32 floats apart when packed, so the columns'
//    broadcasts of them differ in bank too.
//  - Gram step: a lane loads its row's entry of zt[kk] and the row's four
//    entries at a time as 16-byte broadcasts: NBC FMAs per NBC / 4 + 1
//    shared loads; u_1 = zh sp_1 rides along (one broadcast, one FMA).
//  - Clenshaw: the 1 + ns operands go two at a time, so a lane runs two
//    independent mat-vec chains (four at two rows a lane), each reading
//    the operand's vector as 16-byte broadcasts and S never. The buffers
//    stay in shared memory: ns is a runtime count, and a lane reads only
//    its own entries of w_all, b1 and b2 besides the broadcasts.
//  - Apply: <u_i, q> once per slice i (folded into the slice's mean, the
//    first sum of the update, as the old order adds it), then Zh^T v_i per
//    entry from broadcasts.
// Sums run in cheb_core.cuh's order: S's entries and u over kk ascending,
// the mat-vecs over m ascending, <u_i, q> and Zh^T v_i over n ascending,
// one FMA each; only the trace sums in another (a butterfly over the
// column's lanes).
//
// The caller fills the column's zt (pad entries zero), row 0 of w_all (pad
// entries zero), spc and meanc, then calls solve_apply<NBC>, which leaves
// the column's analysis [ns][k] in spc: gram, clenshaw and apply in turn.
// K1's union route (letkf_window1d.cu) forms S and u from its block's
// staged windows and calls clenshaw alone.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "cheb_core.cuh"

namespace cheb_pack {

using cheb::kFull;
using cheb::nan_max;
using cheb::nan_min;

// Largest window of the register route.
constexpr int kMaxNb = 64;

// The register row length of a window of nb: nb rounded up to 4.
__host__ __device__ constexpr int padded_nb(int nb) { return (nb + 3) & ~3; }

// Lanes a column owns (NBC rounded up to a power of 2, at most 32), and
// columns a warp holds.
__host__ __device__ constexpr int lanes_per_col(int nbc) {
  return nbc <= 4 ? 4 : nbc <= 8 ? 8 : nbc <= 16 ? 16 : 32;
}
__host__ __device__ constexpr int cols_per_warp(int nbc) {
  return 32 / lanes_per_col(nbc);
}

// Floats of a column's own block: spc [ns][k], meanc [ns], c1, c2, f1x,
// f2x [d + 1]; L mod 32 when packed, else a multiple of 4.
__host__ __device__ constexpr int col_floats(int k, int nbc, int ns,
                                             int degree) {
  const int f = ns * k + ns + 4 * (degree + 1);
  const int l = lanes_per_col(nbc);
  return l < 32 ? (f + 31 - l) / 32 * 32 + l : (f + 3) & ~3;
}

// Floats of one warp's slice: zt, w_all, b0, b1, b2, then the columns' own
// blocks.
__host__ __device__ constexpr int warp_floats(int k, int nbc, int ns,
                                              int degree) {
  const int p = cols_per_warp(nbc);
  return p * nbc * (k + 4 * (1 + ns)) + p * col_floats(k, nbc, ns, degree);
}

// Offset of column `slot`'s own block in its warp's slice.
__host__ __device__ constexpr int col_block(int k, int nbc, int ns,
                                            int degree, int slot) {
  return cols_per_warp(nbc) * nbc * (k + 4 * (1 + ns))
         + slot * col_floats(k, nbc, ns, degree);
}

// One column's view of its warp's slice. The [.][W] arrays point at the
// column's first entry of row 0; row i lies W floats further.
struct Col {
  float* zt;     // [k][W] scaled perturbations, transposed (in)
  float* w_all;  // [1 + ns][W]: yh (in), then u_i = zh sp_i
  float* b0;     // three Clenshaw buffers [1 + ns][W]
  float* b1;
  float* b2;
  float* spc;    // [ns][k] state perturbations (in), the analysis (out)
  float* meanc;  // [ns] state mean (in)
  float* c1;     // [d + 1] coefficients of 1/x
  float* c2;     // [d + 1] of 1/(sqrt(x)(1 + sqrt(x)))
  float* f1x;    // [d + 1] node values
  float* f2x;
};

template <int NBC>
__device__ __forceinline__ Col carve(float* warp_base, int slot, int k,
                                     int ns, int degree) {
  constexpr int W = cols_per_warp(NBC) * NBC;
  const int n_rows = 1 + ns, dp1 = degree + 1;
  Col w;
  w.zt = warp_base + slot * NBC;
  w.w_all = w.zt + k * W;
  w.b0 = w.w_all + n_rows * W;
  w.b1 = w.b0 + n_rows * W;
  w.b2 = w.b1 + n_rows * W;
  w.spc = warp_base + col_block(k, NBC, ns, degree, slot);
  w.meanc = w.spc + ns * k;
  w.c1 = w.meanc + ns;
  w.c2 = w.c1 + dp1;
  w.f1x = w.c2 + dp1;
  w.f2x = w.f1x + dp1;
  return w;
}

// *dst <- *src by an asynchronous copy (cp.async, no register on the
// way), or <- 0 where !valid (src is then not read); the caller commits
// and waits (__pipeline_commit, __pipeline_wait_prior) before a barrier.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  __pipeline_memcpy_async(dst, src, sizeof(float), valid ? 0 : sizeof(float));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Sum and NaN-keeping maximum over the L lanes of a column (L a power of
// 2), the same in each of them.
template <int L>
__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}
template <int L>
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// sa[r] = sum_m s[r][m] va[m] and sb[r] = sum_m s[r][m] vb[m], m = 0..NBC-1
// in order, va and vb by broadcasts.
template <int NBC, int R>
__device__ __forceinline__ void matvec2(const float (&s)[R][NBC],
                                        const float* va, const float* vb,
                                        float (&sa)[R], float (&sb)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sa[r] = 0.0f;
    sb[r] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < NBC; m += 4) {
    const float4 x = ld4(va + m);
    const float4 y = ld4(vb + m);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sa[r] = fmaf(s[r][m], x.x, sa[r]);
      sb[r] = fmaf(s[r][m], y.x, sb[r]);
      sa[r] = fmaf(s[r][m + 1], x.y, sa[r]);
      sb[r] = fmaf(s[r][m + 1], y.y, sb[r]);
      sa[r] = fmaf(s[r][m + 2], x.z, sa[r]);
      sb[r] = fmaf(s[r][m + 2], y.z, sb[r]);
      sa[r] = fmaf(s[r][m + 3], x.w, sa[r]);
      sb[r] = fmaf(s[r][m + 3], y.w, sb[r]);
    }
  }
}

// Rows of S a lane holds: r, and r + 32 above NBC 32.
__host__ __device__ constexpr int lane_rows(int nbc) {
  return nbc > 32 ? 2 : 1;
}

// The steps of cheb_core.cuh's solve_apply for one column of a window of
// nb <= NBC observations, by its lane r (0 <= r < lanes_per_col(NBC)); rows
// r >= NBC are idle. Every lane of the warp calls each step (for its own
// column) and reaches each __syncwarp.

// 1. S = zh zh^T into s, u_i = zh sp_i into rows 1.. of w_all, b1 and b2
// zeroed.
template <int NBC>
__device__ __forceinline__ void gram(const Col& w, int k, int ns, int r,
                                     float (&s)[lane_rows(NBC)][NBC]) {
  constexpr int L = lanes_per_col(NBC);
  constexpr int W = cols_per_warp(NBC) * NBC;
  constexpr int R = lane_rows(NBC);

  // S in registers, u_1 = zh sp_1 alongside, then u_2.. u_ns
  float u1[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    u1[q] = 0.0f;
#pragma unroll
    for (int m = 0; m < NBC; ++m) s[q][m] = 0.0f;
  }
#pragma unroll 1
  for (int kk = 0; kk < k; ++kk) {
    const float* zrow = w.zt + kk * W;
    const float sp1 = w.spc[kk];
    float a[R];
#pragma unroll
    for (int q = 0; q < R; ++q)
      a[q] = (r + 32 * q < NBC) ? zrow[r + 32 * q] : 0.0f;
#pragma unroll
    for (int m = 0; m < NBC; m += 4) {
      const float4 z = ld4(zrow + m);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        s[q][m] = fmaf(a[q], z.x, s[q][m]);
        s[q][m + 1] = fmaf(a[q], z.y, s[q][m + 1]);
        s[q][m + 2] = fmaf(a[q], z.z, s[q][m + 2]);
        s[q][m + 3] = fmaf(a[q], z.w, s[q][m + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) u1[q] = fmaf(a[q], sp1, u1[q]);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = r + 32 * q;
    if (row >= NBC) continue;
    w.w_all[W + row] = u1[q];
#pragma unroll 1
    for (int i = 1; i < ns; ++i) {
      float acc = 0.0f;
#pragma unroll 1
      for (int kk = 0; kk < k; ++kk)
        acc = fmaf(w.zt[kk * W + row], w.spc[i * k + kk], acc);
      w.w_all[(1 + i) * W + row] = acc;
    }
  }
#pragma unroll 1
  for (int e = r; e < (1 + ns) * NBC; e += L) {
    const int at = (e / NBC) * W + e % NBC;
    w.b1[at] = 0.0f;
    w.b2[at] = 0.0f;
  }
  __syncwarp();
}

// 2.-4. and the mean: the spectral bound of S, the Chebyshev coefficients,
// the joint Clenshaw recurrence over rows 0.. of w_all (yh, u_1.. u_ns),
// and meanc_i += <u_i, q>/reg. Returns the recurrence's result: q =
// X^{-1} yh in row 0, v_i = f2(X) u_i in rows 1.. (one of b0, b1, b2).
template <int NBC>
__device__ __forceinline__ float* clenshaw(
    const Col& w, const float (&s)[lane_rows(NBC)][NBC], const float* nodes,
    const float* __restrict__ dct, int nb, int ns, int degree, float reg,
    int r) {
  constexpr int L = lanes_per_col(NBC);
  constexpr int W = cols_per_warp(NBC) * NBC;
  constexpr int R = lane_rows(NBC);
  const int dp1 = degree + 1;

  // 2. the spectral bound, NaN kept, over the column's lanes
  float row_max = 0.0f, diag = 0.0f;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int row = r + 32 * q;
    if (row >= nb) continue;
    float rs = 0.0f, d = 0.0f;
#pragma unroll
    for (int m = 0; m < NBC; ++m) {
      rs += fabsf(s[q][m]);
      if (m == row) d = s[q][m];
    }
    row_max = nan_max(row_max, rs);
    diag += d;
  }
  const float inf_norm = col_max<L>(row_max);
  const float trace = col_sum<L>(diag);
  const float lam_ub = nan_max(1.0f + nan_min(inf_norm, trace) / reg, 1.05f);

  // 3. Chebyshev coefficients on [1, lam_ub]
  const float half_w = 0.5f * (lam_ub - 1.0f);
#pragma unroll 1
  for (int j = r; j < dp1; j += L) {
    const float x = (1.0f + half_w) + half_w * nodes[j];
    const float sq = sqrtf(x);
    w.f1x[j] = 1.0f / x;
    w.f2x[j] = 1.0f / (sq * (1.0f + sq));
  }
  __syncwarp();
#pragma unroll 1
  for (int m = r; m < dp1; m += L) {
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll 4
    for (int j = 0; j < dp1; ++j) {
      const float d = __ldg(dct + m * dp1 + j);
      a1 += d * w.f1x[j];
      a2 += d * w.f2x[j];
    }
    w.c1[m] = a1;
    w.c2[m] = a2;
  }
  __syncwarp();

  // 4. the joint Clenshaw recurrence, operands two at a time (the last
  // one twice when 1 + ns is odd); each lane writes its own rows
  const float a2_sc = 2.0f / (lam_ub - 1.0f) / reg;
  float* b0 = w.b0;
  float* b1 = w.b1;
  float* b2 = w.b2;
#pragma unroll 1
  for (int mi = degree; mi >= 0; --mi) {
    const float cc1 = w.c1[mi], cc2 = w.c2[mi];
#pragma unroll 1
    for (int op = 0; op <= ns; op += 2) {
      const int op1 = op < ns ? op + 1 : op;
      float sa[R], sb[R];
      matvec2<NBC, R>(s, b1 + op * W, b1 + op1 * W, sa, sb);
      const float ca = (op == 0) ? cc1 : cc2;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int row = r + 32 * q;
        if (row >= NBC) continue;
        const int ea = op * W + row, eb = op1 * W + row;
        float va, vb;
        if (mi > 0) {
          va = ca * w.w_all[ea] + 2.0f * (a2_sc * sa[q] - b1[ea]) - b2[ea];
          vb = cc2 * w.w_all[eb] + 2.0f * (a2_sc * sb[q] - b1[eb]) - b2[eb];
        } else {
          va = ca * w.w_all[ea] + (a2_sc * sa[q] - b1[ea]) - b2[ea];
          vb = cc2 * w.w_all[eb] + (a2_sc * sb[q] - b1[eb]) - b2[eb];
        }
        b0[eb] = vb;
        b0[ea] = va;
      }
    }
    __syncwarp();
    if (mi > 0) {
      float* t = b2;
      b2 = b1;
      b1 = b0;
      b0 = t;
    }
  }
  float* res = b0;  // q = X^{-1} yh in row 0, v_i = f2(X) u_i after

  // mean_i + <u_i, q>/reg once per slice; each lane writes its own
#pragma unroll 1
  for (int i = r; i < ns; i += L) {
    const float* u = w.w_all + (1 + i) * W;
    float uq = 0.0f;
#pragma unroll
    for (int n = 0; n < NBC; n += 4) {
      const float4 un = ld4(u + n), qn = ld4(res + n);
      uq = fmaf(un.x, qn.x, uq);
      uq = fmaf(un.y, qn.y, uq);
      uq = fmaf(un.z, qn.z, uq);
      uq = fmaf(un.w, qn.w, uq);
    }
    w.meanc[i] = w.meanc[i] + uq / reg;
  }
  __syncwarp();
  return res;
}

// 5. spc_i <- mean_i + alpha sp_i - (alpha/reg) zh^T v_i, v_i in rows 1..
// of res; each lane writes only its own entries.
template <int NBC>
__device__ __forceinline__ void apply(const Col& w, const float* res, int k,
                                      int ns, float reg, int r) {
  constexpr int L = lanes_per_col(NBC);
  constexpr int W = cols_per_warp(NBC) * NBC;
  const float alpha = sqrtf((static_cast<float>(k) - 1.0f) / reg);
  const float alpha_reg = alpha / reg;
#pragma unroll 1
  for (int f = r; f < ns * k; f += L) {
    const int i = f / k, kk = f - i * k;
    const float* v = res + (1 + i) * W;
    const float* z = w.zt + kk * W;
    float zv = 0.0f;
#pragma unroll
    for (int n = 0; n < NBC; n += 4) {
      const float4 zn = ld4(z + n), vn = ld4(v + n);
      zv = fmaf(zn.x, vn.x, zv);
      zv = fmaf(zn.y, vn.y, zv);
      zv = fmaf(zn.z, vn.z, zv);
      zv = fmaf(zn.w, vn.w, zv);
    }
    w.spc[f] = w.meanc[i] + alpha * w.spc[f] - alpha_reg * zv;
  }
  __syncwarp();
}

// The whole solve from zt: steps 1 to 5, leaving the analysis in spc.
template <int NBC>
__device__ inline void solve_apply(const Col& w, const float* nodes,
                                   const float* __restrict__ dct, int k,
                                   int nb, int ns, int degree, float reg,
                                   int r) {
  float s[lane_rows(NBC)][NBC];
  gram<NBC>(w, k, ns, r, s);
  const float* res = clenshaw<NBC>(w, s, nodes, dct, nb, ns, degree, reg, r);
  apply<NBC>(w, res, k, ns, reg, r);
}

}  // namespace cheb_pack
