// The bodies of the fused NLL's backward kernels, shared by K3 (tri_inv.cu),
// K4 (mll_bwd.cu) and the joint backward K8 (bwd_joint.cu), which runs both
// in one persistent launch. Each function does one work item of a block:
//
//   tri_inv_slab   one 32-column slab of T = L^{-1} (K3; with kDelta, also
//                  the slab's share of u = T delta, K8's addition);
//   syrk_pair      one lower tile pair (i, j) of the SYRK consumption (K4);
//   reduce_p_entry one entry of P from the pairs' partials (K4);
//   reduce_scalars (d_sv_raw, d_da) from the pairs' partials (K4).
//
// The arithmetic of each is K3's and K4's, operation for operation, so
// their outputs stay bitwise what they were before the move. kFresh marks
// inputs that an earlier phase of the same launch wrote (K8): those are
// read through L2 with __ldcg, never through the non-coherent L1 path.

#pragma once

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace hyperbo {

constexpr int kSlab = 32;
constexpr int kSlabLd = kSlab + 1;
constexpr int kSlabs = kTile / kSlab;
// Shared floats tri_inv_slab needs: a tile of L and a slab of T.
constexpr int kSlabSmem = kTile * kLd + kTile * kSlabLd;
// Shared floats syrk_pair needs: two tiles of T (then tile_sqdist's chunks,
// then W).
constexpr int kPairSmem = 2 * kTile * kLd;
static_assert(kSqdistSmem <= kPairSmem, "sqdist chunks must fit");
static_assert(kSlabSmem <= kPairSmem, "one shared buffer serves both");

template <bool kFresh, typename T>
__device__ __forceinline__ T load(const T* p) {
  if (kFresh) return __ldcg(p);
  return *p;
}

// This thread's two rows of a finished 64 x 32 slab of T (columns tx + 8 q)
// times delta's slab, summed over the 8 threads of the row: u_slab[row0 +
// ty] and u_slab[row0 + ty + 32]. A fixed butterfly, no atomics.
__device__ __forceinline__ void slab_times_delta(const float v0[4],
                                                 const float v1[4],
                                                 const float dl[4],
                                                 long long row0,
                                                 float* __restrict__ u_slab) {
  const int ty = threadIdx.x / 8;
  const int tx = threadIdx.x % 8;
  float s0 = 0.0f;
  float s1 = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    s0 = fmaf(v0[q], dl[q], s0);
    s1 = fmaf(v1[q], dl[q], s1);
  }
#pragma unroll
  for (int off = 4; off > 0; off /= 2) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  if (tx == 0) {
    u_slab[row0 + ty] = s0;
    u_slab[row0 + ty + 32] = s1;
  }
}

// Slab `item` of T = L^{-1}: columns [64 j + 32 (item % 2), +32) with
// j = item / 2, walking down the row tiles i > j in order (K3's block
// forward substitution, T_ij = -D_i sum_{k=j}^{i-1} L_ik T_kj). ls and ts
// are kTile * kLd and kTile * kSlabLd shared floats.
//
// Thread layout of a 64 x 32 slab: (ty, tx) = (tid / 8, tid % 8) owns rows
// ty and ty + 32, columns tx + 8 b (b < 4).
//
// With kDelta, every finished tile T_ij of the slab (the diagonal one D_j
// included) also multiplies delta's slab, and the products go to
// u_part[item][rows of tile i]: this slab's partial of u = T delta, rows
// from 64 j on (rows above are not written).
//
// item is unsigned, as K3's blockIdx.x was before this body moved here:
// with a signed item nvcc interleaved the stores of each step's tile loads
// with the loads, two L2 round trips where one had been, and K3 ran a
// fifth slower at n = 8192 on an H100 (its outputs unchanged).
template <bool kDelta>
__device__ __forceinline__ void tri_inv_slab(
    const float* __restrict__ l, const float* __restrict__ dinv, float* t,
    int n, unsigned item, float* ls, float* ts,
    const float* __restrict__ delta, float* __restrict__ u_part) {
  const int nb = n / kTile;
  const int j = item / kSlabs;
  const long long col0 = static_cast<long long>(j) * kTile +
                         (item % kSlabs) * kSlab;
  const int dcol0 = (item % kSlabs) * kSlab;
  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;

  const long long top = static_cast<long long>(j) * kTile;
  for (long long idx = tid; idx < top * kSlab; idx += kThreads) {
    t[(idx / kSlab) * n + col0 + idx % kSlab] = 0.0f;
  }
  const float* dj = dinv + static_cast<long long>(j) * kTile * kTile;
  for (int idx = tid; idx < kTile * kSlab; idx += kThreads) {
    const int r = idx / kSlab;
    const int c = idx % kSlab;
    t[(top + r) * n + col0 + c] = dj[r * kTile + dcol0 + c];
  }
  float dl[4];
  float* u_slab = nullptr;
  if (kDelta) {
    u_slab = u_part + static_cast<long long>(item) * n;
    float v0[4], v1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dl[q] = delta[col0 + tx + 8 * q];
      v0[q] = dj[ty * kTile + dcol0 + tx + 8 * q];
      v1[q] = dj[(ty + 32) * kTile + dcol0 + tx + 8 * q];
    }
    slab_times_delta(v0, v1, dl, top, u_slab);
  }

  for (int i = j + 1; i < nb; ++i) {
    const long long rowi = static_cast<long long>(i) * kTile;
    float acc[2][4] = {};
    for (int k = j; k < i; ++k) {
      const long long rowk = static_cast<long long>(k) * kTile;
      // The previous step's reads are done, and this block's writes of
      // T_kj (k < i) are visible to all of its threads.
      __syncthreads();
      for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
        const int r = idx / kTile;
        const int c = idx % kTile;
        ls[r * kLd + c] = l[(rowi + r) * n + rowk + c];
      }
      for (int idx = tid; idx < kTile * kSlab; idx += kThreads) {
        const int r = idx / kSlab;
        const int c = idx % kSlab;
        ts[r * kSlabLd + c] = __ldcg(t + (rowk + r) * n + col0 + c);
      }
      __syncthreads();
      for (int m = 0; m < kTile; ++m) {
        const float u0 = ls[ty * kLd + m];
        const float u1 = ls[(ty + 32) * kLd + m];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = ts[m * kSlabLd + tx + 8 * q];
          acc[0][q] = fmaf(u0, v, acc[0][q]);
          acc[1][q] = fmaf(u1, v, acc[1][q]);
        }
      }
    }
    // T_ij = -D_i acc: the sum goes to ts, D_i to ls.
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ts[ty * kSlabLd + tx + 8 * q] = acc[0][q];
      ts[(ty + 32) * kSlabLd + tx + 8 * q] = acc[1][q];
    }
    const float* di = dinv + static_cast<long long>(i) * kTile * kTile;
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      ls[(idx / kTile) * kLd + idx % kTile] = di[idx];
    }
    __syncthreads();
    float out[2][4] = {};
    for (int m = 0; m < kTile; ++m) {
      const float u0 = ls[ty * kLd + m];
      const float u1 = ls[(ty + 32) * kLd + m];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = ts[m * kSlabLd + tx + 8 * q];
        out[0][q] = fmaf(u0, v, out[0][q]);
        out[1][q] = fmaf(u1, v, out[1][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      t[(rowi + ty) * n + col0 + tx + 8 * q] = -out[0][q];
      t[(rowi + ty + 32) * n + col0 + tx + 8 * q] = -out[1][q];
    }
    if (kDelta) {
      float v0[4], v1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v0[q] = -out[0][q];
        v1[q] = -out[1][q];
      }
      slab_times_delta(v0, v1, dl, rowi, u_slab);
    }
  }
}

// Lower tile pair `pair` = (i, j), j <= i, of the SYRK consumption:
// (K^{-1})_ij = sum_{k >= i} T_ki^T T_kj in registers, then r2 from x, G
// and W, this pair's slots of p_part (rows of tile i from W [x_j | 1]; off
// the diagonal, rows of tile j from W^T [x_i | 1]) and its float64 scalar
// partials s_part[2 pair], s_part[2 pair + 1]. smem is kPairSmem shared
// floats, red 2 * kThreads / 32 shared doubles.
template <bool kFresh>
__device__ __forceinline__ void syrk_pair(
    const float* __restrict__ t, const float* __restrict__ x,
    const float* __restrict__ alpha, const float* __restrict__ valid,
    const float* __restrict__ sv_ptr, int n, int d, int fam, long long pair,
    float* smem, double* red, float* __restrict__ p_part,
    double* __restrict__ s_part) {
  // ti and tj hold the T tiles of a step; afterwards the same memory holds
  // tile_sqdist's input chunks, and then ti holds W.
  float* ti = smem;
  float* tj = smem + kTile * kLd;
  float* xs = smem;
  int i, j;
  decode_pair(pair, &i, &j);
  const int nb = n / kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long coli = static_cast<long long>(i) * kTile;
  const long long colj = static_cast<long long>(j) * kTile;

  float acc[4][4] = {};
  for (int k = i; k < nb; ++k) {
    const long long rowk = static_cast<long long>(k) * kTile;
    __syncthreads();
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int m = idx / kTile;
      const int c = idx % kTile;
      ti[m * kLd + c] = load<kFresh>(t + (rowk + m) * n + coli + c);
      tj[m * kLd + c] = load<kFresh>(t + (rowk + m) * n + colj + c);
    }
    __syncthreads();
    for (int m = 0; m < kTile; ++m) {
      float u[4], v[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        u[p] = ti[m * kLd + ty + 16 * p];
        v[p] = tj[m * kLd + tx + 16 * p];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(u[p], v[q], acc[p][q]);
      }
    }
  }

  float r2[4][4];
  tile_sqdist(x, d, coli, colj, xs, r2);
  const float sv = sv_ptr[0];
  double gk = 0.0;
  double gtr = 0.0;
  __syncthreads();  // tile_sqdist's reads of smem are done: ti takes W
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = ty + 16 * p;
    const float ar = load<kFresh>(alpha + coli + r);
    const float vr = valid != nullptr ? valid[coli + r] : 1.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = tx + 16 * q;
      float km, nm;
      km_nm(r2[p][q], sv, fam, &km, &nm);
      if (valid != nullptr) {
        const float pr = vr * valid[colj + c];
        km *= pr;
        nm *= pr;
      }
      const float g =
          0.5f * acc[p][q] - 0.5f * (ar * load<kFresh>(alpha + colj + c));
      gk += static_cast<double>(g * km);
      if (i == j && r == c) gtr += g;
      ti[r * kLd + c] = g * nm;
    }
  }
  __syncthreads();

  // P partials: rows of tile i from W [x_j | 1]; off the diagonal, rows of
  // tile j from W^T [x_i | 1].
  const int f1 = d + 1;
  float* prow = p_part + (static_cast<long long>(i) * nb + j) * kTile * f1;
  for (int idx = tid; idx < kTile * f1; idx += kThreads) {
    const int r = idx / f1;
    const int f = idx % f1;
    float s = 0.0f;
    if (f < d) {
      for (int c = 0; c < kTile; ++c) {
        s = fmaf(ti[r * kLd + c], x[(colj + c) * d + f], s);
      }
    } else {
      for (int c = 0; c < kTile; ++c) s += ti[r * kLd + c];
    }
    prow[idx] = s;
  }
  if (i != j) {
    float* pcol = p_part + (static_cast<long long>(j) * nb + i) * kTile * f1;
    for (int idx = tid; idx < kTile * f1; idx += kThreads) {
      const int c = idx / f1;
      const int f = idx % f1;
      float s = 0.0f;
      if (f < d) {
        for (int r = 0; r < kTile; ++r) {
          s = fmaf(ti[r * kLd + c], x[(coli + r) * d + f], s);
        }
      } else {
        for (int r = 0; r < kTile; ++r) s += ti[r * kLd + c];
      }
      pcol[idx] = s;
    }
  }

  // Scalar partials: a fixed-order reduction over the block. Off the
  // diagonal the pair stands for itself and its mirror (i, j) <-> (j, i).
  for (int off = 16; off > 0; off /= 2) {
    gk += __shfl_down_sync(0xffffffffu, gk, off);
    gtr += __shfl_down_sync(0xffffffffu, gtr, off);
  }
  constexpr int kWarps = kThreads / 32;
  if (tid % 32 == 0) {
    red[tid / 32] = gk;
    red[kWarps + tid / 32] = gtr;
  }
  __syncthreads();
  if (tid == 0) {
    double sgk = 0.0;
    double sgtr = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      sgk += red[w];
      sgtr += red[kWarps + w];
    }
    s_part[2 * pair] = (i == j) ? sgk : 2.0 * sgk;
    s_part[2 * pair + 1] = sgtr;
  }
}

// P[R][f] = sum over the other tile o of p_part[(R / 64, o)][R % 64][f],
// for entry idx = R (d + 1) + f (nothing for idx >= n (d + 1)).
template <bool kFresh>
__device__ __forceinline__ void reduce_p_entry(
    const float* __restrict__ p_part, int n, int d, long long idx,
    float* __restrict__ p) {
  const int f1 = d + 1;
  if (idx >= static_cast<long long>(n) * f1) return;
  const long long row = idx / f1;
  const int f = static_cast<int>(idx % f1);
  const int nb = n / kTile;
  const long long rb = row / kTile;
  const int r = static_cast<int>(row % kTile);
  const long long stride = static_cast<long long>(kTile) * f1;
  const float* src = p_part + rb * nb * stride + r * f1 + f;
  float s = 0.0f;
  for (int o = 0; o < nb; ++o) s += load<kFresh>(src + o * stride);
  p[idx] = s;
}

// out = (d_sv_raw, d_da): the pairs' float64 partials, in a fixed order, by
// one block; red is 2 * kThreads shared doubles.
template <bool kFresh>
__device__ __forceinline__ void reduce_scalars(
    const double* __restrict__ s_part, long long pairs,
    float* __restrict__ out, double* red) {
  const int tid = threadIdx.x;
  double a = 0.0;
  double b = 0.0;
  for (long long q = tid; q < pairs; q += kThreads) {
    a += load<kFresh>(s_part + 2 * q);
    b += load<kFresh>(s_part + 2 * q + 1);
  }
  red[tid] = a;
  red[kThreads + tid] = b;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (tid < w) {
      red[tid] += red[tid + w];
      red[kThreads + tid] += red[kThreads + tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[0] = static_cast<float>(red[0]);
    out[1] = static_cast<float>(red[kThreads]);
  }
}

}  // namespace hyperbo
