// The bodies of the fused NLL's SYRK backward on 64 x 64 tile pairs, which
// the joint backward K8 (bwd_joint.cu) runs in its persistent launch after
// K3's levels (tri_inv_core.cuh). Each function does one work item of a
// block:
//
//   syrk_pair      one lower tile pair (i, j) of the SYRK consumption;
//   reduce_p_entry one entry of P from the pairs' partials;
//   reduce_scalars (d_sv_raw, d_da) from the pairs' partials.
//
// They were K4's bodies until K4 moved to 128 x 128 tile pairs
// (syrk128_core.cuh); K4 still sums its scalar partials with
// reduce_scalars. kFresh marks inputs that an earlier phase of the same
// launch wrote (K8): those are read through L2 with __ldcg, never through
// the non-coherent L1 path.

#pragma once

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace hyperbo {

// K8's alpha phase: 32-column slabs of T, two a tile.
constexpr int kSlab = 32;
constexpr int kSlabs = kTile / kSlab;
// Shared floats syrk_pair needs: two tiles of T (then tile_sqdist's chunks,
// then W).
constexpr int kPairSmem = 2 * kTile * kLd;
static_assert(kSqdistSmem <= kPairSmem, "sqdist chunks must fit");

template <bool kFresh, typename T>
__device__ __forceinline__ T load(const T* p) {
  if (kFresh) return __ldcg(p);
  return *p;
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
