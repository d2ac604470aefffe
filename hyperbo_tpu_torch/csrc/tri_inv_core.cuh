// The level schedule of the triangular inverse T = L^{-1}, shared by K3
// (tri_inv.cu, two launches a level) and the joint backward K8
// (bwd_joint.cu, every level inside its persistent launch): the geometry
// of a level and the bodies of its work items. Both kernels call these
// bodies with the same arguments, so K8's T is bitwise K3's.
//
// For a lower-triangular [[A, 0], [B, C]] the inverse is
// [[A^{-1}, 0], [-C^{-1} B A^{-1}, C^{-1}]]. With nb = n / 64 tiles:
//
//   level 0   T_jj = D_j (the inverses of L's diagonal tiles, from
//             ops/tri_inv.diag_inverses), zeros above the diagonal tiles:
//             level_diag_quad, one float4 of T an item;
//   level l   for each aligned range [k 2^l, (k + 1) 2^l) clipped to nb,
//             with left half A (half = 2^(l-1) tiles) and a non-empty right
//             half C: W = L[C, A] T_A into scratch (level_w_tile), then,
//             once every W tile of the level is written, T[C, A] = -T_C W
//             (level_t_tile). One block tile of one merge an item.
//
// Ragged tile counts (the 79 tiles of a 5000-row task padded to 5056) only
// shorten the last range's C. The products are gemm_core.cuh's, 128 x 128
// block tiles where the half is at least kBigHalf tiles and 64 x 64 below;
// each skips the zero triangle of its triangular operand (W's column tile
// c0 sums k >= c0 only, and T_C W's row tile r0 sums k < r0 + BM). Their
// operands are loaded with cp.async.cg, which reads through L2 only, so a
// level may read in the same launch the tiles of T an earlier level wrote.

#pragma once

#include <cuda_runtime.h>

#include "gemm_core.cuh"
#include "tile_common.cuh"

namespace hyperbo {

// Merges at least this many tiles wide use the 128 x 128 block tile.
constexpr int kBigHalf = 8;

// Level 0, float4 q of T (row q / (n / 4)): D_j on the diagonal tiles,
// zeros above them; the tiles below are left for the merges.
__device__ __forceinline__ void level_diag_quad(
    const float* __restrict__ dinv, float* __restrict__ t, int n,
    long long q) {
  const long long row = q / (n / 4);
  const int col = static_cast<int>(q % (n / 4)) * 4;
  const long long ti = row / kTile;
  const int tj = col / kTile;
  float4 v;
  if (tj > ti) {
    v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else if (tj == ti) {
    v = *reinterpret_cast<const float4*>(
        dinv + (ti * kTile + row % kTile) * kTile + col % kTile);
  } else {
    return;
  }
  *reinterpret_cast<float4*>(t + row * n + col) = v;
}

// Block tiles of a level whose halves are `half` tiles: each merge's W
// (and T[C, A]) is rows x cols tiles of BM x BN.
struct LevelShape {
  int rows;
  int cols;
  int merges;
};

template <int BM, int BN>
__host__ __device__ inline LevelShape level_shape(int nb, int half) {
  const int width = half * kTile;
  return {(width + BM - 1) / BM, width / BN,
          (nb - half + 2 * half - 1) / (2 * half)};
}

// Geometry of merge z of a level whose halves are `half` tiles: A's first
// row and column a0, C's first row c0, C's rows m.
struct Merge {
  long long a0;
  long long c0;
  int m;
};

__device__ __forceinline__ Merge merge_at(int n, int half, unsigned z) {
  const int nb = n / kTile;
  const int s = static_cast<int>(z) * 2 * half;
  return {static_cast<long long>(s) * kTile,
          static_cast<long long>(s + half) * kTile,
          (min(s + 2 * half, nb) - (s + half)) * kTile};
}

// W tile (row tile rt, column tile ct) of merge z: W = L[C, A] T_A, W of
// merge z a (m, half * 64) row-major block at z (half * 64)^2 in w.
// Nothing for a row tile past C's last row.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void level_w_tile(const float* __restrict__ l,
                                             const float* __restrict__ t,
                                             float* __restrict__ w, int n,
                                             int half, unsigned rt,
                                             unsigned ct, unsigned z,
                                             float* smem) {
  const Merge g = merge_at(n, half, z);
  const int r0 = rt * BM;
  const int c0 = ct * BN;
  if (r0 >= g.m) return;
  const int width = half * kTile;
  gemm_block<BM, BN, TM, TN>(
      l + g.c0 * n + g.a0, n, g.m, t + g.a0 * n + g.a0, n,
      w + static_cast<long long>(z) * width * width, width, r0, c0, c0,
      width, 1.0f, smem);
}

// T tile (row tile rt, column tile ct) of merge z: T[C, A] = -T_C W.
// Nothing for a row tile past C's last row.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void level_t_tile(const float* __restrict__ w,
                                             float* t, int n, int half,
                                             unsigned rt, unsigned ct,
                                             unsigned z, float* smem) {
  const Merge g = merge_at(n, half, z);
  const int r0 = rt * BM;
  const int c0 = ct * BN;
  if (r0 >= g.m) return;
  const int width = half * kTile;
  gemm_block<BM, BN, TM, TN>(
      t + g.c0 * n + g.c0, n, g.m,
      w + static_cast<long long>(z) * width * width, width,
      t + g.c0 * n + g.a0, n, r0, c0, 0, min(r0 + BM, g.m), -1.0f, smem);
}

}  // namespace hyperbo
