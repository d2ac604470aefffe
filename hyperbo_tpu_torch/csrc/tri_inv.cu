// Triangular inverse on Hopper (kernel K3): T = L^{-1} for the fused NLL's
// backward.
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_triinv.py,
// tri_inv_panels (pallas_calls at :543 and :577). Input and output share
// the dense row-major lower-triangular layout of tile_common.cuh, n a
// multiple of 64; T's upper triangle is written as zeros. The TPU's
// panel-major (nb, n, B) layout was a DMA choice and has no counterpart.
//
// Algorithm: the recursive 2 x 2 block inverse, run level by level from
// the bottom. For a lower-triangular [[A, 0], [B, C]] the inverse is
// [[A^{-1}, 0], [-C^{-1} B A^{-1}, C^{-1}]]. With nb = n / 64 tiles:
//
//   level 0   T_jj = D_j, the inverses of L's diagonal tiles (given, from
//             ops/tri_inv.diag_inverses), and zeros above the diagonal;
//   level l   for each aligned range [k 2^l, (k + 1) 2^l) clipped to nb,
//             with left half A (2^(l-1) tiles) and a non-empty right half
//             C: W = L[C, A] T_A into scratch, then T[C, A] = -T_C W.
//
// Ragged tile counts (the 79 tiles of a 5000-row task padded to 5056) only
// shorten the last range's C. The work is the n^3/6 multiply-adds of any
// triangular inverse, so what bounds K3 on an H100 is n^3/3 float32
// operations at 67 TFLOP/s (2.7 ms at n = 8192); its bytes (L in, T out)
// take 0.16 ms at 3.35 TB/s.
//
// What the levels do about the chain of block forward substitution. That
// method (bwd_core.cuh's tri_inv_slab, which K8 runs as its first phase)
// has one block walk each 32-column slab of T down its row tiles: panel 0
// is a chain of (n/64)^2/2 dependent tile steps (8128 at n = 8192), with
// most SMs idle near its end. Here the dependent chain is ceil(log2 nb)
// levels (7 at n = 8192) of two launches each, and each launch is a set of
// independent block-tile products that fills the card; the top level holds
// about three quarters of the operations. The products are gemm_core.cuh's:
// FP32 FMA with cp.async double buffering, 128 x 128 block tiles where a
// merge is at least 512 wide and 64 x 64 below. Each product skips the zero
// triangle of its triangular operand: W's column tile c0 sums k >= c0
// only, and T_C W's row tile r0 sums k < r0 + BM. No atomics and no
// split-k: two calls give bitwise equal T. A NaN in L reaches T through D
// or the products.
//
// One C entry point enqueues every launch on the caller's stream, in
// order, without synchronizing.

#include <cuda_runtime.h>

#include <algorithm>

#include "gemm_core.cuh"
#include "tile_common.cuh"

namespace {

using namespace hyperbo;

// Merges at least this many tiles wide use the 128 x 128 block tile.
constexpr int kBigHalf = 8;

// Level 0: T_jj = D_j, zeros above the diagonal tiles; the tiles below are
// left for the merges. One float4 of T a thread.
__global__ void __launch_bounds__(256)
level_diag(const float* __restrict__ dinv, float* __restrict__ t, int n) {
  const long long quads = static_cast<long long>(n) * (n / 4);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < quads; q += stride) {
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
      continue;
    }
    *reinterpret_cast<float4*>(t + row * n + col) = v;
  }
}

// Geometry of merge blockIdx.z of a level whose halves are `half` tiles:
// A's first row and column a0, C's first row c0, C's rows m.
struct Merge {
  long long a0;
  long long c0;
  int m;
};

__device__ __forceinline__ Merge merge_of(int n, int half) {
  const int nb = n / kTile;
  const int s = blockIdx.z * 2 * half;
  return {static_cast<long long>(s) * kTile,
          static_cast<long long>(s + half) * kTile,
          (min(s + 2 * half, nb) - (s + half)) * kTile};
}

// W = L[C, A] T_A for every merge of the level: W of merge z is a
// (m, half * 64) row-major block at z (half * 64)^2 in w. Block tiles in
// order of work, heaviest (column tile 0, which sums all of A) first.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kGemmThreads)
level_w(const float* __restrict__ l, const float* __restrict__ t,
        float* __restrict__ w, int n, int half) {
  __shared__ __align__(16) float smem[gemm_smem_floats<BM, BN>()];
  const Merge g = merge_of(n, half);
  const int r0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  if (r0 >= g.m) return;
  const int width = half * kTile;
  gemm_block<BM, BN, TM, TN>(
      l + g.c0 * n + g.a0, n, g.m, t + g.a0 * n + g.a0, n,
      w + static_cast<long long>(blockIdx.z) * width * width, width, r0, c0,
      c0, width, 1.0f, smem);
}

// T[C, A] = -T_C W for every merge of the level. Heaviest first: the last
// row tile sums all of C.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kGemmThreads)
level_t(const float* __restrict__ w, float* t, int n, int half) {
  __shared__ __align__(16) float smem[gemm_smem_floats<BM, BN>()];
  const Merge g = merge_of(n, half);
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int c0 = blockIdx.x * BN;
  if (r0 >= g.m) return;
  const int width = half * kTile;
  gemm_block<BM, BN, TM, TN>(
      t + g.c0 * n + g.c0, n, g.m,
      w + static_cast<long long>(blockIdx.z) * width * width, width,
      t + g.c0 * n + g.a0, n, r0, c0, 0, min(r0 + BM, g.m), -1.0f, smem);
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_level(const float* l, float* t, float* w, int n, int half,
                         int merges, cudaStream_t stream) {
  const int width = half * kTile;
  const int row_tiles = (width + BM - 1) / BM;
  const int col_tiles = width / BN;
  level_w<BM, BN, TM, TN><<<dim3(row_tiles, col_tiles, merges),
                            kGemmThreads, 0, stream>>>(l, t, w, n, half);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  level_t<BM, BN, TM, TN><<<dim3(col_tiles, row_tiles, merges),
                            kGemmThreads, 0, stream>>>(w, t, n, half);
  return cudaGetLastError();
}

}  // namespace

// l: (n, n) lower-triangular factor; dinv: (n/64, 64, 64) inverses of its
// diagonal tiles; t: (n, n) output; scratch: the largest level's W, at
// least max over levels of sum over merges of |C| |A| 64^2 floats (at most
// n^2/4; ops/tri_inv.scratch_floats). Device pointers to float32 row-major
// arrays; stream: a cudaStream_t. n must be a positive multiple of 64.
// Returns 0 or the first cudaError_t of the launches
// (cudaErrorInvalidValue, without launching, for an n it does not take).
extern "C" int hyperbo_tri_inv(const float* l, const float* dinv, float* t,
                               float* scratch, int n, void* stream) {
  if (n < kTile || n % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long quads = static_cast<long long>(n) * (n / 4);
  const int blocks = static_cast<int>(std::min((quads + 255) / 256, 8192LL));
  level_diag<<<blocks, 256, 0, s>>>(dinv, t, n);
  cudaError_t err = cudaGetLastError();
  const int nb = n / kTile;
  for (int half = 1; half < nb && err == cudaSuccess; half *= 2) {
    const int merges = (nb - half + 2 * half - 1) / (2 * half);
    err = half >= kBigHalf
              ? launch_level<128, 128, 8, 8>(l, t, scratch, n, half, merges, s)
              : launch_level<64, 64, 4, 4>(l, t, scratch, n, half, merges, s);
  }
  return static_cast<int>(err);
}
