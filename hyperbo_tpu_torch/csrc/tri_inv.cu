// Triangular inverse on Hopper (kernel K3): T = L^{-1} for the fused NLL's
// backward.
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_triinv.py,
// tri_inv_panels (pallas_calls at :543 and :577). Block forward
// substitution over 64-wide tiles, given the inverses D_j of L's diagonal
// tiles (ops/tri_inv.diag_inverses):
//
//   T_jj = D_j,   T_ij = -D_i sum_{k=j}^{i-1} L_ik T_kj   (i > j),
//
// n^3/6 multiply-adds in all. Input and output share the dense row-major
// lower-triangular layout of tile_common.cuh; T's upper triangle is
// written as zeros. The TPU's panel-major (nb, n, B) layout was a DMA
// choice and has no counterpart.
//
// Columns of T are independent, so each thread block owns one 32-column
// slab of one panel j and walks down its row tiles i in order; the T_kj it
// reads back are the ones it wrote itself (read through L2 with __ldcg).
// Blocks are numbered heaviest first (panel 0 has the longest chain).
// A NaN anywhere in L reaches D and then every T_ij of the panel.
//
// What bounds it on an H100. Panel 0's chain is (n/64)^2/2 dependent tile
// products run by one block per slab: at n = 8192 that is 8128 steps of
// 64 x 64 x 32 FMAs, so the longest chain, not the card's 67 TFLOP/s,
// sets the time, with most SMs idle near the end. Each step also reads a
// 16 KB tile of L from L2 or HBM. Splitting the reduction over k between
// blocks (then a second pass), or the recursive 2x2 inverse with large
// GEMMs, would shorten the chain; that is later work.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

using namespace hyperbo;

constexpr int kSlab = 32;
constexpr int kSlabLd = kSlab + 1;
constexpr int kSlabs = kTile / kSlab;

// Thread layout of a 64 x 32 slab: (ty, tx) = (tid / 8, tid % 8) owns rows
// ty and ty + 32, columns tx + 8 b (b < 4).
__global__ void __launch_bounds__(kThreads)
tri_inv_slabs(const float* __restrict__ l, const float* __restrict__ dinv,
              float* t, int n) {
  __shared__ float ls[kTile * kLd];
  __shared__ float ts[kTile * kSlabLd];
  const int nb = n / kTile;
  const int j = blockIdx.x / kSlabs;
  const long long col0 = static_cast<long long>(j) * kTile +
                         (blockIdx.x % kSlabs) * kSlab;
  const int dcol0 = (blockIdx.x % kSlabs) * kSlab;
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
  }
}

}  // namespace

// l: (n, n) lower-triangular factor; dinv: (n/64, 64, 64) inverses of its
// diagonal tiles; t: (n, n) output. Device pointers to float32 row-major
// arrays; stream: a cudaStream_t. n must be a positive multiple of 64.
// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue,
// without launching, for an n it does not take).
extern "C" int hyperbo_tri_inv(const float* l, const float* dinv, float* t,
                               int n, void* stream) {
  if (n < kTile || n % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = n / kTile;
  tri_inv_slabs<<<nb * kSlabs, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(l, dinv, t, n);
  return static_cast<int>(cudaGetLastError());
}
