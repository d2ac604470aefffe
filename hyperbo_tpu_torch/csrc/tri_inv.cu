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
// A NaN anywhere in L reaches D and then every T_ij of the panel. The
// block's body is bwd_core.cuh's tri_inv_slab, which the joint backward
// (bwd_joint.cu, kernel K8) runs as its first phase.
//
// What bounds it on an H100. Panel 0's chain is (n/64)^2/2 dependent tile
// products run by one block per slab: at n = 8192 that is 8128 steps of
// 64 x 64 x 32 FMAs, so the longest chain, not the card's 67 TFLOP/s,
// sets the time, with most SMs idle near the end. Each step also reads a
// 16 KB tile of L from L2 or HBM. Splitting the reduction over k between
// blocks (then a second pass), or the recursive 2x2 inverse with large
// GEMMs, would shorten the chain; that is later work.

#include <cuda_runtime.h>

#include "bwd_core.cuh"
#include "tile_common.cuh"

namespace {

using namespace hyperbo;

// One block per 32-column slab (bwd_core.cuh tri_inv_slab).
__global__ void __launch_bounds__(kThreads)
tri_inv_slabs(const float* __restrict__ l, const float* __restrict__ dinv,
              float* t, int n) {
  __shared__ float ls[kTile * kLd];
  __shared__ float ts[kTile * kSlabLd];
  tri_inv_slab<false>(l, dinv, t, n, blockIdx.x, ls, ts, nullptr, nullptr);
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
