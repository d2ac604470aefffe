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
// the bottom (tri_inv_core.cuh, whose level bodies the joint backward K8
// runs too): level 0 writes the inverses of L's diagonal tiles D_j (given,
// from ops/tri_inv.diag_inverses) and zeros above them; level l merges
// aligned ranges of 2^l tiles, W = L[C, A] T_A into scratch, then
// T[C, A] = -T_C W. The work is the n^3/6 multiply-adds of any triangular
// inverse, so what bounds K3 on an H100 is n^3/3 float32 operations at 67
// TFLOP/s (2.7 ms at n = 8192); its bytes (L in, T out) take 0.16 ms at
// 3.35 TB/s.
//
// What the levels do about the chain of block forward substitution. That
// method has one block walk each 32-column slab of T down its row tiles:
// panel 0 is a chain of (n/64)^2/2 dependent tile steps (8128 at
// n = 8192), with most SMs idle near its end. Here the dependent chain is
// ceil(log2 nb) levels (7 at n = 8192) of two launches each, and each
// launch is a set of independent block-tile products that fills the card;
// the top level holds about three quarters of the operations. The
// products are gemm_core.cuh's: FP32 FMA with cp.async double buffering,
// 128 x 128 block tiles where a merge is at least 512 wide and 64 x 64
// below. No atomics and no split-k: two calls give bitwise equal T. A NaN
// in L reaches T through D or the products.
//
// One C entry point enqueues every launch on the caller's stream, in
// order, without synchronizing.

#include <cuda_runtime.h>

#include <algorithm>

#include "tile_common.cuh"
#include "tri_inv_core.cuh"

namespace {

using namespace hyperbo;

__global__ void __launch_bounds__(256)
level_diag(const float* __restrict__ dinv, float* __restrict__ t, int n) {
  const long long quads = static_cast<long long>(n) * (n / 4);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < quads; q += stride) {
    level_diag_quad(dinv, t, n, q);
  }
}

// W tiles of every merge of the level, one block each, in order of work:
// column tile 0, which sums all of A, first.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kGemmThreads)
level_w(const float* __restrict__ l, const float* __restrict__ t,
        float* __restrict__ w, int n, int half) {
  __shared__ __align__(16) float smem[gemm_smem_floats<BM, BN>()];
  level_w_tile<BM, BN, TM, TN>(l, t, w, n, half, blockIdx.x, blockIdx.y,
                               blockIdx.z, smem);
}

// T[C, A] tiles of every merge of the level. Heaviest first: the last row
// tile sums all of C.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kGemmThreads)
level_t(const float* __restrict__ w, float* t, int n, int half) {
  __shared__ __align__(16) float smem[gemm_smem_floats<BM, BN>()];
  level_t_tile<BM, BN, TM, TN>(w, t, n, half, gridDim.y - 1 - blockIdx.y,
                               blockIdx.x, blockIdx.z, smem);
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_level(const float* l, float* t, float* w, int n, int half,
                         cudaStream_t stream) {
  const LevelShape s = level_shape<BM, BN>(n / kTile, half);
  level_w<BM, BN, TM, TN><<<dim3(s.rows, s.cols, s.merges), kGemmThreads, 0,
                            stream>>>(l, t, w, n, half);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  level_t<BM, BN, TM, TN><<<dim3(s.cols, s.rows, s.merges), kGemmThreads, 0,
                            stream>>>(w, t, n, half);
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
    err = half >= kBigHalf
              ? launch_level<128, 128, 8, 8>(l, t, scratch, n, half, s)
              : launch_level<64, 64, 4, 4>(l, t, scratch, n, half, s);
  }
  return static_cast<int>(err);
}
