// Fused NLL backward on Hopper (kernel K4): the adjoints of the fused NLL
// from T = L^{-1}, with K^{-1}, G and W never written to device memory.
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_mll_bwd.py,
// mll_bwd_fused (pallas_calls at :417 and :459). With alpha = K^{-1} delta
// and r2 the squared distances of the scaled inputs x (n, d):
//
//   K^{-1} = T^T T,  G = (K^{-1} - alpha alpha^T) / 2,  W = G o N(r2)
//   P = [W x | W 1]          (n, d + 1)
//   d_sv_raw = sum G o Kf    (Kf = sv k(r2), without the diagonal add)
//   d_da = tr G
//
// (N and Kf per family: tile_common.cuh km_nm; with a valid mask both are
// multiplied by valid_i valid_j.) The caller forms d_x = 2 (Wx - (W1) o x)
// and d_sv = d_sv_raw / sv.
//
// One thread block per lower tile pair (i, j), j <= i. T is lower
// triangular, so (K^{-1})_ij = sum_{k >= i} T_ki^T T_kj: (n/64 - i) tile
// products accumulated in registers (n^3/6 multiply-adds in all). The
// block then regenerates r2 from x, forms G and W in registers, and writes
// its share of P for row tile i and, off the diagonal, the transposed share
// for row tile j. Blocks run in no order, so nothing is accumulated across
// them: every pair writes its own slots of a partial array
// p_part[(row tile, other tile)], each written exactly once, and its own
// float64 scalar partials; two more kernels sum them in a fixed order. The
// result is deterministic, bit for bit from run to run. The three kernels'
// bodies are in bwd_core.cuh, which the joint backward (bwd_joint.cu,
// kernel K8) runs as its last phases.
//
// No limit on n: the TPU kernel's MAX_N = 16384 came from Mosaic's int32
// offsets and its VMEM accumulator; here offsets are 64-bit and the
// partials live in device memory (n^2 (d + 1) / 64 floats: 38 MB at
// n = 8192, d = 8).
//
// What bounds it on an H100. The SYRK is n^3/6 FP32 FMAs (9.2e10 at
// n = 8192) fed from shared memory, 4 x 4 outputs a thread, with two 16 KB
// tiles of T loaded per step (L2 serves the tiles that many pairs share).
// The epilogue is O(64 (64 + d)) per pair. A later change can move the
// SYRK to wgmma with a 3xTF32 split and keep several k-steps in flight.

#include <cuda_runtime.h>

#include "bwd_core.cuh"
#include "tile_common.cuh"

namespace {

using namespace hyperbo;

// One block per lower tile pair (bwd_core.cuh syrk_pair).
__global__ void __launch_bounds__(kThreads)
bwd_tiles(const float* __restrict__ t, const float* __restrict__ x,
          const float* __restrict__ alpha, const float* __restrict__ valid,
          const float* __restrict__ sv_ptr, int n, int d, int fam,
          float* __restrict__ p_part, double* __restrict__ s_part) {
  __shared__ float smem[kPairSmem];
  __shared__ double red[2 * kThreads / 32];
  syrk_pair<false>(t, x, alpha, valid, sv_ptr, n, d, fam, blockIdx.x, smem,
                   red, p_part, s_part);
}

__global__ void __launch_bounds__(kThreads)
bwd_reduce_p(const float* __restrict__ p_part, int n, int d,
             float* __restrict__ p) {
  reduce_p_entry<false>(
      p_part, n, d,
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x, p);
}

__global__ void __launch_bounds__(kThreads)
bwd_reduce_scalars(const double* __restrict__ s_part, long long pairs,
                   float* __restrict__ out) {
  __shared__ double red[2 * kThreads];
  reduce_scalars<false>(s_part, pairs, out, red);
}

}  // namespace

// t: (n, n) T = L^{-1}, lower; x: (n, d) scaled inputs; alpha: (n,);
// valid: (n,) 0/1 mask or null; sv: one float; p_part: (n/64, n/64, 64,
// d + 1) scratch; s_part: (2 n/64 (n/64 + 1) / 2,) float64 scratch; p:
// (n, d + 1) output; out: (2,) = (d_sv_raw, d_da). Device pointers,
// float32 unless stated; fam: 0 SE, 1 Matern-3/2, 2 Matern-5/2; stream: a
// cudaStream_t. n must be a positive multiple of 64. Returns 0 or the
// cudaError_t of the first failed launch (cudaErrorInvalidValue, without
// launching, for arguments it does not take).
extern "C" int hyperbo_mll_bwd(const float* t, const float* x,
                               const float* alpha, const float* valid,
                               const float* sv, int n, int d, int fam,
                               float* p_part, double* s_part, float* p,
                               float* out, void* stream) {
  if (n < kTile || n % kTile != 0 || d < 1 || fam < kSe || fam > kMatern52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = n / kTile;
  const long long pairs = nb * (nb + 1) / 2;
  bwd_tiles<<<static_cast<unsigned>(pairs), kThreads, 0, s>>>(
      t, x, alpha, valid, sv, n, d, fam, p_part, s_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(n) * (d + 1);
  bwd_reduce_p<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                 kThreads, 0, s>>>(p_part, n, d, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_reduce_scalars<<<1, kThreads, 0, s>>>(s_part, pairs, out);
  return static_cast<int>(cudaGetLastError());
}
