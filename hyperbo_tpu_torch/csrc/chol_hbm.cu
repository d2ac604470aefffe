// Blocked Cholesky of dense SPD matrices on Hopper (kernel K6).
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_chol_hbm.py:
// cholesky_hbm (its pallas_call at :825) and the three other VMEM layouts of
// the same factorization, cholesky_hbm_halves (:793), cholesky_hbm_wide
// (:761) and cholesky_hbm_halfwide (:723). Those stream column panels
// between HBM and VMEM by explicit DMA, left-looking, inside one kernel,
// because a pallas_call launch cost ~460 us on the TPU. Here launches cost
// a few microseconds, so the factorization is the right-looking 64-wide
// form that kernel K2 already runs (chol_core.cuh), on a batch of matrices:
//   copy_lower   L = A's lower triangle, zeros above (A is not modified);
//   chol_factor  per panel: diagonal factor + its inverse in shared memory,
//                panel solve, trailing update over the lower tile pairs.
// Only A's lower triangle is read, as LAPACK's potrf reads it. The TPU's
// bf16-split products (_pdot, _dekker_split) emulated float32 products on
// the MXU; every product here is a float32 FMA.
//
// A matrix that is not positive definite leaves a clamped pivot (L_jj <= 0
// or NaN); the wrapper (ops/chol_hbm.py) turns that matrix's factor into
// NaN.
//
// What bounds it on an H100. n^3/3 float32 operations a matrix (3.6e8 at
// n = 1024, 5 us of the card's 67 TFLOP/s) against 8 n^2 bytes in and out
// (8 MB, 2.5 us at 3.35 TB/s): by operations. At the sizes the model
// evaluation factors (n = 1024, one matrix), the chain of n / 64 diagonal
// factors, each one block while the rest of the card waits, and 3 n / 64
// launches set the time instead; a batch of matrices runs its diagonal
// factors side by side.

#include <cuda_runtime.h>

#include "chol_core.cuh"
#include "tile_common.cuh"

namespace {

using namespace hyperbo;

// Tile (blockIdx.y, blockIdx.x) of matrix blockIdx.z: A's tile at and below
// the diagonal, zeros above it.
__global__ void __launch_bounds__(kThreads)
copy_lower(const float* __restrict__ a, float* __restrict__ l, int n) {
  const long long offset = static_cast<long long>(blockIdx.z) * n * n;
  const long long row0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;
  const bool upper = blockIdx.x > blockIdx.y;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const long long at = offset + (row0 + idx / kTile) * n + col0 + idx % kTile;
    l[at] = upper ? 0.0f : a[at];
  }
}

}  // namespace

// a: (batch, n, n) input, l: (batch, n, n) output factor, dinv: (batch, 64,
// 64) scratch; all float32 device pointers, contiguous. stream: a
// cudaStream_t. n must be a positive multiple of 64 and batch at most
// 65535. Returns 0 or the cudaError_t of the first failed launch
// (cudaErrorInvalidValue, without launching, for arguments it does not
// take).
extern "C" int hyperbo_chol_hbm(const float* a, float* l, float* dinv, int n,
                                int batch, void* stream) {
  if (n < kTile || n % kTile != 0 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n / kTile;
  copy_lower<<<dim3(nb, nb, batch), kThreads, 0, s>>>(a, l, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = chol_factor<false>(l, n, batch, nullptr, dinv, nullptr, s);
  return static_cast<int>(err);
}
