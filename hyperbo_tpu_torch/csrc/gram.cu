// Gram matrix on Hopper (kernel K5): K(x1, x2) of the SE or Matern family
// over pre-scaled inputs, with an optional ridge on the global diagonal.
//
// Replaces the Pallas kernel of hyperbo_tpu/ops/pallas_gram.py, gram
// (pallas_call at :119). For x1 (n1, d), x2 (n2, d):
//
//   out_rc = sv k(max(|x1_r|^2 + |x2_c|^2 - 2 x1_r . x2_c, 0))
//            (+ ridge where r == c, with add_ridge),
//
// the distance from one product plus the row norms, as _gram_kernel (:47-52)
// computes it, and k the family transform of tile_common.cuh gram_value.
//
// One block per 64 x 64 output tile (tile_common.cuh tile_sqdist2), with
// loads and stores guarded at the ragged edges: the output is (n1, n2)
// exactly, where the TPU kernel padded both inputs to its block grid and
// sliced the result.
//
// What bounds it on an H100. The output is n1 n2 floats written once
// (268 MB at n = 8192), against n1 n2 (2 d + 3) operations: the bytes bound
// it for any d of the repo's configurations. Each thread writes a 4 x 4
// patch, 16 consecutive floats per half-warp; the inputs are read once per
// tile from L2.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

using namespace hyperbo;

__global__ void __launch_bounds__(kThreads)
gram_tile(const float* __restrict__ x1, const float* __restrict__ x2,
          const float* __restrict__ scalars, int n1, int n2, int d, int fam,
          int add_ridge, float* __restrict__ out) {
  __shared__ float xs[kSqdistSmem];
  const long long row0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTile;
  float r2[4][4];
  tile_sqdist2(x1, n1, x2, n2, d, row0, col0, xs, r2);
  const float sv = scalars[0];
  const float ridge = scalars[1];
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long r = row0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long c = col0 + tx + 16 * q;
      if (r < n1 && c < n2) {
        float k = gram_value(r2[p][q], sv, fam);
        if (add_ridge && r == c) k += ridge;
        out[r * n2 + c] = k;
      }
    }
  }
}

}  // namespace

// x1: (n1, d), x2: (n2, d) scaled inputs; scalars: the two floats (sv,
// ridge); out: (n1, n2) output. Device pointers to float32 row-major arrays;
// fam: 0 SE, 1 Matern-3/2, 2 Matern-5/2; add_ridge: 0 or 1; stream: a
// cudaStream_t. n1, n2 and d must be positive, n1 at most 64 x 65535.
// Returns 0 or the cudaError_t of the launch (cudaErrorInvalidValue,
// without launching, for arguments it does not take).
extern "C" int hyperbo_gram(const float* x1, const float* x2,
                            const float* scalars, int n1, int n2, int d,
                            int fam, int add_ridge, float* out,
                            void* stream) {
  const long long row_tiles = (static_cast<long long>(n1) + kTile - 1) / kTile;
  if (n1 < 1 || n2 < 1 || d < 1 || row_tiles > 65535 || fam < kSe ||
      fam > kMatern52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned col_tiles = (static_cast<unsigned>(n2) + kTile - 1) / kTile;
  gram_tile<<<dim3(col_tiles, static_cast<unsigned>(row_tiles)), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(x1, x2, scalars, n1, n2, d,
                                                   fam, add_ridge, out);
  return static_cast<int>(cudaGetLastError());
}
