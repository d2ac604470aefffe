// Device code shared by the fused-NLL kernels (fused_mll.cu, tri_inv.cu,
// mll_bwd.cu, bwd_core.cuh, bwd_joint.cu), the blocked Cholesky
// (chol_core.cuh, chol_hbm.cu) and the Gram kernel (gram.cu): the
// 64 x 64 tile geometry, the squared-distance tile and the
// kernel-family transforms of hyperbo_tpu/ops/pallas_mll.py
// (_gram_transform) and hyperbo_tpu/ops/pallas_mll_bwd.py (_km_nm).
//
// Layout. Every n x n matrix of the fused path (K2's factor L, K3's input L
// and output T = L^{-1}, K4's input T) is one dense row-major float32
// array, lower triangular, with n a multiple of kTile. Offsets into it are
// 64-bit: n = 32768 already puts n^2 floats past 2^31 bytes.
//
// Thread layout of a 64 x 64 output tile: 256 threads as 16 x 16, thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 a and columns tx + 16 b
// (a, b < 4). Shared tiles are stored with row stride kLd = 65, so reading
// tile[row][m] across the 16 tx of a half-warp hits 16 distinct banks.

#pragma once

#include <cuda_runtime.h>

namespace hyperbo {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kLd = kTile + 1;
constexpr int kFeatChunk = 32;
constexpr int kFeatLd = kFeatChunk + 1;
// Shared floats tile_sqdist needs: two (kTile, kFeatChunk) input chunks.
constexpr int kSqdistSmem = 2 * kTile * kFeatLd;

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

enum Family { kSe = 0, kMatern32 = 1, kMatern52 = 2 };

// Lower tile pair (i, j), j <= i, of linear index t = i (i + 1) / 2 + j.
__device__ __forceinline__ void decode_pair(long long t, int* i, int* j) {
  int r = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) *
                           0.5);
  while (static_cast<long long>(r) * (r + 1) / 2 > t) --r;
  while (static_cast<long long>(r + 1) * (r + 2) / 2 <= t) ++r;
  *i = r;
  *j = static_cast<int>(t - static_cast<long long>(r) * (r + 1) / 2);
}

// Squared distances of this thread's 4 x 4 entries of tile (row0, col0):
// r2[a][b] = max(|x_R|^2 + |x_C|^2 - 2 x_R . x_C, 0) with R = row0 + ty +
// 16 a, C = col0 + tx + 16 b: one dot product plus the two row norms, as
// the TPU kernels' [-2x, |x|^2, 1] . [x, 1, |x|^2] embedding computes it.
// x is (n, d) row-major; xs is kSqdistSmem shared floats. Every thread of
// the block must call it (it synchronizes).
__device__ __forceinline__ void tile_sqdist(const float* __restrict__ x,
                                            int d, long long row0,
                                            long long col0, float* xs,
                                            float r2[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float* xi = xs;
  float* xj = xs + kTile * kFeatLd;
  float dot[4][4] = {};
  float sqr[4] = {};
  float sqc[4] = {};
  for (int f0 = 0; f0 < d; f0 += kFeatChunk) {
    const int fw = min(kFeatChunk, d - f0);
    __syncthreads();
    for (int idx = tid; idx < kTile * kFeatChunk; idx += kThreads) {
      const int r = idx / kFeatChunk;
      const int f = idx % kFeatChunk;
      xi[r * kFeatLd + f] = f < fw ? x[(row0 + r) * d + f0 + f] : 0.0f;
      xj[r * kFeatLd + f] = f < fw ? x[(col0 + r) * d + f0 + f] : 0.0f;
    }
    __syncthreads();
    for (int f = 0; f < fw; ++f) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = xi[(ty + 16 * q) * kFeatLd + f];
        b[q] = xj[(tx + 16 * q) * kFeatLd + f];
        sqr[q] = fmaf(a[q], a[q], sqr[q]);
        sqc[q] = fmaf(b[q], b[q], sqc[q]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dot[p][q] = fmaf(a[p], b[q], dot[p][q]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r2[p][q] = fmaxf(sqr[p] + sqc[q] - 2.0f * dot[p][q], 0.0f);
    }
  }
}

// tile_sqdist between two inputs: rows row0 + ty + 16 a of x1 (n1, d)
// against rows col0 + tx + 16 b of x2 (n2, d). Rows past n1 or n2 load as
// zeros (a ragged edge tile; the caller stores none of their entries).
__device__ __forceinline__ void tile_sqdist2(const float* __restrict__ x1,
                                             long long n1,
                                             const float* __restrict__ x2,
                                             long long n2, int d,
                                             long long row0, long long col0,
                                             float* xs, float r2[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float* xi = xs;
  float* xj = xs + kTile * kFeatLd;
  float dot[4][4] = {};
  float sqr[4] = {};
  float sqc[4] = {};
  for (int f0 = 0; f0 < d; f0 += kFeatChunk) {
    const int fw = min(kFeatChunk, d - f0);
    __syncthreads();
    for (int idx = tid; idx < kTile * kFeatChunk; idx += kThreads) {
      const int r = idx / kFeatChunk;
      const int f = idx % kFeatChunk;
      xi[r * kFeatLd + f] =
          f < fw && row0 + r < n1 ? x1[(row0 + r) * d + f0 + f] : 0.0f;
      xj[r * kFeatLd + f] =
          f < fw && col0 + r < n2 ? x2[(col0 + r) * d + f0 + f] : 0.0f;
    }
    __syncthreads();
    for (int f = 0; f < fw; ++f) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = xi[(ty + 16 * q) * kFeatLd + f];
        b[q] = xj[(tx + 16 * q) * kFeatLd + f];
        sqr[q] = fmaf(a[q], a[q], sqr[q]);
        sqc[q] = fmaf(b[q], b[q], sqc[q]);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dot[p][q] = fmaf(a[p], b[q], dot[p][q]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r2[p][q] = fmaxf(sqr[p] + sqc[q] - 2.0f * dot[p][q], 0.0f);
    }
  }
}

// k(r2) of the family, times sv (pallas_mll._gram_transform).
__device__ __forceinline__ float gram_value(float r2, float sv, int fam) {
  if (fam == kSe) return sv * expf(-0.5f * r2);
  if (fam == kMatern32) {
    const float r = kSqrt3 * sqrtf(r2);
    return sv * ((1.0f + r) * expf(-r));
  }
  const float r = kSqrt5 * sqrtf(r2);
  return sv * ((1.0f + r + (r * r) * (1.0f / 3.0f)) * expf(-r));
}

// (km, nm) = (sv k(r2), -2 sv dk/dr2) of the family (pallas_mll_bwd._km_nm,
// with its r^2 floor under the Matern square root).
__device__ __forceinline__ void km_nm(float r2, float sv, int fam, float* km,
                                      float* nm) {
  if (fam == kSe) {
    const float k = sv * expf(-0.5f * r2);
    *km = k;
    *nm = k;
    return;
  }
  if (fam == kMatern32) {
    const float r = kSqrt3 * sqrtf(fmaxf(r2, 1e-36f));
    const float e = expf(-r);
    *km = sv * (1.0f + r) * e;
    *nm = 3.0f * sv * e;
    return;
  }
  const float r = kSqrt5 * sqrtf(fmaxf(r2, 1e-36f));
  const float e = expf(-r);
  *km = sv * (1.0f + r + (r * r) * (1.0f / 3.0f)) * e;
  *nm = (5.0f / 3.0f) * sv * (1.0f + r) * e;
}

}  // namespace hyperbo
