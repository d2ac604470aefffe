// Blocked right-looking Cholesky on the dense row-major layout of
// tile_common.cuh, for the fused NLL forward (fused_mll.cu, kernel K2)
// alone. The standalone factorization K6 (chol_hbm.cu) no longer runs it:
// it is one persistent launch with lookahead on chol_diag64.cuh's diagonal
// factor, whose lessons K2's redesign can take.
//
// The matrix A (n x n, n a multiple of kTile) is factored in place: its lower
// triangle is read, L is written over it, and the strict upper triangle is
// left as the caller put it (K2 writes zeros there first). For
// each 64-wide column panel k, on the caller's stream:
//   chol_diag   factor the diagonal tile in shared memory and invert it;
//               with kSolve, also z_k = L_kk^{-1} y_k and this step's
//               partials parts[2k] = |z_k|^2, parts[2k + 1] = sum log L_jj;
//   chol_panel  L_ik = A_ik L_kk^{-T} for the tiles below (and, with kSolve,
//               the forward solve's update y_i -= L_ik z_k);
//   chol_update A_ij -= L_ik L_jk^T over the lower trailing tile pairs.
// blockIdx.y indexes a batch of independent matrices, n * n floats apart
// (with dinv 64 * 64 floats apart); K2 runs a batch of one.
//
// Pivots are clamped as on the TPU: rp = 1 / sqrt(max(p, 1e-30)) and
// L_jj = p rp for p <= 0, so a matrix that is not positive definite leaves
// a diagonal entry <= 0 (or NaN); the Python wrappers turn such a factor
// into NaN.

#pragma once

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace hyperbo {

// Diagonal tile k: Cholesky in shared memory (two barriers per column),
// the inverse of the factor by forward substitution (four lanes per column,
// no barrier), then (kSolve) z_k and the partials.
template <bool kSolve>
__global__ void __launch_bounds__(kThreads)
chol_diag(float* __restrict__ a, int n, int k, float* __restrict__ y,
          float* __restrict__ dinv, double* __restrict__ parts) {
  __shared__ float s[kTile * kLd];
  __shared__ float inv[kTile * kLd];
  __shared__ float colv[kTile];
  __shared__ float rp[kTile];
  __shared__ float ldiag[kTile];
  __shared__ float zs[kTile];
  a += static_cast<long long>(blockIdx.y) * n * n;
  dinv += static_cast<long long>(blockIdx.y) * kTile * kTile;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(k) * kTile;
  for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile;
    const int c = idx % kTile;
    s[r * kLd + c] = a[(base + r) * n + base + c];
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int j = 0; j < kTile; ++j) {
    const float p = s[j * kLd + j];
    const float rpj = 1.0f / sqrtf(fmaxf(p, 1e-30f));
    if (tid < kTile && tid > j) colv[tid] = s[tid * kLd + j] * rpj;
    if (tid == j) {
      rp[j] = rpj;
      ldiag[j] = p > 0.0f ? sqrtf(p) : p * rpj;
    }
    __syncthreads();
    // Rows r > j (one warp a row), columns j < c <= r: the lower trailing
    // triangle. Column j takes the scaled column; nobody reads it here.
    for (int r = j + 1 + warp; r < kTile; r += kThreads / 32) {
      const float cr = colv[r];
      for (int c = j + 1 + lane; c <= r; c += 32) {
        s[r * kLd + c] -= cr * colv[c];
      }
      if (lane == 0) s[r * kLd + j] = cr;
    }
    __syncthreads();
  }

  // inv = L_kk^{-1}, lower: lanes 4c .. 4c+3 solve column c together, lane
  // q summing the terms m = q mod 4. Row r of the column is
  // rp_r (delta_rc - sum_{m<r} L_rm inv_mc); entries above the diagonal
  // come out 0. Each lane reads only the inv entries it wrote itself.
  {
    const int c = tid / 4;
    const int q = tid % 4;
    for (int r = 0; r < kTile; ++r) {
      float acc = 0.0f;
      for (int m = q; m < r; m += 4) {
        acc = fmaf(s[r * kLd + m], inv[m * kLd + c], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const float val = rp[r] * ((r == c ? 1.0f : 0.0f) - acc);
      if (r % 4 == q) inv[r * kLd + c] = val;
    }
  }
  if (kSolve && tid < kTile) zs[tid] = y[base + tid];
  __syncthreads();

  for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile;
    const int c = idx % kTile;
    float lv = 0.0f;
    if (c < r) lv = s[r * kLd + c];
    else if (c == r) lv = ldiag[r];
    a[(base + r) * n + base + c] = lv;
    dinv[idx] = inv[r * kLd + c];
  }
  if (!kSolve) return;
  float z = 0.0f;
  if (tid < kTile) {
    for (int m = 0; m <= tid; ++m) z = fmaf(inv[tid * kLd + m], zs[m], z);
  }
  __syncthreads();
  if (tid < kTile) {
    zs[tid] = z;
    y[base + tid] = z;
  }
  __syncthreads();
  if (tid == 0) {
    double quad = 0.0;
    double ld = 0.0;
    for (int m = 0; m < kTile; ++m) {
      quad += static_cast<double>(zs[m]) * zs[m];
      ld += log(static_cast<double>(ldiag[m]));
    }
    parts[2 * k] = quad;
    parts[2 * k + 1] = ld;
  }
}

// Row tile i = k + 1 + blockIdx.x of panel k: L_ik = A_ik inv^T (inv the
// diagonal tile's inverse, lower), then (kSolve) y_i -= L_ik z_k.
template <bool kSolve>
__global__ void __launch_bounds__(kThreads)
chol_panel(float* __restrict__ a, int n, int k,
           const float* __restrict__ dinv, float* __restrict__ y) {
  __shared__ float as[kTile * kLd];
  __shared__ float ws[kTile * kLd];
  __shared__ float zs[kTile];
  a += static_cast<long long>(blockIdx.y) * n * n;
  dinv += static_cast<long long>(blockIdx.y) * kTile * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long row0 = static_cast<long long>(k + 1 + blockIdx.x) * kTile;
  const long long col0 = static_cast<long long>(k) * kTile;
  for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile;
    const int c = idx % kTile;
    as[r * kLd + c] = a[(row0 + r) * n + col0 + c];
    ws[r * kLd + c] = dinv[idx];
  }
  if (kSolve && tid < kTile) zs[tid] = y[col0 + tid];
  __syncthreads();
  float acc[4][4] = {};
  for (int m = 0; m < kTile; ++m) {
    float u[4], v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      u[p] = as[(ty + 16 * p) * kLd + m];
      v[p] = ws[(tx + 16 * p) * kLd + m];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(u[p], v[q], acc[p][q]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = tx + 16 * q;
      as[r * kLd + c] = acc[p][q];
      a[(row0 + r) * n + col0 + c] = acc[p][q];
    }
  }
  if (!kSolve) return;
  __syncthreads();
  if (tid < kTile) {
    float dz = 0.0f;
    for (int c = 0; c < kTile; ++c) dz = fmaf(as[tid * kLd + c], zs[c], dz);
    y[row0 + tid] -= dz;
  }
}

// A_ij -= L_ik L_jk^T for the lower tile pairs k < j <= i; blockIdx.x
// numbers the pairs of the trailing matrix (decode_pair).
__global__ void __launch_bounds__(kThreads)
chol_update(float* __restrict__ a, int n, int k) {
  __shared__ float li[kTile * kLd];
  __shared__ float lj[kTile * kLd];
  a += static_cast<long long>(blockIdx.y) * n * n;
  int ii, jj;
  decode_pair(blockIdx.x, &ii, &jj);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long rowi = static_cast<long long>(k + 1 + ii) * kTile;
  const long long rowj = static_cast<long long>(k + 1 + jj) * kTile;
  const long long colk = static_cast<long long>(k) * kTile;
  for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile;
    const int c = idx % kTile;
    li[r * kLd + c] = a[(rowi + r) * n + colk + c];
    lj[r * kLd + c] = a[(rowj + r) * n + colk + c];
  }
  __syncthreads();
  float acc[4][4] = {};
  for (int m = 0; m < kTile; ++m) {
    float u[4], v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      u[p] = li[(ty + 16 * p) * kLd + m];
      v[p] = lj[(tx + 16 * p) * kLd + m];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(u[p], v[q], acc[p][q]);
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float* row = a + (rowi + ty + 16 * p) * n + rowj;
#pragma unroll
    for (int q = 0; q < 4; ++q) row[tx + 16 * q] -= acc[p][q];
  }
}

// The whole factorization of `batch` matrices: three launches a panel.
// y and parts are read only with kSolve. Returns the first launch error.
template <bool kSolve>
inline cudaError_t chol_factor(float* a, int n, int batch, float* y,
                               float* dinv, double* parts,
                               cudaStream_t s) {
  const int nb = n / kTile;
  for (int k = 0; k < nb; ++k) {
    chol_diag<kSolve><<<dim3(1, batch), kThreads, 0, s>>>(a, n, k, y, dinv,
                                                          parts);
    const int m = nb - k - 1;
    if (m > 0) {
      chol_panel<kSolve><<<dim3(m, batch), kThreads, 0, s>>>(a, n, k, dinv,
                                                             y);
      chol_update<<<dim3(m * (m + 1) / 2, batch), kThreads, 0, s>>>(a, n, k);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace hyperbo
