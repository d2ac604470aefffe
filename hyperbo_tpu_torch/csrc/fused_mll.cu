// Fused GP marginal-likelihood forward on Hopper (kernel K2): Gram tiles,
// blocked Cholesky, forward solve and log-determinant in one call.
//
// Replaces the Pallas kernel of hyperbo_tpu/ops/pallas_mll.py, mll_fused_g
// (its pallas_call at :922; mll_fused_pm and mll_fused_hbm are older forms
// of the same computation). For scaled inputs x (n, d), y (n,), signal
// variance sv and diagonal add da it computes
//
//   K   = sv k(|x_i - x_j|^2) + da I        (k of the SE/Matern family)
//   L   = chol(K)                           (dense row-major, lower)
//   z   = L^{-1} y,  quad = |z|^2,  logdet_half = sum_j log L_jj.
//
// With a `valid` mask (1 for real rows, 0 for padded ones) every Gram entry
// touching a padded row is 0 and its diagonal stays da: exactly, where the
// TPU kernel's distance penalty left k(sqrt(P)) ~ 1e-11. The caller removes
// the padded rows' log(da)/2 from logdet_half.
//
// Steps, all on the caller's stream:
//   gram_tiles    K's lower tiles into L's buffer (upper tiles set to 0);
//   for each 64-wide column panel k (right-looking):
//     chol_diag   factor the diagonal tile in shared memory, invert it,
//                 z_k = L_kk^{-1} y_k, and this step's quad/logdet partials;
//     chol_panel  L_ik = A_ik L_kk^{-T} for the tiles below, and the forward
//                 solve's update y_i -= L_ik z_k;
//     chol_update A_ij -= L_ik L_jk^T over the lower trailing tile pairs;
//   finish        quad and logdet_half from the per-step partials, summed
//                 in a fixed order in float64 (the result is deterministic).
//
// Pivots are clamped as on the TPU: rp = 1 / sqrt(max(p, 1e-30)) and
// L_jj = p rp for p <= 0, so a matrix that is not positive definite leaves
// a diagonal entry <= 0 (or NaN), which the wrapper's _poison_non_pd turns
// into a NaN factor and value.
//
// What bounds it on an H100. The trailing updates are n^3/6 multiply-adds
// (9.2e10 at n = 8192), run as 64 x 64 x 64 FP32 FMA tiles from shared
// memory (4 x 4 outputs a thread; no TF32, no tensor cores), and each step
// reads and writes the trailing matrix once (~12 GB of traffic in all at
// n = 8192, beyond the 50 MB L2). The diagonal factor is one block per
// step, a chain of 64 dependent rank-1 updates: n / 64 of them run one
// after another while the rest of the card waits. Three launches per panel
// (386 at n = 8192) cost host time as well. A later change can fuse the
// panel into the update, look ahead on the diagonal and move the update to
// wgmma with a 3xTF32 split.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

using namespace hyperbo;

__global__ void __launch_bounds__(kThreads)
gram_tiles(const float* __restrict__ x, const float* __restrict__ valid,
           const float* __restrict__ sv_da, int n, int d, int fam,
           float* __restrict__ a) {
  __shared__ float xs[kSqdistSmem];
  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(bi) * kTile;
  const long long col0 = static_cast<long long>(bj) * kTile;
  if (bj > bi) {
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      a[(row0 + idx / kTile) * n + col0 + idx % kTile] = 0.0f;
    }
    return;
  }
  float r2[4][4];
  tile_sqdist(x, d, row0, col0, xs, r2);
  const float sv = sv_da[0];
  const float da = sv_da[1];
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long r = row0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long c = col0 + tx + 16 * q;
      float k = gram_value(r2[p][q], sv, fam);
      if (valid != nullptr && (valid[r] == 0.0f || valid[c] == 0.0f)) {
        k = 0.0f;
      }
      if (r == c) k += da;
      a[r * n + c] = k;
    }
  }
}

// Diagonal tile k: Cholesky in shared memory (two barriers per column),
// the inverse of the factor by forward substitution (four lanes per column,
// no barrier), then z_k and the partials parts[2k] = |z_k|^2 and
// parts[2k + 1] = sum log L_jj.
__global__ void __launch_bounds__(kThreads)
chol_diag(float* __restrict__ a, int n, int k, float* __restrict__ y,
          float* __restrict__ dinv, double* __restrict__ parts) {
  __shared__ float s[kTile * kLd];
  __shared__ float inv[kTile * kLd];
  __shared__ float colv[kTile];
  __shared__ float rp[kTile];
  __shared__ float ldiag[kTile];
  __shared__ float zs[kTile];
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
  if (tid < kTile) zs[tid] = y[base + tid];
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
// diagonal tile's inverse, lower), then y_i -= L_ik z_k.
__global__ void __launch_bounds__(kThreads)
chol_panel(float* __restrict__ a, int n, int k,
           const float* __restrict__ dinv, float* __restrict__ y) {
  __shared__ float as[kTile * kLd];
  __shared__ float ws[kTile * kLd];
  __shared__ float zs[kTile];
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
  if (tid < kTile) zs[tid] = y[col0 + tid];
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

__global__ void finish(const double* __restrict__ parts, int nb,
                       float* __restrict__ out) {
  if (threadIdx.x != 0) return;
  double quad = 0.0;
  double ld = 0.0;
  for (int k = 0; k < nb; ++k) {
    quad += parts[2 * k];
    ld += parts[2 * k + 1];
  }
  out[0] = static_cast<float>(quad);
  out[1] = static_cast<float>(ld);
}

}  // namespace

// x: (n, d) scaled inputs; valid: (n,) 0/1 mask or null; sv_da: the two
// floats (sv, da); y: (n,) right-hand side, overwritten with z = L^{-1} y;
// l: (n, n) output factor; dinv: (64, 64) scratch; parts: (2 n / 64,)
// float64 scratch; out: (2,) = (quad, logdet_half). All device pointers,
// float32 unless stated; fam: 0 SE, 1 Matern-3/2, 2 Matern-5/2; stream: a
// cudaStream_t. n must be a positive multiple of 64. Returns 0 or the
// cudaError_t of the first failed launch (cudaErrorInvalidValue, without
// launching, for arguments it does not take).
extern "C" int hyperbo_mll_fused(const float* x, const float* valid,
                                 const float* sv_da, float* y, int n, int d,
                                 int fam, float* l, float* dinv,
                                 double* parts, float* out, void* stream) {
  if (n < kTile || n % kTile != 0 || d < 1 || fam < kSe || fam > kMatern52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n / kTile;
  gram_tiles<<<dim3(nb, nb), kThreads, 0, s>>>(x, valid, sv_da, n, d, fam, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int k = 0; k < nb; ++k) {
    chol_diag<<<1, kThreads, 0, s>>>(l, n, k, y, dinv, parts);
    const int m = nb - k - 1;
    if (m > 0) {
      chol_panel<<<m, kThreads, 0, s>>>(l, n, k, dinv, y);
      chol_update<<<m * (m + 1) / 2, kThreads, 0, s>>>(l, n, k);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  finish<<<1, 32, 0, s>>>(parts, nb, out);
  return static_cast<int>(cudaGetLastError());
}
