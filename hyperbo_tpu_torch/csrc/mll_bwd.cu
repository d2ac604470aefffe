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
// result is deterministic, bit for bit from run to run.
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

#include "tile_common.cuh"

namespace {

using namespace hyperbo;

__global__ void __launch_bounds__(kThreads)
bwd_tiles(const float* __restrict__ t, const float* __restrict__ x,
          const float* __restrict__ alpha, const float* __restrict__ valid,
          const float* __restrict__ sv_ptr, int n, int d, int fam,
          float* __restrict__ p_part, double* __restrict__ s_part) {
  // ti and tj hold the T tiles of a step; afterwards the same memory holds
  // tile_sqdist's input chunks, and then ti holds W.
  __shared__ float smem[2 * kTile * kLd];
  static_assert(kSqdistSmem <= 2 * kTile * kLd, "sqdist chunks must fit");
  __shared__ double red[2][kThreads / 32];
  float* ti = smem;
  float* tj = smem + kTile * kLd;
  float* xs = smem;
  const long long pair = blockIdx.x;
  int i, j;
  decode_pair(pair, &i, &j);
  const int nb = n / kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long coli = static_cast<long long>(i) * kTile;
  const long long colj = static_cast<long long>(j) * kTile;

  float acc[4][4] = {};
  for (int k = i; k < nb; ++k) {
    const long long rowk = static_cast<long long>(k) * kTile;
    __syncthreads();
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int m = idx / kTile;
      const int c = idx % kTile;
      ti[m * kLd + c] = t[(rowk + m) * n + coli + c];
      tj[m * kLd + c] = t[(rowk + m) * n + colj + c];
    }
    __syncthreads();
    for (int m = 0; m < kTile; ++m) {
      float u[4], v[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        u[p] = ti[m * kLd + ty + 16 * p];
        v[p] = tj[m * kLd + tx + 16 * p];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(u[p], v[q], acc[p][q]);
      }
    }
  }

  float r2[4][4];
  tile_sqdist(x, d, coli, colj, xs, r2);
  const float sv = sv_ptr[0];
  double gk = 0.0;
  double gtr = 0.0;
  __syncthreads();  // tile_sqdist's reads of smem are done: ti takes W
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = ty + 16 * p;
    const float ar = alpha[coli + r];
    const float vr = valid != nullptr ? valid[coli + r] : 1.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = tx + 16 * q;
      float km, nm;
      km_nm(r2[p][q], sv, fam, &km, &nm);
      if (valid != nullptr) {
        const float pr = vr * valid[colj + c];
        km *= pr;
        nm *= pr;
      }
      const float g = 0.5f * acc[p][q] - 0.5f * (ar * alpha[colj + c]);
      gk += static_cast<double>(g * km);
      if (i == j && r == c) gtr += g;
      ti[r * kLd + c] = g * nm;
    }
  }
  __syncthreads();

  // P partials: rows of tile i from W [x_j | 1]; off the diagonal, rows of
  // tile j from W^T [x_i | 1].
  const int f1 = d + 1;
  float* prow = p_part + (static_cast<long long>(i) * nb + j) * kTile * f1;
  for (int idx = tid; idx < kTile * f1; idx += kThreads) {
    const int r = idx / f1;
    const int f = idx % f1;
    float s = 0.0f;
    if (f < d) {
      for (int c = 0; c < kTile; ++c) {
        s = fmaf(ti[r * kLd + c], x[(colj + c) * d + f], s);
      }
    } else {
      for (int c = 0; c < kTile; ++c) s += ti[r * kLd + c];
    }
    prow[idx] = s;
  }
  if (i != j) {
    float* pcol = p_part + (static_cast<long long>(j) * nb + i) * kTile * f1;
    for (int idx = tid; idx < kTile * f1; idx += kThreads) {
      const int c = idx / f1;
      const int f = idx % f1;
      float s = 0.0f;
      if (f < d) {
        for (int r = 0; r < kTile; ++r) {
          s = fmaf(ti[r * kLd + c], x[(coli + r) * d + f], s);
        }
      } else {
        for (int r = 0; r < kTile; ++r) s += ti[r * kLd + c];
      }
      pcol[idx] = s;
    }
  }

  // Scalar partials: a fixed-order reduction over the block. Off the
  // diagonal the pair stands for itself and its mirror (i, j) <-> (j, i).
  for (int off = 16; off > 0; off /= 2) {
    gk += __shfl_down_sync(0xffffffffu, gk, off);
    gtr += __shfl_down_sync(0xffffffffu, gtr, off);
  }
  if (tid % 32 == 0) {
    red[0][tid / 32] = gk;
    red[1][tid / 32] = gtr;
  }
  __syncthreads();
  if (tid == 0) {
    double sgk = 0.0;
    double sgtr = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) {
      sgk += red[0][w];
      sgtr += red[1][w];
    }
    s_part[2 * pair] = (i == j) ? sgk : 2.0 * sgk;
    s_part[2 * pair + 1] = sgtr;
  }
}

// P[R][f] = sum over the other tile o of p_part[(R / 64, o)][R % 64][f].
__global__ void __launch_bounds__(kThreads)
bwd_reduce_p(const float* __restrict__ p_part, int n, int d,
             float* __restrict__ p) {
  const int f1 = d + 1;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= static_cast<long long>(n) * f1) return;
  const long long row = idx / f1;
  const int f = static_cast<int>(idx % f1);
  const int nb = n / kTile;
  const long long rb = row / kTile;
  const int r = static_cast<int>(row % kTile);
  const long long stride = static_cast<long long>(kTile) * f1;
  const float* src = p_part + rb * nb * stride + r * f1 + f;
  float s = 0.0f;
  for (int o = 0; o < nb; ++o) s += src[o * stride];
  p[idx] = s;
}

// out = (d_sv_raw, d_da): the pairs' float64 partials, in a fixed order.
__global__ void __launch_bounds__(kThreads)
bwd_reduce_scalars(const double* __restrict__ s_part, long long pairs,
                   float* __restrict__ out) {
  __shared__ double red[2][kThreads];
  const int tid = threadIdx.x;
  double a = 0.0;
  double b = 0.0;
  for (long long q = tid; q < pairs; q += kThreads) {
    a += s_part[2 * q];
    b += s_part[2 * q + 1];
  }
  red[0][tid] = a;
  red[1][tid] = b;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (tid < w) {
      red[0][tid] += red[0][tid + w];
      red[1][tid] += red[1][tid + w];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[0] = static_cast<float>(red[0][0]);
    out[1] = static_cast<float>(red[1][0]);
  }
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
