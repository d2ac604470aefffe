// Device code shared by the two dense Cholesky kernels, K7 (chol_panel.cu)
// and K6 (chol_hbm.cu): the factor of a 64 x 64 diagonal block on four warps
// of one block, and the 64-deep tile product that updates a block column,
// on the shared-memory layout of rows kLd floats apart (16-byte aligned).
//
// Pivots take rsqrt.approx.ftz with no branch on the chain: a non-positive
// pivot gives NaN or inf, so a matrix that is not positive definite comes
// out non-finite, and the wrappers turn its whole factor into NaN. Every
// output is one sum in a fixed order of FP32 FMAs. The functions have
// internal linkage (static): each kernel's source compiles its own copy.

#pragma once

#include <cuda_runtime.h>

namespace hyperbo {
namespace chol64 {

constexpr int kB = 64;                    // block column width
constexpr int kS = 16;                    // the diagonal factor's sub-panels
constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;       // a warp group
constexpr int kLead = 2;                  // the warp that factors ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLd = kB + 4;               // row stride: rows 16-byte aligned

// Cycles of the parts of one block, summed by one thread (in local memory,
// written out once at the end); a no-op without stamps.
template <int kSlots>
struct Laps {
  long long* out;
  long long last;
  long long sum[kSlots];
  __device__ void add(int slot) {
    if (out != nullptr) {
      const long long now = clock64();
      sum[slot] += now - last;
      last = now;
    }
  }
  // Adds the cycles since `since` to slot without ending the lap.
  __device__ void part(int slot, long long& since) {
    if (out != nullptr) {
      const long long now = clock64();
      sum[slot] += now - since;
      since = now;
    }
  }
};

static __device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

static __device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// 1 / sqrt(p), flushing denormals: on the chain of every pivot, so without
// the IEEE square root's slow path. A non-positive pivot gives NaN or inf
// (and then a diagonal entry p / sqrt(p) that is NaN), as the wrappers
// expect of a matrix that is not positive definite.
static __device__ __forceinline__ float rsqrt_ftz(float p) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(p));
  return r;
}

// Barrier 0 is the block's; 1 and 2 those of warps 0-3 and warps 4-7.
template <int kBar>
static __device__ __forceinline__ void sync_bar() {
  if (kBar == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(kBar), "r"(kHalf) : "memory");
  }
}

// x . y over kS, both in registers, four partial sums in a fixed order.
static __device__ __forceinline__ float dot_reg(const float (&x)[kS],
                                                const float (&y)[kS]) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < kS; m += 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(x[m + e], y[m + e], acc[e]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

static __device__ __forceinline__ void load_s(const float* src,
                                              float (&x)[kS]) {
#pragma unroll
  for (int m = 0; m < kS; m += 4) {
    const float4 x4 = ld4(src + m);
    x[m] = x4.x;
    x[m + 1] = x4.y;
    x[m + 2] = x4.z;
    x[m + 3] = x4.w;
  }
}

// One warp factors the sub-block col[s0:s0+16, s0:s0+16] (identity-padded
// where ragged), lane i holding row s0 + i in registers and the column's
// entries passed by shuffles, column by column: the pivot p times
// 1 / sqrt(p) on the diagonal, the column below scaled by 1 / sqrt(p), then
// each later column c less the column times its entry in row c. Writes the
// sub-block back (zeros above its diagonal), its strictly lower part to lt
// transposed (lt[j * 64 + i] = L[i][j]) and 1 / sqrt(p) to rdiag.
static __device__ __forceinline__ void factor_sub_block(float* col, int s0,
                                                        int w, float* lt,
                                                        float* rdiag) {
  const int lane = threadIdx.x % 32;
  const int sw = min(kS, w - s0);
  float v[kS];
  float rd[kS];
  const float* src = col + (s0 + min(lane, sw - 1)) * kLd + s0;
#pragma unroll
  for (int m = 0; m < kS; m += 4) {
    const float4 x4 = ld4(src + m);
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[m + e] = (lane < sw && m + e < sw) ? xv[e]
                                           : (lane == m + e ? 1.0f : 0.0f);
    }
  }
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const float p = __shfl_sync(kFull, v[j], j);
    rd[j] = rsqrt_ftz(p);
    v[j] = lane > j ? v[j] * rd[j] : (lane == j ? p * rd[j] : v[j]);
#pragma unroll
    for (int c = j + 1; c < kS; ++c) {
      v[c] = fmaf(-v[j], __shfl_sync(kFull, v[j], c), v[c]);
    }
  }
  if (lane < sw) {
    float* dst = col + (s0 + lane) * kLd + s0;
#pragma unroll
    for (int m = 0; m < kS; m += 4) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = m + e <= lane ? v[m + e] : 0.0f;
      st4(dst + m, make_float4(o[0], o[1], o[2], o[3]));
    }
#pragma unroll
    for (int m = 0; m < kS; ++m) {
      if (m < lane) lt[(s0 + m) * kB + s0 + lane] = v[m];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (j < sw) rdiag[s0 + j] = rd[j];
    }
  }
}

// col[r][c] -= x_r . x_c over columns s0 .. s0 + 15, for the 4 x 4 quad of
// rows r0 .. r0 + 3 and columns c0 .. c0 + 3 (rows and columns past w read
// clamped, rows past w not written; a diagonal quad also writes entries
// above the diagonal, which nothing reads).
static __device__ __forceinline__ void trailing_quad(float* col, int s0,
                                                     int w, int r0, int c0) {
  float xr[4][kS], xc[4][kS];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    load_s(col + min(r0 + e, w - 1) * kLd + s0, xr[e]);
    load_s(col + min(c0 + e, w - 1) * kLd + s0, xc[e]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (r0 + e < w) {
      float* dst = col + (r0 + e) * kLd + c0;
      float4 o = ld4(dst);
      o.x -= dot_reg(xr[e], xc[0]);
      o.y -= dot_reg(xr[e], xc[1]);
      o.z -= dot_reg(xr[e], xc[2]);
      o.w -= dot_reg(xr[e], xc[3]);
      st4(dst, o);
    }
  }
}

// Warps 0-3 factor the block column's w x w diagonal block col[0:w, 0:w]
// in place, right-looking over 16-wide sub-panels s0, one sub-block ahead:
// warp 2 factors sub-block s0 (factor_sub_block) while the other warps
// finish the trailing update of the sub-panel before; then warps 0-1 solve
// rows s0 + 16 + t < w against it, x <- x L_s^-T in the same column order
// (L_s read from lt); then warp 2 subtracts the sub-panel's products from
// the next sub-block (4 x 4 quads) and factors it, while warps 0, 1 and 3
// subtract them from the rows below. Two barriers of the four warps a
// sub-panel. Also leaves L11^T in lt and 1 / sqrt of the pivots in rdiag,
// for the panel's solve. Laps slots kSplit .. kSplit + 2 take the first
// sub-block factor, the row solves, and the trailing updates with the next
// sub-block's factor.
template <int kSplit, class LapsT>
static __device__ void factor_diagonal(float* col, int w, float* lt,
                                       float* rdiag, LapsT& laps) {
  const int t = threadIdx.x;
  const int warp = t / 32;
  long long since = laps.last;
  if (warp == kLead) factor_sub_block(col, 0, w, lt, rdiag);
  sync_bar<1>();
  laps.part(kSplit, since);
  for (int s0 = 0; s0 < w; s0 += kS) {
    if (t < 64) {
      const int r = s0 + kS + t;
      float* row = col + min(r, w - 1) * kLd + s0;
      float x[kS];
      load_s(row, x);
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        x[j] *= rdiag[s0 + j];
        const float* lj = lt + (s0 + j) * kB + s0;
#pragma unroll
        for (int c4 = (j + 1) / 4 * 4; c4 < kS; c4 += 4) {
          const float4 l4 = ld4(lj + c4);
          if (c4 > j) x[c4] = fmaf(-x[j], l4.x, x[c4]);
          if (c4 + 1 > j) x[c4 + 1] = fmaf(-x[j], l4.y, x[c4 + 1]);
          if (c4 + 2 > j) x[c4 + 2] = fmaf(-x[j], l4.z, x[c4 + 2]);
          if (c4 + 3 > j) x[c4 + 3] = fmaf(-x[j], l4.w, x[c4 + 3]);
        }
      }
      if (r < w) {
#pragma unroll
        for (int m = 0; m < kS; m += 4) {
          st4(row + m, make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]));
          lt[(s0 + m) * kB + r] = x[m];
          lt[(s0 + m + 1) * kB + r] = x[m + 1];
          lt[(s0 + m + 2) * kB + r] = x[m + 2];
          lt[(s0 + m + 3) * kB + r] = x[m + 3];
        }
      }
    }
    sync_bar<1>();
    laps.part(kSplit + 1, since);
    if (s0 + kS >= w) break;
    // Quads (a, b), b <= a < m, of rows and columns s0 + 16 + 4 a, 4 b.
    const int m = (w - s0 - kS + 3) / 4;
    if (warp == kLead) {
      const int lane = t % 32;
      const int a = lane < 1 ? 0 : lane < 3 ? 1 : lane < 6 ? 2 : 3;
      const int b = lane - a * (a + 1) / 2;
      if (lane < 10 && a < m) {
        trailing_quad(col, s0, w, s0 + kS + 4 * a, s0 + kS + 4 * b);
      }
      __syncwarp();
      factor_sub_block(col, s0 + kS, w, lt, rdiag);
    } else {
      const int u = warp < kLead ? t : t - 32;
      const int quads = m * m;
      for (int q = u; q < quads; q += kHalf - 32) {
        const int a = q / m;
        const int b = q % m;
        if (a >= 4 && b <= a) {
          trailing_quad(col, s0, w, s0 + kS + 4 * a, s0 + kS + 4 * b);
        }
      }
    }
    sync_bar<1>();
    laps.part(kSplit + 2, since);
  }
}

// col[r0 + r][c] -= sum_k as[r][k] bt[c][k] for the tile's rows below
// `rows`, with kN threads: thread t takes rows t / 16 + (kN / 16) p and
// columns t % 16 + 16 q, four k at a time, one fixed-order sum each.
template <int kN>
static __device__ __forceinline__ void tile_product(float* col, int rows,
                                                    int r0, const float* as,
                                                    const float* bt, int t) {
  constexpr int kR = kN / 16;
  constexpr int kP = kB / kR;
  const int ty = t / 16;
  const int tx = t % 16;
  float acc[kP][4] = {};
#pragma unroll 2
  for (int k = 0; k < kB; k += 4) {
    float4 a4[kP], b4[4];
#pragma unroll
    for (int p = 0; p < kP; ++p) a4[p] = ld4(as + (ty + kR * p) * kLd + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) b4[q] = ld4(bt + (tx + 16 * q) * kLd + k);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[p][q] = fmaf(a4[p].x, b4[q].x, acc[p][q]);
        acc[p][q] = fmaf(a4[p].y, b4[q].y, acc[p][q]);
        acc[p][q] = fmaf(a4[p].z, b4[q].z, acc[p][q]);
        acc[p][q] = fmaf(a4[p].w, b4[q].w, acc[p][q]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int r = r0 + ty + kR * p;
    if (r < rows) {
#pragma unroll
      for (int q = 0; q < 4; ++q) col[r * kLd + tx + 16 * q] -= acc[p][q];
    }
  }
}

}  // namespace chol64
}  // namespace hyperbo
