// Device code shared by the two persistent Cholesky kernels, K6 (chol_hbm.cu)
// and K2 (fused_mll.cu): the per-tile counters in global memory that order
// their blocks, the copies of 64-wide tile rows between memory and shared
// rows kLd apart, and the row solve against a 64 x 64 diagonal factor.
//
// Counters order work and never touch data. A writer releases after its
// block's stores (barrier, fence, store of the counter); a reader's one
// thread spins on relaxed loads, then fences before its block's barrier.
// Data written in a launch is read through L2 only (cp.async.cg).

#pragma once

#include <cuda_runtime.h>

#include "chol_diag64.cuh"
#include "gemm_core.cuh"

namespace hyperbo {
namespace chol64 {

static __device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

static __device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

static __device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Spins until *flag >= want. A wait that outlasts any real one (2^26
// polls) traps, so a fault in the schedule ends the launch with an error
// instead of hanging the card.
static __device__ __forceinline__ void spin_until(const int* flag, int want) {
  for (unsigned polls = 0; ld_relaxed(flag) < want; ++polls) {
    if (polls == (1u << 26)) __trap();
    __nanosleep(32);
  }
}

// After the writer block's barrier: its stores are released with the
// counter's new value.
static __device__ __forceinline__ void release(int* flag, int value) {
  fence_acq_rel();
  st_relaxed(flag, value);
}

// rows x 64 floats of a row-major matrix (row stride ld) into shared rows
// kLd apart, by cp.async (L2 only) from kN threads.
template <int kN>
static __device__ __forceinline__ void copy_rows_async(float* dst,
                                                       const float* src,
                                                       long long ld, int rows,
                                                       int t) {
  for (int idx = t; idx < rows * (kB / 4); idx += kN) {
    const int r = idx / (kB / 4);
    const int c = 4 * (idx % (kB / 4));
    cp_async16(dst + r * kLd + c, src + r * ld + c);
  }
}

// `count` contiguous floats (a multiple of 4) by cp.async.
template <int kN>
static __device__ __forceinline__ void copy_async(float* dst,
                                                  const float* src, int count,
                                                  int t) {
  for (int c = 4 * t; c < count; c += 4 * kN) cp_async16(dst + c, src + c);
}

// rows x 64 shared floats (rows kLd apart) to a row-major matrix (row
// stride ld); `lower` zeroes the entries above the diagonal.
template <int kN>
static __device__ __forceinline__ void store_rows(float* dst, long long ld,
                                                  const float* src, int rows,
                                                  bool lower, int t) {
  for (int idx = t; idx < rows * (kB / 4); idx += kN) {
    const int r = idx / (kB / 4);
    const int c = 4 * (idx % (kB / 4));
    float4 v = ld4(src + r * kLd + c);
    if (lower) {
      if (c > r) v.x = 0.0f;
      if (c + 1 > r) v.y = 0.0f;
      if (c + 2 > r) v.z = 0.0f;
      if (c + 3 > r) v.w = 0.0f;
    }
    st4(dst + r * ld + c, v);
  }
}

// One row of 64 <- row L^-T (lt = L^T and rdiag = 1 / sqrt of the pivots
// of a 64 x 64 diagonal factor), by 16-column groups: a group is solved in
// registers (scale column j by 1 / sqrt(p_j), take x_j L[c][j] from the
// group's later columns), then its products leave the row's later groups,
// one group at a time. Each entry takes K7's solve_panel's operations in
// its order, so the same bits, from loops whose bodies stay in the
// instruction cache: solve_panel's unrolled 64-column sweep (some 40 KB of
// code, run once a step) was fetched afresh each step and took three times
// as long.
static __device__ __forceinline__ void solve_row(float* row, const float* lt,
                                                 const float* rdiag) {
#pragma unroll 1
  for (int g = 0; g < kB; g += kS) {
    float x[kS];
    load_s(row + g, x);
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      x[j] *= rdiag[g + j];
      const float* lj = lt + (g + j) * kB + g;
#pragma unroll
      for (int c4 = (j + 1) / 4 * 4; c4 < kS; c4 += 4) {
        const float4 l4 = ld4(lj + c4);
        if (c4 > j) x[c4] = fmaf(-x[j], l4.x, x[c4]);
        if (c4 + 1 > j) x[c4 + 1] = fmaf(-x[j], l4.y, x[c4 + 1]);
        if (c4 + 2 > j) x[c4 + 2] = fmaf(-x[j], l4.z, x[c4 + 2]);
        if (c4 + 3 > j) x[c4 + 3] = fmaf(-x[j], l4.w, x[c4 + 3]);
      }
    }
#pragma unroll
    for (int m = 0; m < kS; m += 4) {
      st4(row + g + m, make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]));
    }
#pragma unroll 1
    for (int h = g + kS; h < kB; h += kS) {
      float y[kS];
      load_s(row + h, y);
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const float* lj = lt + (g + j) * kB + h;
#pragma unroll
        for (int c4 = 0; c4 < kS; c4 += 4) {
          const float4 l4 = ld4(lj + c4);
          y[c4] = fmaf(-x[j], l4.x, y[c4]);
          y[c4 + 1] = fmaf(-x[j], l4.y, y[c4 + 1]);
          y[c4 + 2] = fmaf(-x[j], l4.z, y[c4 + 2]);
          y[c4 + 3] = fmaf(-x[j], l4.w, y[c4 + 3]);
        }
      }
#pragma unroll
      for (int m = 0; m < kS; m += 4) {
        st4(row + h + m, make_float4(y[m], y[m + 1], y[m + 2], y[m + 3]));
      }
    }
  }
}

}  // namespace chol64
}  // namespace hyperbo
