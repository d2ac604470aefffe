// A tiled FP32 matrix product for one thread block, written for Hopper's
// SIMT cores: the products of K3's level schedule (tri_inv.cu).
//
//   out[r][c] = sign * sum_{k_lo <= k < k_hi} a[r][k] b[k][c]
//
// over one BM x BN block tile at (r0, c0) of row-major operands with 64-bit
// leading dimensions. The caller picks [k_lo, k_hi) to skip the zero
// triangle of a triangular operand.
//
// Design. Operand tiles of BM x 16 (a) and 16 x BN (b) go to shared memory
// through cp.async (16-byte copies, L2 only), double-buffered: the copies
// of the next k-chunk are in flight while the block multiplies this one.
// 256 threads each hold a TM x TN block of the result in registers (8 x 8
// of a 128 x 128 tile, 4 x 4 of a 64 x 64 one) and read their operands as
// float4: four k of a row of a (a's tile keeps its rows, padded to 20
// floats so that the two rows a warp reads sit in different banks), four
// columns of a row of b. FP32 FMA only (no TF32): each output is one sum in
// ascending k by one thread, so the result is deterministic.
//
// Rows of a at or past m (a ragged last block tile) are read from row
// m - 1 and their outputs are not stored. Columns and k ranges must be
// multiples of BN and 16, and every address 16-byte aligned.

#pragma once

#include <cuda_runtime.h>

namespace hyperbo {

constexpr int kGemmBk = 16;
constexpr int kGemmThreads = 256;
constexpr int kGemmALd = kGemmBk + 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared floats gemm_block needs: two stages of both operand tiles.
template <int BM, int BN>
__host__ __device__ constexpr int gemm_smem_floats() {
  return 2 * (BM * kGemmALd + kGemmBk * BN);
}

template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void gemm_block(
    const float* __restrict__ a, long long lda, int m,
    const float* __restrict__ b, long long ldb, float* out, long long ldo,
    int r0, int c0, int k_lo, int k_hi, float sign, float* smem) {
  constexpr int kTx = BN / TN;
  constexpr int kTy = BM / TM;
  static_assert(kTx * kTy == kGemmThreads, "one thread per TM x TN block");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragments");
  constexpr int kMg = TM / 4;        // row groups of 4 a thread holds
  constexpr int kNg = TN / 4;        // column groups of 4
  constexpr int kRowStride = BM / kMg;
  constexpr int kColStride = BN / kNg;
  constexpr int kAStage = BM * kGemmALd;
  constexpr int kBStage = kGemmBk * BN;
  constexpr int kACopies = BM * kGemmBk / 4 / kGemmThreads;
  constexpr int kBCopies = kGemmBk * BN / 4 / kGemmThreads;
  static_assert(kACopies * 4 * kGemmThreads == BM * kGemmBk, "a copies");
  static_assert(kBCopies * 4 * kGemmThreads == kGemmBk * BN, "b copies");

  float* as = smem;
  float* bs = smem + 2 * kAStage;
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;

  auto load = [&](int stage, int k0) {
    float* as_s = as + stage * kAStage;
    float* bs_s = bs + stage * kBStage;
#pragma unroll
    for (int i = 0; i < kACopies; ++i) {
      const int idx = tid + i * kGemmThreads;
      const int r = idx / (kGemmBk / 4);
      const int c = (idx % (kGemmBk / 4)) * 4;
      const long long row = min(r0 + r, m - 1);
      cp_async16(as_s + r * kGemmALd + c, a + row * lda + k0 + c);
    }
#pragma unroll
    for (int i = 0; i < kBCopies; ++i) {
      const int idx = tid + i * kGemmThreads;
      const int k = idx / (BN / 4);
      const int c = (idx % (BN / 4)) * 4;
      cp_async16(bs_s + k * BN + c,
                 b + static_cast<long long>(k0 + k) * ldb + c0 + c);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }

  const int chunks = (k_hi - k_lo) / kGemmBk;
  load(0, k_lo);
  cp_async_commit();
  for (int kc = 0; kc < chunks; ++kc) {
    // The stage loaded here was last read in chunk kc - 1, which ended in
    // a barrier.
    if (kc + 1 < chunks) load((kc + 1) & 1, k_lo + (kc + 1) * kGemmBk);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* as_s = as + (kc & 1) * kAStage;
    const float* bs_s = bs + (kc & 1) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kGemmBk; kk += 4) {
      float av[TM][4];
#pragma unroll
      for (int g = 0; g < kMg; ++g) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float4 v = *reinterpret_cast<const float4*>(
              as_s + (g * kRowStride + ty * 4 + p) * kGemmALd + kk);
          av[g * 4 + p][0] = v.x;
          av[g * 4 + p][1] = v.y;
          av[g * 4 + p][2] = v.z;
          av[g * 4 + p][3] = v.w;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < kNg; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs_s + (kk + q) * BN + g * kColStride + tx * 4);
          bv[g * 4] = v.x;
          bv[g * 4 + 1] = v.y;
          bv[g * 4 + 2] = v.z;
          bv[g * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(av[i][q], bv[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kMg; ++g) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = g * 4 + p;
      const int r = r0 + g * kRowStride + ty * 4 + p;
      if (r >= m) continue;
#pragma unroll
      for (int h = 0; h < kNg; ++h) {
        const float4 v =
            make_float4(sign * acc[i][h * 4], sign * acc[i][h * 4 + 1],
                        sign * acc[i][h * 4 + 2], sign * acc[i][h * 4 + 3]);
        *reinterpret_cast<float4*>(out + r * ldo + c0 + h * kColStride +
                                   tx * 4) = v;
      }
    }
  }
}

}  // namespace hyperbo
