// The body of kernel K4 (mll_bwd.cu): the fused NLL's SYRK backward on one
// lower pair (I, J), J <= I, of 128 x 128 tiles, and the fixed-order sum of
// the pairs' P partials.
//
//   pair_block     (K^{-1})_IJ = sum_{k >= 128 I} T[k, I]^T T[k, J] in
//                  registers, then r2 from x, G and W on the tile, this
//                  pair's slots of p_part and its float64 scalar partials;
//   reduce_p_entry one entry of P from the pairs' partials.
//
// Tiles are 128 wide; where n / 64 is odd the last tile row and column are
// 64 wide (the copies, x rows, alpha and the stores stop at the width; the
// entries past it are formed from stale shared memory and masked to 0).
//
// The SYRK. 256 threads, each 8 x 8 outputs: rows (p / 4) 64 + 4 ty + p % 4
// and columns (q / 4) 64 + 4 tx + q % 4, a warp as 4 x 8 threads, so that a
// warp's float4 reads of a chunk row touch 64 bytes of I's operand and 128
// of J's: one shared-memory wavefront each, 4 for 64 FMA a thread, where a
// 64 x 64 tile with 4 x 4 a thread read 8 floats for 16 FMA. Both operands
// are the same rows of T, k-major (row k of the chunk holds T[k, I] and
// T[k, J] as 128 contiguous floats each), so they go to shared memory as
// they lie in T, by 16-byte cp.async.cg copies (L2 only), kBk rows a stage,
// through a ring of kStages stages: while the block multiplies one chunk
// the next kStages - 1 are in flight, with one barrier a chunk. A diagonal
// pair loads its one operand once. FP32 FMA only (no TF32), each output one
// sum in ascending k by one thread.
//
// The epilogue. The accumulators go to shared memory (a 128 x 132 tile);
// r2 = max(|x_R|^2 + |x_C|^2 - 2 x_R . x_C, 0) is formed from x's features
// 32 at a time, transposed in shared memory, in the distance form of
// tile_common.cuh tile_sqdist; then G and W in place of K^{-1}, the scalar
// partials in float64, and the P partials as one sum a slot by one thread
// in ascending index, from W and [x | 1]'s features (again 32 at a time)
// in shared memory.

#pragma once

#include <cuda_runtime.h>

#include "gemm_core.cuh"
#include "tile_common.cuh"

namespace hyperbo {
namespace syrk128 {

constexpr int kW = 2 * kTile;      // a tile's rows and columns
constexpr int kBk = 16;            // rows of T a ring stage holds
constexpr int kStages = 4;         // the ring's depth
constexpr int kOperand = kBk * kW;  // floats of one operand's chunk
constexpr int kStage = 2 * kOperand;
constexpr int kKLd = kW + 4;       // rows of K^{-1}'s (then W's) tile
constexpr int kXc = 32;            // features of x a pass
constexpr int kXLd = kW + 4;       // rows (features) of x's transposed tiles
constexpr int kTileFloats = kW * kKLd;
constexpr int kXFloats = 2 * kXc * kXLd;
constexpr int kRingFloats = kStages * kStage;
constexpr int kSmemFloats = kRingFloats > kTileFloats + kXFloats
                                ? kRingFloats
                                : kTileFloats + kXFloats;
constexpr int kSmemBytes = 4 * kSmemFloats;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == 256, "16 x 16 threads of 8 x 8 outputs");
static_assert(kOperand % (4 * kThreads) == 0, "whole copies a thread");

// The laps build's slots (tools/probe_mll_bwd.py): a pair block's start and
// end (global ns), its multiprocessor, and thread 0's cycles waiting on the
// ring (copies and the chunk barrier), multiplying chunks and in the
// epilogue; a reduction block's start and end.
enum Slot {
  kSlotStart,
  kSlotEnd,
  kSlotSm,
  kSlotWait,
  kSlotChunks,
  kSlotEpilogue,
  kLapSlots,
};

#ifdef HYPERBO_BWD_LAPS
__device__ long long* g_laps;
#endif

__device__ __forceinline__ long long cycles() {
  long long t = 0;
#ifdef HYPERBO_BWD_LAPS
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
#endif
  return t;
}

__device__ __forceinline__ long long global_ns() {
  long long t = 0;
#ifdef HYPERBO_BWD_LAPS
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
#endif
  return t;
}

// Slot s of the laps row `row`, by thread 0; a no-op in other builds.
__device__ __forceinline__ void lap(long long row, int s, long long v) {
#ifdef HYPERBO_BWD_LAPS
  if (threadIdx.x == 0) g_laps[row * kLapSlots + s] = v;
#endif
}

__device__ __forceinline__ int sm_id() {
  int id = 0;
#ifdef HYPERBO_BWD_LAPS
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
#endif
  return id;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Row (column) of output p (q) of the thread at ty (tx).
__device__ __forceinline__ int out_index(int t, int p) {
  return (p / 4) * (kW / 2) + 4 * t + p % 4;
}

// Rows k0 .. k0 + kBk - 1 of T at columns col_a .. (wa of them) and, unless
// `same`, col_b .. (wb) into a ring stage.
__device__ __forceinline__ void load_chunk(float* stage,
                                           const float* __restrict__ t,
                                           long long n, long long k0,
                                           long long col_a, int wa,
                                           long long col_b, int wb,
                                           bool same) {
#pragma unroll
  for (int m = 0; m < kOperand / 4 / kThreads; ++m) {
    const int idx = threadIdx.x + m * kThreads;
    const int r = idx / (kW / 4);
    const int c = 4 * (idx % (kW / 4));
    const float* row = t + (k0 + r) * n;
    if (c < wa) cp_async16(stage + r * kW + c, row + col_a + c);
    if (!same && c < wb) cp_async16(stage + kOperand + r * kW + c,
                                    row + col_b + c);
  }
}

// Features f0 .. f0 + fw - 1 of the rows of tile i (wi of them, at row
// coli) into xa and of tile j into xb, transposed (feature-major, rows kXLd
// apart): x's features below d, then 1 (the feature of W 1), then 0 past a
// tile's width and from fw to kXc. Every thread of the block must call it
// (it synchronizes before and after).
__device__ __forceinline__ void load_x(const float* __restrict__ x, int d,
                                       int f0, int fw, long long coli,
                                       int wi, long long colj, int wj,
                                       float* xa, float* xb) {
  __syncthreads();
#pragma unroll
  for (int idx = threadIdx.x; idx < kXc * kW; idx += kThreads) {
    const int f = idx / kW;
    const int r = idx % kW;
    const int g = f0 + f;
    float a = 0.0f;
    float b = 0.0f;
    if (f < fw) {
      a = r >= wi ? 0.0f : g < d ? x[(coli + r) * d + g] : 1.0f;
      b = r >= wj ? 0.0f : g < d ? x[(colj + r) * d + g] : 1.0f;
    }
    xa[f * kXLd + r] = a;
    xb[f * kXLd + r] = b;
  }
  __syncthreads();
}

// acc[p][q] += sum_k a[k][row p] b[k][column q] over one chunk, k
// ascending.
__device__ __forceinline__ void chunk_product(float (&acc)[8][8],
                                              const float* a, const float* b,
                                              int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kBk; ++k) {
    const float4 a0 = ld4(a + k * kW + 4 * ty);
    const float4 a1 = ld4(a + k * kW + kW / 2 + 4 * ty);
    const float4 b0 = ld4(b + k * kW + 4 * tx);
    const float4 b1 = ld4(b + k * kW + kW / 2 + 4 * tx);
    const float u[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(u[p], v[q], acc[p][q]);
    }
  }
}

// Lower pair `pair` = (i, j) of 128-wide tiles (decode_pair's order:
// heaviest first): its slots p_part[i][j] (rows of tile i from W [x_j | 1])
// and, off the diagonal, p_part[j][i] (rows of tile j from W^T [x_i | 1]),
// each (kW, d + 1) of the (ns, ns, kW, d + 1) partials, rows past a 64-wide
// tile's end unwritten; and s_part[2 pair], s_part[2 pair + 1], its parts
// of d_sv_raw (twice over off the diagonal, for the mirror pair) and of
// tr G. smem is kSmemFloats floats, 16-byte aligned; red kWarps * 2
// doubles.
__device__ __forceinline__ void pair_block(
    const float* __restrict__ t, const float* __restrict__ x,
    const float* __restrict__ alpha, const float* __restrict__ valid,
    const float* __restrict__ sv_ptr, int n, int d, int fam, long long pair,
    float* smem, double* red, float* __restrict__ p_part,
    double* __restrict__ s_part) {
  const long long start_ns = global_ns();
  long long mark = cycles();
  long long waited = 0;
  long long multiplied = 0;
  int i, j;
  decode_pair(pair, &i, &j);
  const int ns = (n + kW - 1) / kW;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tx = (warp % 2) * 8 + lane % 8;
  const long long coli = static_cast<long long>(i) * kW;
  const long long colj = static_cast<long long>(j) * kW;
  const int wi = min(kW, n - static_cast<int>(coli));
  const int wj = min(kW, n - static_cast<int>(colj));
  const bool same = i == j;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;
  }
  // T is lower triangular: rows above tile i are 0 in its columns.
  const int chunks = (n - static_cast<int>(coli)) / kBk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) {
      load_chunk(smem + s * kStage, t, n, coli + s * kBk, coli, wi, colj, wj,
                 same);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kStages - 2>();
    // The stage loaded next was last read in chunk kc - 1, before this
    // barrier.
    __syncthreads();
    const long long now = cycles();
    waited += now - mark;
    const int next = kc + kStages - 1;
    if (next < chunks) {
      load_chunk(smem + (next % kStages) * kStage, t, n, coli + next * kBk,
                 coli, wi, colj, wj, same);
    }
    cp_async_commit();
    const float* a = smem + (kc % kStages) * kStage;
    chunk_product(acc, a, same ? a : a + kOperand, ty, tx);
    mark = cycles();
    multiplied += mark - now;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's last reads are done: K^{-1}'s tile takes it

  float* ks = smem;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    float* row = ks + out_index(ty, p) * kKLd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(row + h * (kW / 2) + 4 * tx) =
          make_float4(acc[p][4 * h], acc[p][4 * h + 1], acc[p][4 * h + 2],
                      acc[p][4 * h + 3]);
    }
  }

  // r2 of the thread's entries from x's features, kXc at a time (load_x).
  float* xa = smem + kTileFloats;
  float* xb = xa + kXc * kXLd;
  float dot[8][8];
  float sqr[8];
  float sqc[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    sqr[p] = 0.0f;
    sqc[p] = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) dot[p][q] = 0.0f;
  }
  for (int f0 = 0; f0 < d; f0 += kXc) {
    const int fw = min(kXc, d - f0);
    load_x(x, d, f0, fw, coli, wi, colj, wj, xa, xb);
    for (int f = 0; f < fw; ++f) {
      const float4 a0 = ld4(xa + f * kXLd + 4 * ty);
      const float4 a1 = ld4(xa + f * kXLd + kW / 2 + 4 * ty);
      const float4 b0 = ld4(xb + f * kXLd + 4 * tx);
      const float4 b1 = ld4(xb + f * kXLd + kW / 2 + 4 * tx);
      const float u[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        sqr[p] = fmaf(u[p], u[p], sqr[p]);
        sqc[p] = fmaf(v[p], v[p], sqc[p]);
#pragma unroll
        for (int q = 0; q < 8; ++q) dot[p][q] = fmaf(u[p], v[q], dot[p][q]);
      }
    }
  }

  // G and W in place of K^{-1} (each thread its own entries), 0 past a
  // tile's width; the scalar partials in float64.
  const float sv = sv_ptr[0];
  float ac[8];
  float vc[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = out_index(tx, q);
    ac[q] = c < wj ? alpha[colj + c] : 0.0f;
    vc[q] = valid != nullptr && c < wj ? valid[colj + c] : 1.0f;
  }
  double gk = 0.0;
  double gtr = 0.0;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int r = out_index(ty, p);
    const bool in_r = r < wi;
    const float ar = in_r ? alpha[coli + r] : 0.0f;
    const float vr = valid != nullptr && in_r ? valid[coli + r] : 1.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = out_index(tx, q);
      const float r2 = fmaxf(sqr[p] + sqc[q] - 2.0f * dot[p][q], 0.0f);
      float km, nm;
      km_nm(r2, sv, fam, &km, &nm);
      if (valid != nullptr) {
        const float pr = vr * vc[q];
        km *= pr;
        nm *= pr;
      }
      float* e = ks + r * kKLd + c;
      const float g = 0.5f * *e - 0.5f * (ar * ac[q]);
      const bool in = in_r && c < wj;
      if (in) {
        gk += static_cast<double>(g * km);
        if (same && r == c) gtr += g;
      }
      *e = in ? g * nm : 0.0f;
    }
  }

  // P partials: rows of tile i from W [x_j | 1]; off the diagonal, rows of
  // tile j from W^T [x_i | 1]; [x | 1]'s features kXc at a time from
  // shared memory (load_x's first barrier ends the writes of W).
  const int f1 = d + 1;
  float* prow = p_part + (static_cast<long long>(i) * ns + j) * kW * f1;
  float* pcol = p_part + (static_cast<long long>(j) * ns + i) * kW * f1;
  for (int f0 = 0; f0 < f1; f0 += kXc) {
    const int fw = min(kXc, f1 - f0);
    load_x(x, d, f0, fw, coli, wi, colj, wj, xa, xb);
    for (int idx = tid; idx < wi * fw; idx += kThreads) {
      const int r = idx / fw;
      const int f = idx % fw;
      const float* wr = ks + r * kKLd;
      const float* xf = xb + f * kXLd;
      float s = 0.0f;
#pragma unroll 4
      for (int c = 0; c < wj; c += 4) {
        const float4 w4 = ld4(wr + c);
        const float4 x4 = ld4(xf + c);
        s = fmaf(w4.x, x4.x, s);
        s = fmaf(w4.y, x4.y, s);
        s = fmaf(w4.z, x4.z, s);
        s = fmaf(w4.w, x4.w, s);
      }
      prow[r * f1 + f0 + f] = s;
    }
    if (!same) {
      for (int idx = tid; idx < wj * fw; idx += kThreads) {
        const int c = idx / fw;
        const int f = idx % fw;
        const float* wc = ks + c;
        const float* xf = xa + f * kXLd;
        float s = 0.0f;
#pragma unroll 4
        for (int r = 0; r < wi; r += 4) {
          const float4 x4 = ld4(xf + r);
          s = fmaf(wc[r * kKLd], x4.x, s);
          s = fmaf(wc[(r + 1) * kKLd], x4.y, s);
          s = fmaf(wc[(r + 2) * kKLd], x4.z, s);
          s = fmaf(wc[(r + 3) * kKLd], x4.w, s);
        }
        pcol[c * f1 + f0 + f] = s;
      }
    }
  }

  // Scalar partials: a fixed-order reduction over the block. Off the
  // diagonal the pair stands for itself and its mirror (i, j) <-> (j, i).
  for (int off = 16; off > 0; off /= 2) {
    gk += __shfl_down_sync(0xffffffffu, gk, off);
    gtr += __shfl_down_sync(0xffffffffu, gtr, off);
  }
  if (lane == 0) {
    red[warp] = gk;
    red[kWarps + warp] = gtr;
  }
  __syncthreads();
  if (tid == 0) {
    double sgk = 0.0;
    double sgtr = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      sgk += red[w];
      sgtr += red[kWarps + w];
    }
    s_part[2 * pair] = same ? sgk : 2.0 * sgk;
    s_part[2 * pair + 1] = sgtr;
  }
  const long long end = cycles();
  lap(pair, kSlotStart, start_ns);
  lap(pair, kSlotEnd, global_ns());
  lap(pair, kSlotSm, sm_id());
  lap(pair, kSlotWait, waited);
  lap(pair, kSlotChunks, multiplied);
  lap(pair, kSlotEpilogue, end - mark);
}

// P[R][f] = sum over the other tile o, ascending, of p_part[R / 128][o][R %
// 128][f], for entry idx = R (d + 1) + f (nothing for idx >= n (d + 1)).
__device__ __forceinline__ void reduce_p_entry(
    const float* __restrict__ p_part, int n, int d, long long idx,
    float* __restrict__ p) {
  const int f1 = d + 1;
  if (idx >= static_cast<long long>(n) * f1) return;
  const long long row = idx / f1;
  const int f = static_cast<int>(idx % f1);
  const int ns = (n + kW - 1) / kW;
  const long long rb = row / kW;
  const int r = static_cast<int>(row % kW);
  const long long stride = static_cast<long long>(kW) * f1;
  const float* src = p_part + rb * ns * stride + r * f1 + f;
  float s = 0.0f;
  for (int o = 0; o < ns; ++o) s += src[o * stride];
  p[idx] = s;
}

}  // namespace syrk128
}  // namespace hyperbo
