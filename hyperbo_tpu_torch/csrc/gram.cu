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
// What bounds it on an H100. The output is n1 n2 floats written once
// (268 MB at n = 8192), against n1 n2 (2 d + 3) operations: the bytes bound
// it for any d of the repo's configurations, so the design is about the
// stores.
//
// Layout. One 256-thread block per 128 x 128 output tile. Warp w owns the
// tile's rows 16 w .. 16 w + 15, and lane l the four columns 4 l .. 4 l + 3
// of each: a warp's store of one row is 32 x 16 = 512 contiguous bytes, a
// float4 a lane, written with st.global.cs (__stcs) so that the output
// streams past L2 instead of evicting the inputs. Where a row does not
// start 16-byte aligned (n2 % 4 != 0, or an unaligned output pointer) the
// same lanes store their four floats one at a time (128 bytes a warp
// instruction). Ragged edges are guarded in the kernel: the output is
// (n1, n2) exactly, where the TPU kernel padded both inputs to its block
// grid and sliced the result. ops/fused_gram.py gram_store_plan mirrors
// this map, and tests/test_torch_fused_gram_tiles.py holds it to covering
// every entry once.
//
// The inputs go through shared memory feature-major, 32 features a chunk
// (any d): a lane reads its four columns' feature as one float4 and its
// warp's 16 rows' as four broadcast float4s, for 64 multiply-adds. Each
// row's and column's |x|^2 is summed once per tile from the same chunks.
// The epilogue is compiled for each family, and apart for the tiles that
// the global diagonal crosses, so an entry's transform carries no test of
// the family or of the ridge. 16 rows a warp was chosen at the large-n
// Gram, 8192 x 8192: throwaway builds at 4 and 8 rows a warp took longer
// there, while at the PD1 candidates' 10,000 x 2048 the 8-row build tied
// it or was slightly faster (PERF.md gives the readings).

#include <cuda_runtime.h>

#include <cstdint>

#include "tile_common.cuh"

namespace {

using namespace hyperbo;

constexpr int kWarpRows = 16;          // output rows a warp
constexpr int kGramThreads = 256;      // 8 warps
constexpr int kRows = 8 * kWarpRows;   // output rows a block
constexpr int kCols = 128;             // output columns a block: 32 lanes x 4

// A warp's rows r0 .. r0 + kWarpRows - 1 of the tile, lane columns
// c .. c + 3: the family transform of each distance, the ridge where the
// row is the column (kDiag: the tile meets the global diagonal), and the
// streaming stores.
template <int kFam, bool kDiag>
__device__ __forceinline__ void store_rows(const float (&acc)[kWarpRows][4],
                                           const float* nr, float4 nc,
                                           long long r0, long long c, int n1,
                                           int n2, float s, float rdg,
                                           int vec, float* out) {
  const float ncv[4] = {nc.x, nc.y, nc.z, nc.w};
  // Rows left before the ragged edge (none where the lane's columns are
  // past it), and the lane's first store; a row further on is n2 floats.
  const long long left = c < n2 ? n1 - r0 : 0;
  const int rows = left < kWarpRows ? static_cast<int>(left) : kWarpRows;
  float* dst = out + r0 * n2 + c;
#pragma unroll
  for (int p = 0; p < kWarpRows; ++p, dst += n2) {
    if (p >= rows) break;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = gram_value(fmaxf(nr[p] + ncv[q] - 2.0f * acc[p][q], 0.0f), s,
                        kFam);
      if (kDiag && r0 + p == c + q) v[q] += rdg;
    }
    if (vec) {  // n2 % 4 == 0, so c < n2 means c + 3 < n2
      __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2],
                                                         v[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (c + q < n2) __stcs(dst + q, v[q]);
      }
    }
  }
}

template <bool kDiag>
__device__ __forceinline__ void store_family(int fam,
                                             const float (&acc)[kWarpRows][4],
                                             const float* nr, float4 nc,
                                             long long r0, long long c, int n1,
                                             int n2, float s, float rdg,
                                             int vec, float* out) {
  if (fam == kSe) {
    store_rows<kSe, kDiag>(acc, nr, nc, r0, c, n1, n2, s, rdg, vec, out);
  } else if (fam == kMatern32) {
    store_rows<kMatern32, kDiag>(acc, nr, nc, r0, c, n1, n2, s, rdg, vec, out);
  } else {
    store_rows<kMatern52, kDiag>(acc, nr, nc, r0, c, n1, n2, s, rdg, vec, out);
  }
}

__global__ void __launch_bounds__(kGramThreads, 2)
gram_tile(const float* __restrict__ x1, const float* __restrict__ x2,
          const float* __restrict__ sv_ptr, float sv,
          const float* __restrict__ ridge_ptr, float ridge, int n1, int n2,
          int d, int fam, int add_ridge, int vec, float* __restrict__ out) {
  // Feature-major chunks, rows 16-byte aligned: xr[f][i], xc[f][j].
  constexpr int kRld = kRows + 4;
  constexpr int kCld = kCols + 4;
  __shared__ __align__(16) float xr[kFeatChunk * kRld];
  __shared__ __align__(16) float xc[kFeatChunk * kCld];
  __shared__ __align__(16) float norm_r[kRows];
  __shared__ __align__(16) float norm_c[kCols];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long row0 = static_cast<long long>(blockIdx.y) * kRows;
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;

  float acc[kWarpRows][4] = {};
  // |x|^2 of tile row tid (tid < kRows) or column tid - kRows (warp-uniform).
  float sq = 0.0f;
  const bool norms = tid < kRows + kCols;
  const float* own = tid < kRows ? xr + tid : xc + (tid - kRows);
  const int own_ld = tid < kRows ? kRld : kCld;
  for (int f0 = 0; f0 < d; f0 += kFeatChunk) {
    const int fw = min(kFeatChunk, d - f0);
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < kRows * fw; idx += kGramThreads) {
      const int i = idx / fw;
      const int f = idx - i * fw;
      xr[f * kRld + i] = row0 + i < n1 ? x1[(row0 + i) * d + f0 + f] : 0.0f;
    }
    for (int idx = tid; idx < kCols * fw; idx += kGramThreads) {
      const int j = idx / fw;
      const int f = idx - j * fw;
      xc[f * kCld + j] = col0 + j < n2 ? x2[(col0 + j) * d + f0 + f] : 0.0f;
    }
    __syncthreads();
    for (int f = 0; f < fw; ++f) {
      if (norms) {
        const float v = own[f * own_ld];
        sq = fmaf(v, v, sq);
      }
      const float4 b =
          *reinterpret_cast<const float4*>(xc + f * kCld + 4 * lane);
#pragma unroll
      for (int k = 0; k < kWarpRows / 4; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(
            xr + f * kRld + warp * kWarpRows + 4 * k);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          acc[4 * k + p][0] = fmaf(av[p], b.x, acc[4 * k + p][0]);
          acc[4 * k + p][1] = fmaf(av[p], b.y, acc[4 * k + p][1]);
          acc[4 * k + p][2] = fmaf(av[p], b.z, acc[4 * k + p][2]);
          acc[4 * k + p][3] = fmaf(av[p], b.w, acc[4 * k + p][3]);
        }
      }
    }
  }
  if (tid < kRows) {
    norm_r[tid] = sq;
  } else if (norms) {
    norm_c[tid - kRows] = sq;
  }
  __syncthreads();

  const float s = sv_ptr ? *sv_ptr : sv;
  const float rdg = ridge_ptr ? *ridge_ptr : ridge;
  // The global diagonal crosses only the tiles whose row and column ranges
  // meet; the family and that test are the same for the whole block.
  const bool diag = add_ridge && row0 < col0 + kCols && col0 < row0 + kRows;
  const long long r0 = row0 + warp * kWarpRows;
  const long long c = col0 + 4 * lane;
  const float* nr = norm_r + warp * kWarpRows;
  const float4 nc = *reinterpret_cast<const float4*>(norm_c + 4 * lane);
  if (diag) {
    store_family<true>(fam, acc, nr, nc, r0, c, n1, n2, s, rdg, vec, out);
  } else {
    store_family<false>(fam, acc, nr, nc, r0, c, n1, n2, s, rdg, vec, out);
  }
}

}  // namespace

// x1: (n1, d), x2: (n2, d) scaled inputs; out: (n1, n2) output. Device
// pointers to float32 row-major arrays. sv and ridge are taken by value,
// or, where sv_ptr or ridge_ptr is not null, read on the device from that
// float (a value on the card, read without a host sync). fam: 0 SE, 1
// Matern-3/2, 2 Matern-5/2; add_ridge: 0 or 1; stream: a cudaStream_t.
// n1, n2 and d must be positive, n1 at most 128 x 65535. Returns 0 or the
// cudaError_t of the launch (cudaErrorInvalidValue, without launching, for
// arguments it does not take).
extern "C" int hyperbo_gram(const float* x1, const float* x2,
                            const float* sv_ptr, float sv,
                            const float* ridge_ptr, float ridge, int n1,
                            int n2, int d, int fam, int add_ridge, float* out,
                            void* stream) {
  const long long row_tiles = (static_cast<long long>(n1) + kRows - 1) / kRows;
  if (n1 < 1 || n2 < 1 || d < 1 || row_tiles > 65535 || fam < kSe ||
      fam > kMatern52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = n2 % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const unsigned col_tiles = (static_cast<unsigned>(n2) + kCols - 1) / kCols;
  gram_tile<<<dim3(col_tiles, static_cast<unsigned>(row_tiles)),
              kGramThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, sv_ptr, sv, ridge_ptr, ridge, n1, n2, d, fam, add_ridge, vec,
      out);
  return static_cast<int>(cudaGetLastError());
}
