// Batched Cholesky of small SPD matrices (n <= 512) on Hopper, one
// thread-block cluster a matrix (kernel K7).
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_chol.py:
// cholesky_panel (its pallas_call at :121, an outer-product sweep of the
// whole matrix held in VMEM) and cholesky_panel_blocked (:109, the
// left-looking blocked sweep). Both first symmetrize the input as
// 0.5 (A + A^T); so does this kernel.
//
// A matrix is cut into C = ceil(n / 64) block columns (C <= 8, the portable
// cluster size) and factored right-looking by a cluster of C blocks, one
// block column each. Block j keeps rows 64 j .. n - 1 of its block column in
// its own shared memory (at most 512 x 68 floats, 139 KB) from the load to
// the store. Step k + 1 of the factorization, after the cluster barrier
// that makes panel k (block k's factored block column) visible:
//   update   every block j > k subtracts panel k's 64-deep products from
//            its block column, P[64 j + r] P[64 j + c]^T for its rows r and
//            columns c, reading panel k from block k's shared memory
//            (distributed shared memory; a warp reads two whole 256-byte
//            rows) into row-major local tiles, one 64 x 64 tile at a time
//            (the next tile's loads in flight during the products), 4 x 4
//            or 8 x 4 outputs a thread, FP32 FMA in a fixed k order;
//   factor   block k + 1, the next on the chain, updates its diagonal block
//            first. Then warps 0-3 factor that 64 x 64 block (16-wide
//            sub-panels: a 16 x 16 sub-block factored with shuffles, a row
//            a lane; the rows below it solved; a 4 x 4-quad trailing update;
//            named barriers of the four warps only) while warps 4-7 update
//            the rest of the block column; then every thread solves its
//            rows of the panel below, L21 = A21 L11^-T, one row a thread in
//            one column sweep against L11^T staged in shared memory.
//            The diagonal factor and the tile product are chol_diag64.cuh's,
//            shared with kernel K6.
// So the chain is C diagonal factors, C panel solves, C - 1 updates of a
// diagonal block (the rest of each update overlaps the diagonal factor)
// and C cluster barriers. The last barrier follows the last read of
// another block's shared memory, so no block exits while its panel is
// still read. A ragged last block column (n % 64 != 0) is factored with
// identity padding of its last diagonal sub-block; n <= 64 is a cluster of
// one block. A batch is one launch of batch x C blocks.
//
// No pivot clamp: the square root and reciprocal square root of a
// non-positive pivot give NaN (or inf, then NaN), so a matrix that is not
// positive definite comes out non-finite; the wrapper (ops/chol_panel.py)
// makes that matrix's whole factor NaN. Each output is one fixed-order sum
// (no atomics), so two calls are bitwise equal. The kernel allocates
// nothing.
//
// What bounds it on an H100. n^3/3 operations a matrix (4.5e7 at n = 512,
// 0.7 us of the card's 67 TFLOP/s) and 8 n^2 bytes in and out (2 MB,
// 0.6 us): neither. The chain sets the time, mostly its 8 diagonal factors
// (64 pivots each, on four warps of one SM) and panel solves (up to 448
// rows on one SM); tools/probe_chol_panel.py splits it by part.
//
// hyperbo_chol_panel_stamped runs the same kernel with clock64() laps of
// its parts, for tools/probe_chol_panel.py;
// hyperbo_chol_panel_info reports the launch's shape and the clusters that
// fit on the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>

#include "chol_diag64.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hyperbo::chol64;

constexpr int kMaxN = 512;
constexpr int kMaxBlocks = kMaxN / kB;    // 8: the portable cluster limit
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;                // global loads in flight a thread
// Probe laps of one block (cycles): load, store, span, then the update,
// diagonal factor, panel solve and barrier of each step, then the
// diagonal factors' sub-block factors, row solves and trailing updates.
constexpr int kStepSlots = 3;
constexpr int kSplitSlots = kStepSlots + 4 * kMaxBlocks;
constexpr int kStampSlots = kSplitSlots + 3;
constexpr int kMaxDevices = 64;

size_t smem_bytes(int n) {
  return sizeof(float) *
         (static_cast<size_t>(2 * kB + n) * kLd + kB * kB + kB);
}

int block_columns(int n) { return (n + kB - 1) / kB; }

// Rows 64 .. rows - 1 of the block column: x <- x L11^-T, one row a
// thread, column by column over all 64 (scale column j by 1 / sqrt(p_j),
// then take x_j L[c][j] from every later column c).
__device__ void solve_panel(float* col, int rows, const float* lt,
                            const float* rdiag) {
  for (int i = kB + static_cast<int>(threadIdx.x); i < rows; i += kThreads) {
    float* row = col + i * kLd;
    float x[kB];
#pragma unroll
    for (int m = 0; m < kB; m += 4) {
      const float4 x4 = ld4(row + m);
      x[m] = x4.x;
      x[m + 1] = x4.y;
      x[m + 2] = x4.z;
      x[m + 3] = x4.w;
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      x[j] *= rdiag[j];
#pragma unroll
      for (int c4 = (j + 1) / 4 * 4; c4 < kB; c4 += 4) {
        const float4 l4 = ld4(lt + j * kB + c4);
        if (c4 > j) x[c4] = fmaf(-x[j], l4.x, x[c4]);
        if (c4 + 1 > j) x[c4 + 1] = fmaf(-x[j], l4.y, x[c4 + 1]);
        if (c4 + 2 > j) x[c4 + 2] = fmaf(-x[j], l4.z, x[c4 + 2]);
        if (c4 + 3 > j) x[c4 + 3] = fmaf(-x[j], l4.w, x[c4 + 3]);
      }
    }
#pragma unroll
    for (int m = 0; m < kB; m += 4) {
      st4(row + m, make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]));
    }
  }
}

// Loads rows pr + r0 .. pr + r0 + 63 of another block's panel, 64 wide,
// with kN threads (t the thread's index among them): a warp reads two
// whole rows. Rows from `limit` - r0 on are loaded clamped and zeroed.
template <int kN>
__device__ __forceinline__ void load_tile(const float* panel, int pr, int r0,
                                          int limit, int t,
                                          float4 (&pre)[kB * kB / 4 / kN]) {
#pragma unroll
  for (int s = 0; s < kB * kB / 4 / kN; ++s) {
    const int idx = t + s * kN;
    const int r = r0 + idx / (kB / 4);
    const float4 v =
        ld4(panel + (pr + min(r, limit - 1)) * kLd + 4 * (idx % (kB / 4)));
    pre[s] = r < limit ? v : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Stores a loaded tile row-major with this kernel's row stride.
template <int kN>
__device__ __forceinline__ void store_tile(float* tile, int t,
                                           const float4 (&pre)[kB * kB / 4 /
                                                               kN]) {
#pragma unroll
  for (int s = 0; s < kB * kB / 4 / kN; ++s) {
    const int idx = t + s * kN;
    st4(tile + (idx / (kB / 4)) * kLd + 4 * (idx % (kB / 4)), pre[s]);
  }
}

// Tiles first .. of the block column's update by another block's panel P
// (pr: this block column's first row in it; bt: P's rows of this block's
// columns), with kN threads synchronized by barrier kBar: each 64-row tile
// of P is staged in at, the next one's loads in flight during its products.
template <int kN, int kBar>
__device__ void update_tiles(float* col, int rows, const float* panel, int pr,
                             int first, const float* bt, float* at, int t) {
  const int tiles = (rows + kB - 1) / kB;
  if (first >= tiles) return;
  float4 pre[kB * kB / 4 / kN];
  load_tile<kN>(panel, pr, first * kB, rows, t, pre);
  for (int tile = first; tile < tiles; ++tile) {
    sync_bar<kBar>();  // every read of at for the previous tile is done
    store_tile<kN>(at, t, pre);
    if (tile + 1 < tiles) {
      load_tile<kN>(panel, pr, (tile + 1) * kB, rows, t, pre);
    }
    sync_bar<kBar>();
    tile_product<kN>(col, rows, tile * kB, at, bt, t);
  }
}

template <bool kStamp>
__global__ void __launch_bounds__(kThreads, 1)
cluster_cholesky(const float* __restrict__ a_all, float* __restrict__ l_all,
                 int n, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) float smem[];
  float* at = smem;             // (64, kLd) staged tile of a panel
  float* bt = at + kB * kLd;    // (64, kLd) its rows of own columns
  float* lt = bt + kB * kLd;    // (64, 64) L11^T of this block column
  float* rdiag = lt + kB * kB;  // (64,) 1 / sqrt of its pivots
  float* col = rdiag + kB;      // (n - 64 j, kLd): this block column
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int j = static_cast<int>(cluster.block_rank());
  const long long offset =
      static_cast<long long>(blockIdx.x / nc) * n * static_cast<long long>(n);
  const float* a = a_all + offset;
  float* l = l_all + offset;
  const int c0 = j * kB;
  const int rows = n - c0;
  const int w = min(kB, rows);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  Laps<kStampSlots> laps;
  laps.out = nullptr;
  laps.last = 0;
  if (kStamp && blockIdx.x < static_cast<unsigned>(nc) && tid == 0) {
    laps.out = stamps + j * kStampSlots;
    for (int i = 0; i < kStampSlots; ++i) laps.sum[i] = 0;
    laps.last = clock64();
  }
  const long long start = laps.last;

  // col[r][c] = 0.5 (A[c0 + r][c0 + c] + A[c0 + c][c0 + r]), kBatch loads
  // in flight a thread at fixed strides (only a last, partial batch takes
  // predicates). First A's rows: thread t takes column t % 64 of rows
  // t / 64 + 4 u.
  {
    const int c = tid % kB;
    const int r1 = tid / kB;
    const float* src = a + static_cast<long long>(c0 + r1) * n + c0 +
                       min(c, w - 1);
    for (int rb = 0; rb + r1 < rows; rb += 4 * kBatch) {
      float v[kBatch];
      const float* p = src + static_cast<long long>(rb) * n;
      if (rb + r1 + 4 * (kBatch - 1) < rows) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = p[4LL * u * n];
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = rb + r1 + 4 * u < rows ? p[4LL * u * n] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = rb + r1 + 4 * u;
        if (r < rows) col[r * kLd + c] = c < w ? v[u] : 0.0f;
      }
    }
  }
  __syncthreads();
  // Then A's columns: a warp takes 8 rows x 4 columns (32-byte runs of A,
  // conflict-free in col), lane l row l % 8 + 8 u of column 4 w + l / 8.
  for (int cb = 4 * warp; cb < w; cb += 4 * kWarps) {
    const int c = cb + lane / 8;
    const int r1 = lane % 8;
    const float* src =
        a + static_cast<long long>(c0 + min(c, w - 1)) * n + c0 + r1;
    for (int rb = 0; rb + r1 < rows; rb += 8 * kBatch) {
      float v[kBatch];
      if (rb + r1 + 8 * (kBatch - 1) < rows) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = src[rb + 8 * u];
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = rb + r1 + 8 * u < rows ? src[rb + 8 * u] : 0.0f;
        }
      }
      if (c < w) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int r = rb + r1 + 8 * u;
          if (r < rows) {
            float* q = col + r * kLd + c;
            *q = 0.5f * (*q + v[u]);
          }
        }
      }
    }
  }
  __syncthreads();
  laps.add(0);

  for (int k = -1; k + 1 < nc; ++k) {
    // Step k + 1: the update by panel k (none at step 0); block k + 1
    // updates its diagonal block first, then factors it with warps 0-3
    // while warps 4-7 update its other rows, then solves its panel.
    const int slot = kStepSlots + 4 * (k + 1);
    const bool on_chain = j == k + 1;
    const int pr = c0 - k * kB;
    const float* panel = nullptr;
    if (k >= 0 && j > k) {
      panel = cluster.map_shared_rank(col, k);
      float4 pre[kB * kB / 4 / kThreads];
      load_tile<kThreads>(panel, pr, 0, w, tid, pre);
      store_tile<kThreads>(bt, tid, pre);
      __syncthreads();
      tile_product<kThreads>(col, rows, 0, bt, bt, tid);
      if (!on_chain) {
        update_tiles<kThreads, 0>(col, rows, panel, pr, 1, bt, at, tid);
      }
    }
    laps.add(slot);
    if (on_chain) {
      __syncthreads();
      if (tid < kHalf) {
        factor_diagonal<kSplitSlots>(col, w, lt, rdiag, laps);
        laps.add(slot + 1);
      } else if (k >= 0) {
        update_tiles<kHalf, 2>(col, rows, panel, pr, 1, bt, at, tid - kHalf);
      }
      __syncthreads();
      laps.add(slot);
      solve_panel(col, rows, lt, rdiag);
      laps.add(slot + 2);
    }
    cluster.sync();
    laps.add(slot + 3);
  }

  // Block column j of L, zeros above the diagonal; float4 stores where the
  // rows of L are 16-byte aligned (n % 4 == 0, so w % 4 == 0 too).
  if (n % 4 == 0) {
    for (int r = 2 * warp + lane / 16; r < n; r += 2 * kWarps) {
      const int i = r - c0;
      const int c = 4 * (lane % 16);
      if (c < w) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i >= c) {
          v = ld4(col + i * kLd + c);
          if (i < c + 1) v.y = 0.0f;
          if (i < c + 2) v.z = 0.0f;
          if (i < c + 3) v.w = 0.0f;
        }
        st4(l + static_cast<long long>(r) * n + c0 + c, v);
      }
    }
  } else {
    for (int r = warp; r < n; r += kWarps) {
      const int i = r - c0;
      float* dst = l + static_cast<long long>(r) * n + c0;
      for (int c = lane; c < w; c += 32) {
        dst[c] = i >= c ? col[i * kLd + c] : 0.0f;
      }
    }
  }
  if (kStamp && blockIdx.x < static_cast<unsigned>(nc)) {
    __syncthreads();
    laps.add(1);
    if (laps.out != nullptr) {
      laps.sum[2] = laps.last - start;
      for (int i = 0; i < kStampSlots; ++i) laps.out[i] = laps.sum[i];
    }
  }
}

std::atomic<bool> g_ready[kMaxDevices][2];

cudaLaunchConfig_t launch_config(int n, int batch, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  const int nc = block_columns(n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * nc);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(n);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once a device and instantiation: allow the largest shared memory, and
// check that a cluster of eight blocks of it fits on the card.
template <bool kStamp>
cudaError_t prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && g_ready[dev][kStamp].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(cluster_cholesky<kStamp>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxN)));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(kMaxN, 1, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, cluster_cholesky<kStamp>,
                                       &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  if (cached) g_ready[dev][kStamp].store(true);
  return cudaSuccess;
}

template <bool kStamp>
int launch(const float* a, float* l, int n, int batch, long long* stamps,
           void* stream) {
  if (n < 1 || n > kMaxN || batch < 1 ||
      static_cast<long long>(batch) * block_columns(n) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare<kStamp>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(n, batch, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, cluster_cholesky<kStamp>, a, l, n, stamps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, l: (batch, n, n) float32 device pointers, contiguous; l gets the lower
// factor of each 0.5 (A + A^T). stream: a cudaStream_t; the current device
// is the tensors'. Returns 0 or the cudaError_t of the first failed call
// (cudaErrorInvalidValue, without launching, for an n outside [1, 512] or an
// empty batch; cudaErrorInvalidConfiguration where no cluster of eight
// blocks fits).
extern "C" int hyperbo_chol_panel(const float* a, float* l, int n, int batch,
                                  void* stream) {
  return launch<false>(a, l, n, batch, nullptr, stream);
}

// hyperbo_chol_panel with clock64() laps of the first matrix's blocks
// written to stamps, (ceil(n / 64), 38) int64 on the device: slot 0 the
// load, 1 the store, 2 the whole span, 3 + 4 s + {0, 1, 2, 3} step s's
// update, diagonal factor, panel solve and barrier, and 35, 36, 37 the
// diagonal factor's first sub-block factor, row solves, and trailing
// updates with the next sub-block's factor, in cycles of the block's SM.
extern "C" int hyperbo_chol_panel_stamped(const float* a, float* l, int n,
                                          int batch, long long* stamps,
                                          void* stream) {
  if (stamps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(a, l, n, batch, stamps, stream);
}

// info[0..3] = cluster size, threads a block, dynamic shared memory bytes a
// block, and the most clusters of that launch active at once on the
// current device. Returns 0 or a cudaError_t.
extern "C" int hyperbo_chol_panel_info(int n, int* info) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(n, 1, nullptr, attr);
  info[0] = block_columns(n);
  info[1] = kThreads;
  info[2] = static_cast<int>(cfg.dynamicSmemBytes);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      &info[3], cluster_cholesky<false>, &cfg));
}
