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

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxN = 512;
constexpr int kB = 64;                    // block column width
constexpr int kS = 16;                    // sub-panel width of a diagonal factor
constexpr int kMaxBlocks = kMaxN / kB;    // 8: the portable cluster limit
constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;       // a warp group
constexpr int kWarps = kThreads / 32;
constexpr int kLead = 2;                  // the warp that factors ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLd = kB + 4;               // row stride: rows 16-byte aligned
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

// Cycles of the parts of one block, summed by thread 0 of the first
// matrix's blocks (in local memory, written out once at the end); a no-op
// without stamps.
struct Laps {
  long long* out;
  long long last;
  long long sum[kStampSlots];
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// 1 / sqrt(p), flushing denormals: on the chain of every pivot, so without
// the IEEE square root's slow path. A non-positive pivot gives NaN or inf
// (and then a diagonal entry p / sqrt(p) that is NaN), as the wrapper
// expects of a matrix that is not positive definite.
__device__ __forceinline__ float rsqrt_ftz(float p) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(p));
  return r;
}

// Barrier 0 is the block's; 1 and 2 those of warps 0-3 and warps 4-7.
template <int kBar>
__device__ __forceinline__ void sync_bar() {
  if (kBar == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(kBar), "r"(kHalf) : "memory");
  }
}

// x . y over kS, both in registers, four partial sums in a fixed order.
__device__ __forceinline__ float dot_reg(const float (&x)[kS],
                                         const float (&y)[kS]) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < kS; m += 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(x[m + e], y[m + e], acc[e]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

__device__ __forceinline__ void load_s(const float* src, float (&x)[kS]) {
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
__device__ __forceinline__ void factor_sub_block(float* col, int s0, int w,
                                                 float* lt, float* rdiag) {
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
__device__ __forceinline__ void trailing_quad(float* col, int s0, int w,
                                              int r0, int c0) {
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
// for the panel's solve.
__device__ void factor_diagonal(float* col, int w, float* lt, float* rdiag,
                                Laps& laps) {
  const int t = threadIdx.x;
  const int warp = t / 32;
  long long since = laps.last;
  if (warp == kLead) factor_sub_block(col, 0, w, lt, rdiag);
  sync_bar<1>();
  laps.part(kSplitSlots, since);
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
    laps.part(kSplitSlots + 1, since);
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
    laps.part(kSplitSlots + 2, since);
  }
}

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

// col[r0 + r][c] -= sum_k as[r][k] bt[c][k] for the tile's rows below
// `rows`, with kN threads: thread t takes rows t / 16 + (kN / 16) p and
// columns t % 16 + 16 q, four k at a time, one fixed-order sum each.
template <int kN>
__device__ __forceinline__ void tile_product(float* col, int rows, int r0,
                                             const float* as, const float* bt,
                                             int t) {
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
  Laps laps;
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
        factor_diagonal(col, w, lt, rdiag, laps);
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
