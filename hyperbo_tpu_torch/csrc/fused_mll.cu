// Fused GP marginal-likelihood forward on Hopper (kernel K2): Gram tiles,
// blocked Cholesky, forward solve and log-determinant in one call.
//
// Replaces the Pallas kernel of hyperbo_tpu/ops/pallas_mll.py, mll_fused_g
// (its pallas_call at :922; mll_fused_pm and mll_fused_hbm are older forms
// of the same computation), which factors left-looking over 256-wide panels
// in VMEM. For scaled inputs x (n, d), y (n,), signal variance sv and
// diagonal add da it computes
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
// What bounds it on an H100. n^3/3 float32 operations (1.8e11 at n = 8192:
// 2.7 ms at the data sheet's 67 TFLOP/s, 3.6 ms at the 51 TFLOP/s a float32
// matmul reaches on the card), nearly all of them the trailing updates'
// n^3/6 multiply-adds; FP32 FMA only (no TF32: reduced-precision products
// break the Gram's |xi|^2 + |xj|^2 - 2 xi.xj cancellation). Against that,
// a blocked right-looking factor adds two costs, which the step width w
// trades: the chain of diagonal factors, each factored by one block while
// the card waits for it (its work grows with w), and the trailing matrix's
// traffic, each w-deep update reading and writing the trailing lower
// triangle once, ~8 n^3 / (6 w) bytes: 11.5 GB at w = 64 (3.4 ms at 3.35
// TB/s, beyond the 50 MB L2), 5.7 GB at w = 128, 2.9 GB at w = 256. Here
// the chain steps 128 wide and most updates are 256 deep.
//
// Design: two launches.
//   gram_tiles  K's lower 64 x 64 tiles into L's buffer, the upper tiles 0.
//   persistent  one cooperative grid (as many blocks as fit at once, one an
//               SM) factors L's buffer in place, right-looking in 128-wide
//               steps on 128 x 128 tiles (the last tile row and column 64
//               wide where n / 64 is odd):
//   chain   block 0 runs the critical path, step k = 0 .. ns - 1, in four
//           stages of its two warp groups. (1) Warps 0-3 factor the first
//           64 x 64 diagonal factor D0 of tile (k, k) in shared memory
//           (chol_diag64.cuh, as K6 and K7 factor theirs) and solve the
//           tile L1 below it; warps 4-7 take the last products of step k -
//           1's lookahead from D1, wait for and load tiles (k + 1, k) and
//           (k + 1, k + 1), and form y_k less the partials L_km z_m of row
//           k. (2) Warps 0-3 update D1 by L1 and factor it; warps 4-7 solve
//           the left half of (k + 1, k) a row a thread, take its products
//           with L1 from the right half and solve z_k's first half. (3)
//           Warps 0-3 solve the right half; warps 4-7 publish L_kk (its
//           factors transposed, L1 and 1 / sqrt of the pivots) for the
//           workers' solves, release (k, k), store L_kk, solve z_k's second
//           half and add |z_k|^2 and sum log L_jj to float64 sums in step
//           order. (4) The lookahead: warps 0-3 take (k + 1, k)'s products
//           from the next D0, which the next step factors first; warps 4-7
//           store (k + 1, k), z_k and the partial L_{k+1,k} z_k, release
//           them, then take the products from the next L1.
//   worker  every other block walks its share of a fixed list of tasks,
//           every workers-th from its index (ops/fused_mll.fused_tasks,
//           built on the host and read as a table): the panel solves L_ik =
//           A_ik L_kk^-T for i >= k + 2, a 128-row tile a task, each
//           released once stored and followed in the same block by the
//           update of (i, k + 1) with the chain's L_{k+1,k} and the partial
//           L_ik z_k; then the trailing updates A_ij -= L_ik L_jk^T on 128 x
//           128 output tiles, 8 x 8 outputs a thread, FP32 FMA. Two steps'
//           updates of a tile are one 256-deep product where neither is
//           needed sooner (an even step k and k + 1 on block columns j >=
//           k + 4: the panels' columns are contiguous in L), the others 128
//           deep. Operands stream through a two-stage cp.async ring of
//           64-deep chunks; the target arrives with the last chunk, and the
//           next update's first chunk is loaded during the last one where
//           its counters are already released. The list goes in wavefronts
//           of step + block column, so the solves of step k + 1 come before
//           the far columns of step k's update, and the chain's next tiles
//           never wait behind the bulk of a step.
// The arithmetic at n = 8192: 64 steps. The chain's step is two diagonal
// factors, the solve of a 128 x 128 tile against L_kk (1.0M FMA) and the
// lookahead (1.6M FMA), ~55-65 us on one SM of an H100 (the probe's
// timeline): ~3.8 ms in all, hidden behind the workers' updates in the
// first ~40 steps and the time itself in the last ~24. The workers' n^3/6 FMA take ~4.9 ms over 131 blocks at ~56% of
// the card's float32 peak (the rate K3's products reach). The trailing
// matrix's traffic is ~3.2 GB, a 64 KB tile read and written once a task
// (19,375 two-step and 4,867 one-step tasks), against 5.7 GB were every
// update 128 deep. tools/probe_fused_mll.py splits a launch by part and by
// step.
//
// Ordering is by per-tile counters in global memory, as in K6: counter (i,
// j) is the number of steps' updates tile (i, j) holds, and j + 1 once it is
// final. A task waits (one thread spinning on relaxed loads, a trap after
// 2^26 polls, then an acquire fence and a block barrier) only on the tiles
// it reads; a writer releases after its block's stores. Data written in the
// launch is read through L2 only (cp.async.cg, __ldcg). The counters order
// work and never touch data: each entry of L is one sum in a fixed order,
// z_k's right-hand side sums its row's partials in step order, and quad and
// logdet_half are float64 sums in step order, so two calls are bitwise
// equal. No atomics.
//
// Pivots take rsqrt.approx.ftz with no clamp: a matrix that is not positive
// definite leaves a non-positive or NaN diagonal entry, which the wrapper's
// _poison_non_pd (ops/fused_mll.py) turns into a NaN factor and value. Any
// n that is a positive multiple of 64; offsets are 64-bit (at n = 16384, L
// is 1 GiB). The kernel allocates nothing: the wrapper passes the counters
// (zeroed each call), the published panels and the partials.
//
// Built with -DHYPERBO_MLL_LAPS (tools/probe_fused_mll.py), thread 0 of each
// block sums clock64() laps of its parts, and the chain and the workers
// stamp a timeline; hyperbo_mll_fused_info reports the launch's shape.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "chol_diag64.cuh"
#include "chol_persistent.cuh"
#include "gemm_core.cuh"
#include "tile_common.cuh"

namespace {

// The Gram tiles: 64 x 64, lower ones from x, upper ones 0.
namespace gram {

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

}  // namespace gram

using namespace hyperbo::chol64;
using hyperbo::cp_async16;
using hyperbo::cp_async_commit;

constexpr int kW = 2 * kB;                 // the persistent launch's tile
constexpr int kTileF = kB * kLd;           // a 64 x 64 tile in shared memory
constexpr int kPanelF = 3 * kB * kB + kW;  // lt0, lt1, l1, 1 / sqrt(pivots)
constexpr int kBk = 64;                    // an update's k-chunk
constexpr int kRingLd = kBk + 4;           // its rows: 16-byte aligned
constexpr int kRingStage = 2 * kW * kRingLd;
constexpr int kRingStages = 2;
constexpr int kCLd = kW + 4;               // an update's target rows
// Chain: two diagonal tiles (three 64 x 64 tiles each), the tile below
// (four), lt0 and lt1, the pivots, y_k or z_k, the partial L_{k+1,k} z_k
// and 128 float64 logs.
constexpr int kChainF = 6 * kTileF + 4 * kTileF + 2 * kB * kB + kW + kW + kW +
                        2 * kW;
// Worker: the solved tile (four), the panel (l1 in a 64 x 68 tile), the
// tile L_{k+1,k} (four), z_k. An update's ring and target overlay it.
constexpr int kSolveF = 4 * kTileF + 2 * kB * kB + kTileF + kW + 4 * kTileF +
                        kW;
constexpr int kUpdateF = kRingStages * kRingStage + kW * kCLd;
constexpr int kSmemBytes =
    static_cast<int>(sizeof(float)) *
    std::max(kChainF, std::max(kSolveF, kUpdateF));
constexpr int kMaxDevices = 64;

// Probe laps (cycles) of thread 0 of each block.
enum Slot {
  kSlotSpan,          // the whole kernel
  kSlotChainLoad,     // chain: the first diagonal tile
  kSlotChainDiag,     // chain: diagonal factors (warps 0-3)
  kSlotChainMid,      // chain: L1's solve and D1's update between them
  kSlotChainWait,     // chain: warps 0-3 waiting on warps 4-7
  kSlotChainSolve,    // chain: the right half's solve beside the releases
  kSlotChainAhead,    // chain: the lookahead beside the releases
  kSlotSplit,         // chain: the diagonal factors' split, 3 slots
  kSlotChainSpin = kSlotSplit + 3,  // chain: warps 4-7 waiting on counters
  kSlotWorkerWait,    // worker: waiting on counters
  kSlotWorkerLoad,    // worker: waiting on a solve's loads
  kSlotWorkerSolve,   // worker: panel solves and their stores
  kSlotWorkerHeld,    // worker: the held updates (loads and products)
  kSlotWorkerUpdate,  // worker: the trailing updates (loads and products)
  kSlotWorkerStore,   // worker: stores, partials and releases
  kLapSlots,
};
using BlockLaps = Laps<kLapSlots>;

#ifdef HYPERBO_MLL_LAPS
__device__ long long* g_laps;
__device__ long long* g_trace;
#endif

// The laps build's timeline (hyperbo_mll_fused_laps): entry idx of the
// trace, in the card's global nanoseconds or in cycles; no-ops otherwise.
__device__ __forceinline__ long long now_ns() {
  long long t = 0;
#ifdef HYPERBO_MLL_LAPS
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
#endif
  return t;
}

__device__ __forceinline__ void trace_at(long long idx, long long value) {
#ifdef HYPERBO_MLL_LAPS
  g_trace[idx] = value;
#endif
}

struct Geometry {
  float* l;
  float* y;
  float* panel;      // (ns, kPanelF)
  float* partial;    // (ns, ns, 128)
  int* cnt;          // (ns, ns)
  const int* tasks;  // the workers' list (ops/fused_mll.task_table)
  float* out;
  int n, ns, count, workers;
};

// Rows (and columns) of 128-tile i: 64 for the last where n / 64 is odd.
__device__ __forceinline__ int width(const Geometry& g, int i) {
  return min(kW, g.n - kW * i);
}

__device__ __forceinline__ long long at(const Geometry& g, int i, int j) {
  return static_cast<long long>(i) * kW * g.n + static_cast<long long>(j) * kW;
}

__device__ __forceinline__ int* counter(const Geometry& g, int i, int j) {
  return g.cnt + static_cast<long long>(i) * g.ns + j;
}

__device__ __forceinline__ float* partial_at(const Geometry& g, int i,
                                             int k) {
  return g.partial + (static_cast<long long>(i) * g.ns + k) * kW;
}

// v (64 shared floats) <- L^-1 v on one warp, L as in solve_row: lane owns
// entries lane and lane + 32; entry j is scaled and broadcast, then leaves
// the later entries, in j order.
__device__ __forceinline__ void solve_vec(float* v, const float* lt,
                                          const float* rdiag) {
  const int lane = threadIdx.x % 32;
  float v0 = v[lane];
  float v1 = v[lane + 32];
#pragma unroll 4
  for (int j = 0; j < kB; ++j) {
    const float vj = __shfl_sync(kFull, j < 32 ? v0 : v1, j % 32) * rdiag[j];
    const float* lj = lt + j * kB;
    if (lane > j) v0 = fmaf(-vj, lj[lane], v0);
    if (lane + 32 > j) v1 = fmaf(-vj, lj[lane + 32], v1);
    if (lane == j) v0 = vj;
    if (lane + 32 == j) v1 = vj;
  }
  v[lane] = v0;
  v[lane + 32] = v1;
}

// sum over 128 columns of a row's two halves (rows kLd apart) times z, in
// column order.
__device__ __forceinline__ float row_dot(const float* xl, const float* xr,
                                         const float* z) {
  float acc = 0.0f;
#pragma unroll 8
  for (int c = 0; c < kB; ++c) acc = fmaf(xl[c], z[c], acc);
#pragma unroll 8
  for (int c = 0; c < kB; ++c) acc = fmaf(xr[c], z[kB + c], acc);
  return acc;
}

// acc[p][q] -= sum_{k < depth} a[r][k] b[c][k] for the thread's rows
// r = ty + 16 p and columns c = tx + 16 q (p, q < 8) of a 128 x 128 tile,
// a and b rows lda and ldb apart in shared memory (both 4 mod 32, so a
// quarter-warp's eight rows of b sit in distinct banks); k ascending.
__device__ __forceinline__ void nt_product(float (&acc)[8][8], const float* a,
                                           int lda, const float* b, int ldb,
                                           int depth) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll 1
  for (int k = 0; k < depth; k += 4) {
    float4 a4[8], b4[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) a4[p] = ld4(a + (ty + 16 * p) * lda + k);
#pragma unroll
    for (int q = 0; q < 8; ++q) b4[q] = ld4(b + (tx + 16 * q) * ldb + k);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        acc[p][q] = fmaf(-a4[p].x, b4[q].x, acc[p][q]);
        acc[p][q] = fmaf(-a4[p].y, b4[q].y, acc[p][q]);
        acc[p][q] = fmaf(-a4[p].z, b4[q].z, acc[p][q]);
        acc[p][q] = fmaf(-a4[p].w, b4[q].w, acc[p][q]);
      }
    }
  }
}

// The thread's entries of the rows x cols tile at c (row stride n) into acc
// (0 outside the tile), through L2.
__device__ __forceinline__ void load_acc(float (&acc)[8][8], const float* c,
                                         long long n, int rows, int cols) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int r = ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = tx + 16 * q;
      acc[p][q] = r < rows && col < cols ? __ldcg(c + r * n + col) : 0.0f;
    }
  }
}

// acc to the rows x cols tile at c; `diag` leaves its upper-right 64 x 64
// quarter (above L's diagonal) as it is.
__device__ __forceinline__ void store_acc(const float (&acc)[8][8], float* c,
                                          long long n, int rows, int cols,
                                          bool diag) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int r = ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = tx + 16 * q;
      if (r < rows && col < cols && !(diag && r < kB && col >= kB)) {
        c[r * n + col] = acc[p][q];
      }
    }
  }
}

// The chain: diagonal factors, the solve of the tile below each with z_k,
// the lookahead update of the next diagonal tile, the float64 sums.
__device__ void run_chain(const Geometry& g, float* smem, BlockLaps& laps) {
  // Two diagonal tiles, (k, k) and (k + 1, k + 1), as D0, L1, D1.
  float* const sets = smem;
  float* xl = smem + 6 * kTileF;               // (k + 1, k), columns 0-63
  float* xr = xl + 2 * kTileF;                 // (k + 1, k), columns 64-127
  float* lt0 = xr + 2 * kTileF;                // L_kk's factors transposed
  float* lt1 = lt0 + kB * kB;
  float* rd = lt1 + kB * kB;                   // 1 / sqrt of its pivots
  float* bv = rd + kW;                         // y_k less the partials; z_k
  float* own = bv + kW;                        // L_{k+1,k} z_k
  double* logs = reinterpret_cast<double*>(own + kW);  // 16-byte aligned
  const int tid = threadIdx.x;
  const int t = tid - kHalf;  // warps 4-7's own index
  long long spin = 0;
  double quad = 0.0;
  double logdet = 0.0;
  {
    const int w = width(g, 0);
    if (tid == 0) trace_at(0, now_ns());
    copy_rows_async<kThreads>(sets, g.l, g.n, w, tid);
    if (w > kB) {
      copy_rows_async<kThreads>(sets + 2 * kTileF, g.l + kB * g.n + kB, g.n,
                                kB, tid);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    laps.add(kSlotChainLoad);
  }
  for (int k = 0; k < g.ns; ++k) {
    float* d0 = sets + (k & 1) * 3 * kTileF;
    float* n0 = sets + ((k + 1) & 1) * 3 * kTileF;
    float* l1 = d0 + kTileF;
    float* d1 = l1 + kTileF;
    const int w = width(g, k);
    const bool next = k + 1 < g.ns;
    const int rows = next ? width(g, k + 1) : 0;
    // Warps 0-3 factor D0 and solve L1 against it; warps 4-7 take the
    // last products of the lookahead from D1, then wait for and load
    // (k + 1, k) and (k + 1, k + 1), and form y_k less the partials of
    // row k.
    if (tid < kHalf) {
      factor_diagonal<kSlotSplit>(d0, kB, lt0, rd, laps);
      laps.add(kSlotChainDiag);
      if (w > kB) {
        if (tid < kB) solve_row(l1 + tid * kLd, lt0, rd);
        sync_bar<1>();
        laps.add(kSlotChainMid);
      }
    } else {
      if (k > 0 && w > kB) {
        // The lookahead's last part, on (k, k - 1) still in xl and xr.
        tile_product<kHalf>(d1, kB, 0, xl + kTileF, xl + kTileF, t);
        tile_product<kHalf>(d1, kB, 0, xr + kTileF, xr + kTileF, t);
        sync_bar<2>();
      }
      if (next) {
        if (t == 0) {
          const long long start = clock64();
          spin_until(counter(g, k + 1, k), k);
          spin_until(counter(g, k + 1, k + 1), k);
          fence_acq_rel();
          spin += clock64() - start;
        }
        sync_bar<2>();
        const float* below = g.l + at(g, k + 1, k);
        copy_rows_async<kHalf>(xl, below, g.n, rows, t);
        copy_rows_async<kHalf>(xr, below + kB, g.n, rows, t);
        copy_rows_async<kHalf>(n0, g.l + at(g, k + 1, k + 1), g.n, rows, t);
        if (rows > kB) {
          copy_rows_async<kHalf>(n0 + 2 * kTileF,
                               g.l + at(g, k + 1, k + 1) + kB * g.n + kB,
                               g.n, kB, t);
        }
        cp_async_commit();
      }
      if (t < w) {
        float b = __ldcg(g.y + static_cast<long long>(k) * kW + t);
#pragma unroll 8
        for (int m = 0; m + 1 < k; ++m) b -= __ldcg(partial_at(g, k, m) + t);
        if (k > 0) b -= own[t];
        bv[t] = b;
      }
      cp_async_wait_all();
    }
    __syncthreads();
    laps.add(kSlotChainWait);
    // Warps 0-3 update D1 and factor it. Warps 4-7 solve the left half of
    // (k + 1, k) against D0's factor, a row a thread, take its products
    // with L1 from the right half, and solve z_k's first half.
    if (tid < kHalf) {
      if (w > kB) {
        tile_product<kHalf>(d1, kB, 0, l1, l1, tid);
        sync_bar<1>();
        laps.add(kSlotChainMid);
        factor_diagonal<kSlotSplit>(d1, kB, lt1, rd + kB, laps);
        laps.add(kSlotChainDiag);
      }
    } else {
      if (t < rows) solve_row(xl + t * kLd, lt0, rd);
      sync_bar<2>();
      if (next) {
        tile_product<kHalf>(xr, kB, 0, xl, l1, t);
        if (rows > kB) {
          tile_product<kHalf>(xr + kTileF, kB, 0, xl + kTileF, l1, t);
        }
      }
      if (t < 32) {
        solve_vec(bv, lt0, rd);
        if (w > kB) {
          __syncwarp();
          for (int h = t; h < kB; h += 32) {
            float acc = bv[kB + h];
            for (int m = 0; m < kB; ++m) {
              acc = fmaf(-l1[h * kLd + m], bv[m], acc);
            }
            bv[kB + h] = acc;
          }
        }
      }
    }
    __syncthreads();
    laps.add(kSlotChainWait);
    // Warps 0-3 solve the right half of (k + 1, k) against D1's factor.
    // Warps 4-7 publish L_kk for the workers' solves and release (k, k),
    // store L_kk, solve z_k's second half and add this step's |z_k|^2 and
    // logs to the float64 sums.
    if (tid < kHalf) {
      if (tid < rows) solve_row(xr + tid * kLd, lt1, rd + kB);
    } else {
      float* pk = g.panel + static_cast<long long>(k) * kPanelF;
      for (int c = 4 * t; c < 2 * kB * kB + kW; c += 4 * kHalf) {
        // lt0, lt1 and rd are contiguous; l1 goes between them and rd.
        st4(pk + (c < 2 * kB * kB ? c : c + kB * kB), ld4(lt0 + c));
      }
      for (int c = 4 * t; c < kB * kB; c += 4 * kHalf) {
        st4(pk + 2 * kB * kB + c, ld4(l1 + (c / kB) * kLd + c % kB));
      }
      sync_bar<2>();
      if (t == 0) release(counter(g, k, k), k + 1);
      float* lkk = g.l + at(g, k, k);
      if (t < 32) {
        if (w > kB) solve_vec(bv + kB, lt1, rd + kB);
      } else {
        store_rows<kHalf - 32>(lkk, g.n, d0, kB, true, t - 32);
        if (w > kB) {
          store_rows<kHalf - 32>(lkk + kB * g.n, g.n, l1, kB, false, t - 32);
          store_rows<kHalf - 32>(lkk + kB * g.n + kB, g.n, d1, kB, true,
                                 t - 32);
        }
      }
      sync_bar<2>();
      if (t < w) {
        const float ljj = t < kB ? d0[t * kLd + t] : d1[(t - kB) * (kLd + 1)];
        logs[t] = log(static_cast<double>(ljj));
      }
      sync_bar<2>();
      if (t == 0) {
        for (int j = 0; j < w; ++j) {
          quad += static_cast<double>(bv[j]) * bv[j];
          logdet += logs[j];
        }
      }
    }
    __syncthreads();
    laps.add(kSlotChainSolve);
    // The lookahead: (k + 1, k)'s products leave the next diagonal tile.
    // Warps 0-3 take them from its D0, which the next factor needs first.
    // Warps 4-7 store the solved tile, z_k and L_{k+1,k} z_k, release
    // (k + 1, k), then take them from L1; D1's follow beside the next
    // factor.
    if (tid < kHalf) {
      if (next) {
        tile_product<kHalf>(n0, kB, 0, xl, xl, tid);
        tile_product<kHalf>(n0, kB, 0, xr, xr, tid);
      }
    } else {
      if (t < w) g.y[static_cast<long long>(k) * kW + t] = bv[t];
      if (next) {
        float* below = g.l + at(g, k + 1, k);
        store_rows<kHalf>(below, g.n, xl, rows, false, t);
        store_rows<kHalf>(below + kB, g.n, xr, rows, false, t);
        if (t < rows) own[t] = row_dot(xl + t * kLd, xr + t * kLd, bv);
        sync_bar<2>();
        if (t == 0) release(counter(g, k + 1, k), k + 1);
        if (rows > kB) {
          tile_product<kHalf>(n0 + kTileF, kB, 0, xl + kTileF, xl, t);
          tile_product<kHalf>(n0 + kTileF, kB, 0, xr + kTileF, xr, t);
        }
      }
    }
    __syncthreads();
    laps.add(kSlotChainAhead);
    if (tid == 0) trace_at(1 + k, now_ns());
    if (t == 0) trace_at(1 + g.ns + k, spin);
  }
  if (t == 0) {
    g.out[0] = static_cast<float>(quad);
    g.out[1] = static_cast<float>(logdet);
  }
#ifdef HYPERBO_MLL_LAPS
  if (t == 0) {
    g_laps[static_cast<long long>(blockIdx.x) * kLapSlots + kSlotChainSpin] =
        spin;
  }
#endif
}

// A worker task of the list: the solve of (i, k) when j == k, else the
// update of (i, j) by step k, or by steps k and k + 1 where `steps` is 2.
struct Task {
  int i, j, k, steps;
};

__device__ __forceinline__ Task decode(int code) {
  return {code & 1023, (code >> 10) & 1023, (code >> 20) & 1023,
          1 + (code >> 30)};
}

// The panel solve of tile (i, k), released once stored, then the held
// update of (i, k + 1) and the partial L_ik z_k, released with (i, k + 1).
__device__ void run_solve(const Geometry& g, int i, int k, float* smem,
                          BlockLaps& laps) {
  float* xl = smem;               // L_ik, columns 0-63 (128 rows kLd apart)
  float* xr = xl + 2 * kTileF;    // columns 64-127
  float* plt = xr + 2 * kTileF;   // lt0, lt1
  float* pl1 = plt + 2 * kB * kB; // l1, rows kLd apart
  float* prd = pl1 + kTileF;      // 1 / sqrt of the pivots
  float* bl = prd + kW;           // L_{k+1,k}, columns 0-63
  float* br = bl + 2 * kTileF;    // columns 64-127
  float* zs = br + 2 * kTileF;    // z_k
  const int tid = threadIdx.x;
  const int rows = width(g, i);
  if (tid == 0) {
    spin_until(counter(g, k, k), k + 1);
    spin_until(counter(g, i, k), k);
    fence_acq_rel();
  }
  __syncthreads();
  laps.add(kSlotWorkerWait);
  const float* pk = g.panel + static_cast<long long>(k) * kPanelF;
  const float* src = g.l + at(g, i, k);
  copy_rows_async<kThreads>(xl, src, g.n, rows, tid);
  copy_rows_async<kThreads>(xr, src + kB, g.n, rows, tid);
  copy_async<kThreads>(plt, pk, 2 * kB * kB, tid);
  copy_rows_async<kThreads>(pl1, pk + 2 * kB * kB, kB, kB, tid);
  copy_async<kThreads>(prd, pk + 3 * kB * kB, kW, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  laps.add(kSlotWorkerLoad);
  if (tid < rows) solve_row(xl + tid * kLd, plt, prd);
  __syncthreads();
  tile_product<kThreads>(xr, kB, 0, xl, pl1, tid);
  if (rows > kB) tile_product<kThreads>(xr + kTileF, kB, 0, xl + kTileF, pl1,
                                        tid);
  __syncthreads();
  if (tid < rows) solve_row(xr + tid * kLd, plt + kB * kB, prd + kB);
  __syncthreads();
  store_rows<kThreads>(g.l + at(g, i, k), g.n, xl, rows, false, tid);
  store_rows<kThreads>(g.l + at(g, i, k) + kB, g.n, xr, rows, false, tid);
  __syncthreads();
  laps.add(kSlotWorkerSolve);
  if (tid == 0) {
    release(counter(g, i, k), k + 1);
    spin_until(counter(g, k + 1, k), k + 1);
    spin_until(counter(g, i, k + 1), k);
    fence_acq_rel();
  }
  __syncthreads();
  laps.add(kSlotWorkerWait);
  const float* b = g.l + at(g, k + 1, k);
  copy_rows_async<kThreads>(bl, b, g.n, kW, tid);
  copy_rows_async<kThreads>(br, b + kB, g.n, kW, tid);
  copy_async<kThreads>(zs, g.y + static_cast<long long>(k) * kW, kW, tid);
  cp_async_commit();
  float acc[8][8];
  float* c = g.l + at(g, i, k + 1);
  load_acc(acc, c, g.n, rows, kW);
  cp_async_wait_all();
  __syncthreads();
  nt_product(acc, xl, kLd, bl, kLd, kB);
  nt_product(acc, xr, kLd, br, kLd, kB);
  store_acc(acc, c, g.n, rows, kW, false);
  laps.add(kSlotWorkerHeld);
  if (tid < rows) {
    partial_at(g, i, k)[tid] = row_dot(xl + tid * kLd, xr + tid * kLd, zs);
  }
  __syncthreads();
  if (tid == 0) release(counter(g, i, k + 1), k + 1);
  laps.add(kSlotWorkerStore);
}

// Chunk kc of update task s's operands: rows of tile i and of tile j,
// columns 128 k + 64 kc .., into a ring stage (rows kRingLd apart; rows
// past a ragged tile's end read its last row).
__device__ __forceinline__ void load_chunk(const Geometry& g, float* stage,
                                           const Task& s, int kc) {
  const float* a = g.l + at(g, s.i, s.k);
  const float* b = g.l + at(g, s.j, s.k);
  const int rows_a = width(g, s.i);
  const int rows_b = width(g, s.j);
  for (int idx = threadIdx.x; idx < kW * (kBk / 4); idx += kThreads) {
    const int r = idx / (kBk / 4);
    const int c = 4 * (idx % (kBk / 4));
    const int col = kc * kBk + c;
    cp_async16(stage + r * kRingLd + c,
               a + static_cast<long long>(min(r, rows_a - 1)) * g.n + col);
    cp_async16(stage + (kW + r) * kRingLd + c,
               b + static_cast<long long>(min(r, rows_b - 1)) * g.n + col);
  }
}

// The rows x cols tile at c into shared rows kCLd apart, by cp.async; a
// diagonal tile's upper-right quarter is left out.
__device__ __forceinline__ void load_target(float* dst, const float* c,
                                            long long n, int rows, int cols,
                                            bool diag) {
  for (int idx = threadIdx.x; idx < kW * (kW / 4); idx += kThreads) {
    const int r = idx / (kW / 4);
    const int col = 4 * (idx % (kW / 4));
    if (r < rows && col < cols && !(diag && r < kB && col >= kB)) {
      cp_async16(dst + r * kCLd + col, c + r * n + col);
    }
  }
}

// The counters update task s waits on, with their values: (i, k + q) and
// (j, k + q) for each of its steps q (a one-step task names step k twice),
// then (i, j).
struct Waits {
  const int* flag[5];
  int want[5];
};

__device__ __forceinline__ Waits update_waits(const Geometry& g,
                                              const Task& s) {
  const int q = s.k + s.steps - 1;
  return {{counter(g, s.i, s.k), counter(g, s.j, s.k), counter(g, s.i, q),
           counter(g, s.j, q), counter(g, s.i, s.j)},
          {s.k + 1, s.k + 1, q + 1, q + 1, s.k}};
}

// The update of tile (i, j) by s.steps steps from k: A_ij -= L_ik L_jk^T
// (+ L_i,k+1 L_j,k+1^T), 128 or 256 deep: the panels' columns are
// contiguous in L. The operands stream through the two-stage ring, the
// target arrives with the last chunk and takes the product's sum at the
// end. With `pre`, the task's counters were acquired and its first chunk
// is in flight into stage 0. If the next task is an update whose counters
// are all released by the last chunk (thread 0 reads them a chunk ahead,
// without waiting), its first chunk goes into the free stage before this
// task's epilogue; returns whether it did.
__device__ bool run_update(const Geometry& g, const Task& s, bool pre,
                           const Task& next, bool next_update, float* smem,
                           BlockLaps& laps) {
  __shared__ int next_ready;
  const int tid = threadIdx.x;
  if (!pre) {
    if (tid == 0) {
      const Waits waits = update_waits(g, s);
#pragma unroll
      for (int q = 0; q < 5; ++q) spin_until(waits.flag[q], waits.want[q]);
      fence_acq_rel();
    }
    __syncthreads();
    laps.add(kSlotWorkerWait);
    load_chunk(g, smem, s, 0);
    cp_async_commit();
  }
  const int rows = width(g, s.i);
  const int cols = width(g, s.j);
  const bool diag = s.i == s.j;
  float* c = g.l + at(g, s.i, s.j);
  float* target = smem + kRingStages * kRingStage;
  const int chunks = s.steps * kW / kBk;
  Waits ahead = update_waits(g, s);
  int seen[5];
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.0f;
  }
#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    if (kc + 1 == chunks && tid == 0) {
      bool ready = next_update;
#pragma unroll
      for (int q = 0; q < 5; ++q) ready = ready && seen[q] >= ahead.want[q];
      if (ready) fence_acq_rel();
      next_ready = ready;
    }
    cp_async_wait_all();
    // The stage loaded next was last read in chunk kc - 1, before this
    // barrier.
    __syncthreads();
    float* free_stage = smem + ((kc + 1) % kRingStages) * kRingStage;
    if (kc + 1 < chunks) {
      load_chunk(g, free_stage, s, kc + 1);
      if (kc + 2 == chunks) load_target(target, c, g.n, rows, cols, diag);
      cp_async_commit();
    } else if (next_ready) {
      load_chunk(g, free_stage, next, 0);
      cp_async_commit();
    }
    if (kc + 2 == chunks && tid == 0 && next_update) {
      ahead = update_waits(g, next);
#pragma unroll
      for (int q = 0; q < 5; ++q) seen[q] = ld_relaxed(ahead.flag[q]);
    }
    const float* stage = smem + (kc % kRingStages) * kRingStage;
    nt_product(acc, stage, kRingLd, stage + kW * kRingLd, kRingLd, kBk);
  }
  laps.add(kSlotWorkerUpdate);
  const bool prefetched = next_ready != 0;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int r = ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = tx + 16 * q;
      if (r < rows && col < cols && !(diag && r < kB && col >= kB)) {
        c[r * g.n + col] = target[r * kCLd + col] + acc[p][q];
      }
    }
  }
  __syncthreads();
  if (tid == 0) release(counter(g, s.i, s.j), s.k + s.steps);
  laps.add(kSlotWorkerStore);
  return prefetched;
}

// Worker w's tasks: every workers-th of the list from w. An update's
// successor's first chunk is loaded during it where that task is ready.
__device__ void run_worker(const Geometry& g, int w, float* smem,
                           BlockLaps& laps) {
  if (w >= g.count) return;
  Task cur = decode(__ldg(g.tasks + w));
  bool pre = false;
  for (int t = w; t < g.count; t += g.workers) {
    const bool more = t + g.workers < g.count;
    const Task next = more ? decode(__ldg(g.tasks + t + g.workers)) : cur;
    if (cur.j == cur.k) {
      run_solve(g, cur.i, cur.k, smem, laps);
      pre = false;
    } else {
      pre = run_update(g, cur, pre, next, more && next.j != next.k, smem,
                       laps);
    }
    cur = next;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
persistent_factor(Geometry g) {
  extern __shared__ __align__(16) float smem[];
  BlockLaps laps;
  laps.out = nullptr;
  laps.last = 0;
#ifdef HYPERBO_MLL_LAPS
  if (threadIdx.x == 0) {
    laps.out = g_laps + static_cast<long long>(blockIdx.x) * kLapSlots;
    for (int i = 0; i < kLapSlots; ++i) laps.sum[i] = 0;
    laps.last = clock64();
  }
#endif
  const long long start = laps.last;
  if (blockIdx.x == 0) {
    run_chain(g, smem, laps);
  } else {
    run_worker(g, static_cast<int>(blockIdx.x) - 1, smem, laps);
    if (threadIdx.x == 0) trace_at(1 + 2 * g.ns + blockIdx.x, now_ns());
  }
  if (laps.out != nullptr) {
    laps.sum[kSlotSpan] = clock64() - start;
    for (int i = 0; i < kLapSlots; ++i) {
      if (i != kSlotChainSpin) laps.out[i] = laps.sum[i];
    }
  }
}

std::atomic<int> g_per_sm[kMaxDevices];

// Once a device: allow the kernel's shared memory and size the grid from
// the blocks that fit at once.
cudaError_t grid_size(int* grid, int* per_sm_out, int* sms_out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  int per_sm = 0;
  if (cached && g_per_sm[dev].load() > 0) {
    per_sm = g_per_sm[dev].load();
  } else {
    err = cudaFuncSetAttribute(persistent_factor,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, persistent_factor, kThreads, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (cached && per_sm > 0) g_per_sm[dev].store(per_sm);
  }
  *grid = per_sm * sms;
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  if (sms_out != nullptr) *sms_out = sms;
  // The chain block and a worker at least.
  return *grid < 2 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

// x: (n, d) scaled inputs; valid: (n,) 0/1 mask or null; sv_da: the two
// floats (sv, da); y: (n,) right-hand side, overwritten with z = L^{-1} y;
// l: (n, n) output factor; panel: (ns, 3 * 64 * 64 + 128) scratch and
// partial: (ns, ns, 128) scratch, ns = ceil(n / 128); cnt: (ns, ns) int32
// counters, zero on entry; tasks: the workers' list of `count` int32 tasks
// (ops/fused_mll.task_table: pair << 30 | k << 20 | j << 10 | i each);
// out: (2,) = (quad, logdet_half). All device
// pointers, contiguous, float32 unless stated, on the current device; fam:
// 0 SE, 1 Matern-3/2, 2 Matern-5/2; stream: a cudaStream_t. n must be a
// positive multiple of 64. Returns 0 or the cudaError_t of the first failed
// call (cudaErrorInvalidValue, without launching, for arguments it does not
// take; cudaErrorNotSupported where the device cannot launch a cooperative
// grid).
extern "C" int hyperbo_mll_fused(const float* x, const float* valid,
                                 const float* sv_da, float* y, int n, int d,
                                 int fam, float* l, float* panel,
                                 float* partial, int* cnt, const int* tasks,
                                 int count, float* out, void* stream) {
  if (n < kB || n % kB != 0 || n > 1024 * kW || d < 1 || count < 0 ||
      fam < hyperbo::kSe || fam > hyperbo::kMatern52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  cudaError_t err = grid_size(&grid, nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = n / kB;
  gram::gram_tiles<<<dim3(nb, nb), kThreads, 0, s>>>(x, valid, sv_da, n, d,
                                                      fam, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g;
  g.l = l;
  g.y = y;
  g.panel = panel;
  g.partial = partial;
  g.cnt = cnt;
  g.tasks = tasks;
  g.out = out;
  g.n = n;
  g.ns = (n + kW - 1) / kW;
  g.count = count;
  g.workers = grid - 1;
  void* args[] = {&g};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(persistent_factor), dim3(grid),
      dim3(kThreads), args, kSmemBytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// info[0..4] = blocks of the persistent grid, blocks a multiprocessor,
// multiprocessors, dynamic shared memory bytes a block, threads a block, on
// the current device. Returns 0 or a cudaError_t.
extern "C" int hyperbo_mll_fused_info(int* info) {
  const cudaError_t err = grid_size(&info[0], &info[1], &info[2]);
  info[3] = kSmemBytes;
  info[4] = kThreads;
  return static_cast<int>(err);
}

#ifdef HYPERBO_MLL_LAPS
// Where the next launches write their laps: (grid blocks, 17) int64, in
// cycles of each block's SM: slot 0 the block's span; the chain (block 0):
// 1 its first load, 2 the diagonal factors, 3 the solve and update between
// a step's two, 4 the wait beyond the factors, 5 the solve of the tile
// below beside z_k, 6 the lookahead beside the releases, 7-9 the diagonal
// factors' first sub-block factors, row solves, and trailing updates with
// the next sub-block's factor, 10 what warps 4-7 spent waiting on counters;
// workers: 11 waits on counters, 12 waits on a solve's loads, 13 panel
// solves and their stores, 14 held updates, 15 trailing updates, 16 stores,
// partials and releases. And the timeline, (1 + 2 ns + grid blocks) int64:
// 0 the chain's start and 1 + k the end of its step k in global
// nanoseconds, 1 + ns + k the cycles its warps 4-7 spent waiting on
// counters up to that step's end, 1 + 2 ns + b the end of worker block b.
extern "C" int hyperbo_mll_fused_laps(long long* laps, long long* trace) {
  cudaError_t err = cudaMemcpyToSymbol(g_laps, &laps, sizeof(laps));
  if (err == cudaSuccess) {
    err = cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace));
  }
  return static_cast<int>(err);
}
#endif
