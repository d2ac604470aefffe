// Blocked Cholesky of dense SPD matrices on Hopper, one persistent launch
// with lookahead (kernel K6).
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_chol_hbm.py:
// cholesky_hbm (its pallas_call at :825) and the three other VMEM layouts of
// the same factorization, cholesky_hbm_halves (:793), cholesky_hbm_wide
// (:761) and cholesky_hbm_halfwide (:723). Those stream column panels
// between HBM and VMEM by explicit DMA, left-looking, inside one kernel. The
// TPU's bf16-split products (_pdot, _dekker_split) emulated float32 products
// on the MXU; every product here is a float32 FMA (no TF32).
//
// What bounds it on an H100. n^3/3 float32 operations a matrix (3.6e8 at
// n = 1024, 5.3 us at the card's 67 TFLOP/s) against 8 n^2 bytes in and out
// (8.4 MB, 2.5 us at 3.35 TB/s): by operations, on paper. In fact the chain
// of n / 64 dependent diagonal factors sets the time at the sizes the model
// evaluation factors (n = 1024, one matrix): each factor is 64 pivots on one
// SM. The design keeps that chain on one block, keeps what the chain waits
// for off other blocks' critical paths, and spreads all other work over the
// card beside it (tools/probe_chol_hbm.py splits a call by part).
//
// Design. One cooperative grid (cudaLaunchCooperativeKernel, as many blocks
// as fit at once) factors right-looking in 64-wide block columns, with the
// matrix in the output buffer l. A tile (i, j), j <= i, is 64 x 64. Roles:
//   chain   one block a matrix (chains = min(batch, blocks / 2)) runs the
//           critical path, step k = 0 .. nb - 1. Warps 0-3 factor the
//           diagonal tile (k, k) in shared memory (K7's diagonal factor,
//           chol_diag64.cuh: rsqrt.approx.ftz pivots with no branch,
//           16-wide sub-panels under the named barrier of those four warps)
//           while warps 4-7 wait for and load what comes next: the tiles
//           (k + 1, k) and (k + 2, k) and the next diagonal tile. Then warps
//           0-3 solve both tiles below, a row a thread (solve_rows), while
//           warps 4-7 publish L_kk^T and the pivots for the workers' solves
//           and release (k, k). Then warps 0-3 take (k + 1, k)'s products
//           from (k + 1, k + 1) in shared memory (the lookahead) while warps
//           4-7 store and release the two solved tiles. The chain solves two
//           tiles so that the next diagonal tile and (k + 2, k + 1) depend
//           on the chain's own results and one worker update each.
//   worker  every other block walks a fixed list, step by step: the panel
//           solves L_ik = A_ik L_kk^-T for i >= k + 3, one tile a task, each
//           followed in the same block by the update of (i, k + 1) with the
//           chain's L_{k+1,k} (so the tile the chain's next step loads last
//           is one hand-off away, not two); then the rest of step k's
//           trailing update A_ij -= L_ik L_jk^T over the lower tile pairs,
//           block column k + 1 first; at the end the upper tiles of l are
//           zeroed. Each step's tasks go round robin from worker 0, so its
//           solves go to workers that are not held up by the end of the
//           step before.
// Ordering is by per-tile counters in global memory (form (b)): counter
// (i, j) is the number of updates tile (i, j) holds, and j + 1 once it is
// final. A task waits (one thread spinning on relaxed loads, then an
// acquire fence and a block barrier) only on the tiles it reads. A writer
// releases after its block's stores (barrier, fence, store of the
// counter). The counters order work and never touch data, so each entry of
// L is one sum in a fixed order: its updates in k ascending, each a 64-deep
// FP32 FMA product subtracted once, then the solve's fixed column sweep;
// two calls are bitwise equal. A worker loads its next task's tiles with
// cp.async while it computes the current one when that task's inputs are
// already released (double buffering across tasks). The first update of a
// tile reads A (a diagonal tile only below its diagonal), so the load is
// part of the factorization and A is not written. Grid barriers between
// the parts of a step instead of counters were slower on the card at every
// shape tried: no worker can start a step before the slowest block ends
// the one before.
//
// Why not a thread-block cluster a matrix, as K7: at n = 1024 there are 16
// block columns, more than the portable cluster of 8, and one block column
// (1024 x 64 floats, 256 KB) does not fit in a block's 227 KB of shared
// memory.
//
// Any n that is a positive multiple of 64 (n = 64 is one diagonal factor),
// any batch up to 65535 (in rounds of `chains` matrices); offsets are
// 64-bit. The kernel allocates nothing: the wrapper passes the counters
// (zeroed each call) and the scratch for the published L_kk^T and pivots.
// A matrix that is not positive definite comes out non-finite (no pivot
// clamp); the wrapper (ops/chol_hbm.py) makes its whole factor NaN.
//
// hyperbo_chol_hbm_stamped runs the same kernel with clock64() laps of its
// parts, for tools/probe_chol_hbm.py; hyperbo_chol_hbm_info reports the
// launch's shape.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "chol_diag64.cuh"
#include "chol_persistent.cuh"
#include "gemm_core.cuh"

namespace {

using namespace hyperbo::chol64;
using hyperbo::cp_async_commit;
using hyperbo::cp_async_wait_one;

constexpr int kTileFloats = kB * kLd;       // a 64 x 64 tile in shared memory
constexpr int kPanelFloats = kB * kB + kB;  // L_kk^T and 1 / sqrt(pivots)
constexpr int kStageFloats = 5 * kTileFloats;
constexpr int kSmemBytes = static_cast<int>(sizeof(float)) * 2 * kStageFloats;
static_assert(5 * kTileFloats + kPanelFloats <= 2 * kStageFloats,
              "the chain's buffers fit in the workers' two stages");
constexpr int kMaxDevices = 64;

// Probe laps (cycles) of thread 0 of each block.
enum Slot {
  kSlotSpan,          // the whole kernel
  kSlotChainLoad,     // chain: the first diagonal tile
  kSlotChainDiag,     // chain: diagonal factors (warps 0-3)
  kSlotChainWait,     // chain: beyond the factor, warps 4-7's waits and loads
  kSlotChainSolve,    // chain: panel solves
  kSlotChainUpdate,   // chain: lookahead updates beside the releases
  kSlotWorkerWait,    // worker: waiting on counters
  kSlotWorkerLoad,    // worker: waiting on its loads
  kSlotWorkerSolve,   // worker: panel solves with their stores
  kSlotWorkerUpdate,  // worker: updates with their stores
  kSlotWorkerZero,    // worker: zeroing upper tiles
  kSlotWorkerStore,   // worker: stores and releases of solves and updates
  kSlotSplit,         // chain: the diagonal factors' split, 3 slots
  kSlotChainSpin = kSlotSplit + 3,  // chain: warps 4-7 waiting on counters
  kStampSlots,
};
using BlockLaps = Laps<kStampSlots>;

struct Geometry {
  const float* a;
  float* l;
  float* panel;  // (batch, nb, kPanelFloats)
  int* cnt;      // (batch, nb, nb)
  long long* stamps;
  int n, nb, batch, chains, workers;
};

__device__ __forceinline__ long long tile_at(const Geometry& g, int b, int i,
                                             int j) {
  return static_cast<long long>(b) * g.n * g.n +
         static_cast<long long>(i) * kB * g.n + static_cast<long long>(j) * kB;
}

__device__ __forceinline__ int* counter(const Geometry& g, int b, int i,
                                        int j) {
  return g.cnt + (static_cast<long long>(b) * g.nb + i) * g.nb + j;
}

__device__ __forceinline__ float* panel_at(const Geometry& g, int b, int k) {
  return g.panel + (static_cast<long long>(b) * g.nb + k) * kPanelFloats;
}

// The lower triangle of a diagonal tile of A, zeros above: A's upper
// triangle is never read.
template <int kN>
__device__ __forceinline__ void load_lower_tile(float* dst, const float* src,
                                                long long ld, int t) {
  for (int idx = t; idx < kB * kB; idx += kN) {
    const int r = idx / kB;
    const int c = idx % kB;
    dst[r * kLd + c] = c <= r ? __ldg(src + r * ld + c) : 0.0f;
  }
}

// Tile (i, j) of matrix b holding `version` updates: A's for version 0,
// else l's (in flight by cp.async until the caller waits on its group).
template <int kN>
__device__ __forceinline__ void fetch_tile(const Geometry& g, int b, int i,
                                           int j, int version, float* dst,
                                           int t) {
  const long long at = tile_at(g, b, i, j);
  if (version > 0) {
    copy_rows_async<kN>(dst, g.l + at, g.n, kB, t);
  } else if (i == j) {
    load_lower_tile<kN>(dst, g.a + at, g.n, t);
  } else {
    copy_rows_async<kN>(dst, g.a + at, g.n, kB, t);
  }
}

// Rows 64 .. rows - 1 of a block column (shared rows kLd apart) <- x L^-T,
// one row a thread (solve_row).
__device__ void solve_rows(float* col, int rows, const float* lt,
                           const float* rdiag) {
  for (int i = kB + static_cast<int>(threadIdx.x); i < rows; i += kThreads) {
    solve_row(col + i * kLd, lt, rdiag);
  }
}

// The tiles below the diagonal that the chain solves itself at step k:
// (k + 1, k) and (k + 2, k), where they exist.
__device__ __forceinline__ int chain_rows(int nb, int k) {
  return min(2, nb - 1 - k);
}

// The chain of matrix b: its diagonal factors, the panel solve of the two
// tiles below each, and the lookahead update of the next diagonal tile.
__device__ void run_chain(const Geometry& g, int b, float* smem,
                          BlockLaps& laps) {
  float* diag = smem;                 // (64, kLd): tile (k, k)
  float* below = smem + kTileFloats;  // (128, kLd): (k + 1, k), (k + 2, k)
  float* next = below + 2 * kTileFloats;  // (64, kLd): tile (k + 1, k + 1)
  float* lt = next + kTileFloats;     // (64, 64): L_kk^T
  float* rdiag = lt + kB * kB;        // (64,): 1 / sqrt of L_kk's pivots
  const int tid = threadIdx.x;
  long long spin = 0;
  load_lower_tile<kThreads>(diag, g.a + tile_at(g, b, 0, 0), g.n, tid);
  __syncthreads();
  laps.add(kSlotChainLoad);
  for (int k = 0; k < g.nb; ++k) {
    const int rows = chain_rows(g.nb, k);
    // Warps 0-3 factor (k, k); warps 4-7 wait for and load the tiles the
    // rest of the step reads.
    if (tid < kHalf) {
      factor_diagonal<kSlotSplit>(diag, kB, lt, rdiag, laps);
      laps.add(kSlotChainDiag);
    } else if (rows > 0) {
      const int t = tid - kHalf;
      if (t == 0) {
        const long long start = clock64();
        for (int r = 1; r <= rows; ++r) {
          spin_until(counter(g, b, k + r, k), k);
        }
        spin_until(counter(g, b, k + 1, k + 1), k);
        fence_acq_rel();
        spin += clock64() - start;
      }
      sync_bar<2>();
      for (int r = 0; r < rows; ++r) {
        fetch_tile<kHalf>(g, b, k + 1 + r, k, k, below + r * kTileFloats, t);
      }
      fetch_tile<kHalf>(g, b, k + 1, k + 1, k, next, t);
      cp_async_commit();
      cp_async_wait_all();
    }
    __syncthreads();
    laps.add(kSlotChainWait);
    // Warps 0-3 solve the tiles below, a row a thread; warps 4-7 release
    // L_kk's transpose and pivots for the workers' solves, then store L_kk
    // (which no block reads back).
    if (tid < kHalf) {
      solve_rows(below - kTileFloats, (rows + 1) * kB, lt, rdiag);
    } else {
      const int t = tid - kHalf;
      float* pk = panel_at(g, b, k);
      for (int c = 4 * t; c < kPanelFloats; c += 4 * kHalf) {
        st4(pk + c, ld4(lt + c));  // lt and rdiag are contiguous
      }
      sync_bar<2>();
      if (t == 0) release(counter(g, b, k, k), k + 1);
      store_rows<kHalf>(g.l + tile_at(g, b, k, k), g.n, diag, kB, true, t);
    }
    __syncthreads();
    laps.add(kSlotChainSolve);
    if (rows == 0) break;
    // Warps 0-3: the lookahead update of (k + 1, k + 1). Warps 4-7: the
    // solved tiles to memory, then released.
    if (tid < kHalf) {
      tile_product<kHalf>(next, kB, 0, below, below, tid);
    } else {
      const int t = tid - kHalf;
      for (int r = 0; r < rows; ++r) {
        store_rows<kHalf>(g.l + tile_at(g, b, k + 1 + r, k), g.n,
                          below + r * kTileFloats, kB, false, t);
      }
      sync_bar<2>();
      if (t == 0) {
        fence_acq_rel();
        for (int r = 1; r <= rows; ++r) {
          st_relaxed(counter(g, b, k + r, k), k + 1);
        }
      }
    }
    __syncthreads();
    laps.add(kSlotChainUpdate);
    float* swap = diag;
    diag = next;
    next = swap;
  }
  if (g.stamps != nullptr && tid == kHalf) {
    g.stamps[blockIdx.x * kStampSlots + kSlotChainSpin] += spin;
  }
}

enum Kind { kNone, kSolve, kUpdate, kZero };

struct Task {
  int kind, b, i, j, k;
};

// Phase p of a round of `mats` matrices: 2 k the panel solves of step k,
// 2 k + 1 its trailing update (k < nb - 1), 2 (nb - 1) the upper tiles.
__device__ __forceinline__ long long phase_count(int nb, int mats, int p) {
  if (p == 2 * (nb - 1)) {
    return static_cast<long long>(mats) * nb * (nb - 1) / 2;
  }
  const int m = nb - 1 - p / 2;
  return p % 2 == 0 ? static_cast<long long>(mats) * max(m - 2, 0)
                    : static_cast<long long>(mats) * ((m > 1) + m * (m - 1) / 2);
}

// Task t of phase p: matrices side by side (b = t mod mats); a step's
// solves by row (each with the update of (i, k + 1), so the rows from k + 3
// of block column k + 1 are not in the update); its update in column-major
// order from block column k + 1, leaving out the chain's tile (k + 1, k + 1);
// upper tiles (i, j), i < j, by j, then i.
__device__ __forceinline__ Task decode(int nb, int first, int mats, int p,
                                       long long t) {
  const int b = first + static_cast<int>(t % mats);
  int u = static_cast<int>(t / mats);
  if (p == 2 * (nb - 1)) {
    int r = 1;
    while (u >= r) {
      u -= r;
      ++r;
    }
    return {kZero, b, u, r, 0};
  }
  const int k = p / 2;
  if (p % 2 == 0) return {kSolve, b, k + 3 + u, k, k};
  const int m = nb - 1 - k;
  if (m > 1 && u-- == 0) return {kUpdate, b, k + 2, k + 1, k};
  int c = 1;
  while (u >= m - c) {
    u -= m - c;
    ++c;
  }
  return {kUpdate, b, k + 1 + c + u, k + 1 + c, k};
}

// The tasks of worker w, in order: phase by phase, round by round, every
// workers-th task of the sequence of a step's tasks (its solves, then its
// update), which starts at worker 0 each step: a step's solves, the first
// tasks on the way to the chain's next loads, then go to workers that
// took only the solves and first updates of the step before, where a step
// has no more tasks than there are workers, and not to one still waiting
// on the end of the step before.
struct WorkList {
  int nb, batch, chains, workers, w;
  int first, mats, phase;
  long long t, count, off;

  __device__ void start(const Geometry& g, int worker) {
    nb = g.nb;
    batch = g.batch;
    chains = g.chains;
    workers = g.workers;
    w = worker;
    first = 0;
    mats = min(chains, batch);
    phase = 0;
    off = 0;
    count = phase_count(nb, mats, 0);
    t = w;
  }

  __device__ Task next() {
    while (t >= count) {
      off = (off + count) % workers;
      if (++phase > 2 * (nb - 1)) {
        phase = 0;
        first += chains;
        if (first >= batch) return {kNone, 0, 0, 0, 0};
        mats = min(chains, batch - first);
      }
      if (phase % 2 == 0) off = 0;  // a step starts again at worker 0
      count = phase_count(nb, mats, phase);
      t = ((w - off) % workers + workers) % workers;
    }
    const Task task = decode(nb, first, mats, phase, t);
    t += workers;
    return task;
  }
};

// Whether every tile the task reads is released (thread 0, no waiting).
__device__ __forceinline__ bool ready(const Geometry& g, const Task& s) {
  if (s.kind == kSolve) {
    return ld_relaxed(counter(g, s.b, s.k, s.k)) >= s.k + 1 &&
           ld_relaxed(counter(g, s.b, s.i, s.k)) >= s.k;
  }
  if (s.kind == kUpdate) {
    return ld_relaxed(counter(g, s.b, s.i, s.k)) >= s.k + 1 &&
           ld_relaxed(counter(g, s.b, s.j, s.k)) >= s.k + 1 &&
           ld_relaxed(counter(g, s.b, s.i, s.j)) >= s.k;
  }
  return true;
}

// Thread 0 waits until ready(s); the caller's barrier follows.
__device__ __forceinline__ void wait_for(const Geometry& g, const Task& s) {
  if (s.kind == kSolve) {
    spin_until(counter(g, s.b, s.k, s.k), s.k + 1);
    spin_until(counter(g, s.b, s.i, s.k), s.k);
  } else if (s.kind == kUpdate) {
    spin_until(counter(g, s.b, s.i, s.k), s.k + 1);
    spin_until(counter(g, s.b, s.j, s.k), s.k + 1);
    spin_until(counter(g, s.b, s.i, s.j), s.k);
  }
  fence_acq_rel();
}

// A stage is five shared tiles. A solve: rdiag in tile 0, the row tile in
// tile 1 (rows 64 .. 127 of the block column that solve_rows takes), L_kk^T
// in tile 2, then its update's target (i, k + 1) in tile 3 and L_{k+1,k} in
// tile 4. An update: the target in tile 0, L_ik in tile 1, L_jk in tile 2.
__device__ __forceinline__ void fetch_task(const Geometry& g, const Task& s,
                                           float* stage) {
  const int tid = threadIdx.x;
  if (s.kind == kSolve) {
    const float* pk = panel_at(g, s.b, s.k);
    fetch_tile<kThreads>(g, s.b, s.i, s.k, s.k, stage + kTileFloats, tid);
    copy_async<kThreads>(stage + 2 * kTileFloats, pk, kB * kB, tid);
    copy_async<kThreads>(stage, pk + kB * kB, kB, tid);
  } else if (s.kind == kUpdate) {
    fetch_tile<kThreads>(g, s.b, s.i, s.j, s.k, stage, tid);
    fetch_tile<kThreads>(g, s.b, s.i, s.k, s.k + 1, stage + kTileFloats, tid);
    if (s.i != s.j) {
      fetch_tile<kThreads>(g, s.b, s.j, s.k, s.k + 1,
                           stage + 2 * kTileFloats, tid);
    }
  }
}

// Computes, stores and releases a task whose tiles are in `stage`.
__device__ __forceinline__ void run_task(const Geometry& g, const Task& s,
                                         float* stage, BlockLaps& laps) {
  const int tid = threadIdx.x;
  if (s.kind == kZero) {
    float* dst = g.l + tile_at(g, s.b, s.i, s.j);
    for (int idx = tid; idx < kB * kB / 4; idx += kThreads) {
      st4(dst + (idx / (kB / 4)) * static_cast<long long>(g.n) +
              4 * (idx % (kB / 4)),
          make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
    return;
  }
  if (s.kind == kSolve) {
    // L_ik, held until (i, k + 1) has taken its product: one hand-off less
    // on the way to the chain's next loads.
    float* x = stage + kTileFloats;
    solve_rows(stage, 2 * kB, stage + 2 * kTileFloats, stage);
    __syncthreads();
    laps.add(kSlotWorkerSolve);
    store_rows<kThreads>(g.l + tile_at(g, s.b, s.i, s.k), g.n, x, kB, false,
                         tid);
    if (tid == 0) {
      spin_until(counter(g, s.b, s.k + 1, s.k), s.k + 1);
      spin_until(counter(g, s.b, s.i, s.k + 1), s.k);
      fence_acq_rel();
    }
    __syncthreads();
    float* target = stage + 3 * kTileFloats;
    fetch_tile<kThreads>(g, s.b, s.i, s.k + 1, s.k, target, tid);
    fetch_tile<kThreads>(g, s.b, s.k + 1, s.k, s.k + 1,
                         stage + 4 * kTileFloats, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    laps.add(kSlotWorkerWait);
    tile_product<kThreads>(target, kB, 0, x, stage + 4 * kTileFloats, tid);
    __syncthreads();
    laps.add(kSlotWorkerUpdate);
    store_rows<kThreads>(g.l + tile_at(g, s.b, s.i, s.k + 1), g.n, target,
                         kB, false, tid);
    __syncthreads();
    if (tid == 0) {
      fence_acq_rel();
      st_relaxed(counter(g, s.b, s.i, s.k), s.k + 1);
      st_relaxed(counter(g, s.b, s.i, s.k + 1), s.k + 1);
    }
    return;
  }
  const float* lj = s.i == s.j ? stage + kTileFloats
                               : stage + 2 * kTileFloats;
  tile_product<kThreads>(stage, kB, 0, stage + kTileFloats, lj, tid);
  __syncthreads();
  laps.add(kSlotWorkerUpdate);
  store_rows<kThreads>(g.l + tile_at(g, s.b, s.i, s.j), g.n, stage, kB,
                       false, tid);
  __syncthreads();
  if (tid == 0) release(counter(g, s.b, s.i, s.j), s.k + 1);
}

// A worker's list, the next task's tiles in flight during the current one
// where they are already released.
__device__ void run_worker(const Geometry& g, int w, float* smem,
                           BlockLaps& laps) {
  __shared__ int next_ready;
  const int tid = threadIdx.x;
  WorkList list;
  list.start(g, w);
  Task cur = list.next();
  int s = 0;
  if (cur.kind != kNone) {
    if (tid == 0) wait_for(g, cur);
    __syncthreads();
    laps.add(kSlotWorkerWait);
    fetch_task(g, cur, smem);
  }
  cp_async_commit();
  while (cur.kind != kNone) {
    const Task nxt = list.next();
    bool pre = false;
    if (nxt.kind != kNone) {
      if (tid == 0) {
        next_ready = ready(g, nxt);
        if (next_ready) fence_acq_rel();
      }
      __syncthreads();
      pre = next_ready != 0;
      if (pre) fetch_task(g, nxt, smem + (s ^ 1) * kStageFloats);
      laps.add(kSlotWorkerWait);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    laps.add(kSlotWorkerLoad);
    run_task(g, cur, smem + s * kStageFloats, laps);
    laps.add(cur.kind == kZero ? kSlotWorkerZero : kSlotWorkerStore);
    if (nxt.kind != kNone && !pre) {
      if (tid == 0) wait_for(g, nxt);
      __syncthreads();
      laps.add(kSlotWorkerWait);
      fetch_task(g, nxt, smem + (s ^ 1) * kStageFloats);
      cp_async_commit();
    }
    cur = nxt;
    s ^= 1;
  }
  cp_async_wait_all();
}

template <bool kStamp>
__global__ void __launch_bounds__(kThreads, 1)
persistent_cholesky(Geometry g) {
  extern __shared__ __align__(16) float smem[];
  BlockLaps laps;
  laps.out = nullptr;
  laps.last = 0;
  if (kStamp && threadIdx.x == 0) {
    laps.out = g.stamps + static_cast<long long>(blockIdx.x) * kStampSlots;
    for (int i = 0; i < kStampSlots; ++i) laps.sum[i] = 0;
    laps.last = clock64();
  }
  const long long start = laps.last;
  const int block = static_cast<int>(blockIdx.x);
  if (block < g.chains) {
    for (int b = block; b < g.batch; b += g.chains) run_chain(g, b, smem, laps);
  } else {
    run_worker(g, block - g.chains, smem, laps);
  }
  if (laps.out != nullptr) {
    laps.sum[kSlotSpan] = clock64() - start;
    for (int i = 0; i < kSlotChainSpin; ++i) laps.out[i] = laps.sum[i];
  }
}

std::atomic<int> g_grid[kMaxDevices][2];

// Once a device and kernel: allow its shared memory and size the grid from
// the blocks that fit at once.
template <class Kernel>
cudaError_t grid_size(Kernel kernel, int which, int* grid, int* per_sm_out,
                      int* sms_out) {
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
  if (cached && g_grid[dev][which].load() > 0) {
    per_sm = g_grid[dev][which].load();
  } else {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (cached && per_sm > 0) g_grid[dev][which].store(per_sm);
  }
  *grid = per_sm * sms;
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  if (sms_out != nullptr) *sms_out = sms;
  // A chain block and a worker at least.
  return *grid < 2 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <class Kernel>
int launch(Kernel kernel, int which, const float* a, float* l, float* panel,
           int* cnt, int n, int batch, long long* stamps, void* stream) {
  if (n < kB || n % kB != 0 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  cudaError_t err = grid_size(kernel, which, &grid, nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g;
  g.a = a;
  g.l = l;
  g.panel = panel;
  g.cnt = cnt;
  g.stamps = stamps;
  g.n = n;
  g.nb = n / kB;
  g.batch = batch;
  g.chains = std::min(batch, grid / 2);
  g.workers = grid - g.chains;
  void* args[] = {&g};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kThreads), args,
                                    kSmemBytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (batch, n, n) input, l: (batch, n, n) output factor; panel: (batch,
// n / 64, 64 * 64 + 64) float32 scratch; cnt: (batch, n / 64, n / 64) int32
// counters, zero on entry. Device pointers, contiguous; stream: a
// cudaStream_t; the current device is the tensors'. n must be a positive
// multiple of 64 and batch at most 65535. Returns 0 or the cudaError_t of
// the first failed call (cudaErrorInvalidValue, without launching, for
// arguments it does not take; cudaErrorNotSupported where the device cannot
// launch a cooperative grid).
extern "C" int hyperbo_chol_hbm(const float* a, float* l, float* panel,
                                int* cnt, int n, int batch, void* stream) {
  return launch(persistent_cholesky<false>, 0, a, l, panel, cnt, n, batch,
                nullptr, stream);
}

// hyperbo_chol_hbm with clock64() laps of thread 0 of every block written
// to stamps, (grid, 16) int64 on the device (grid from
// hyperbo_chol_hbm_info), in cycles of the block's SM: slot 0 the block's
// span; chains: 1 the first load, 2 the diagonal factors, 3 the wait for
// warps 4-7 beyond them, 4 the panel solves, 5 the lookahead updates;
// workers: 6 waits on counters, 7 waits on loads, 8 panel solves, 9
// updates, 10 upper zeros, 11 stores and releases; chains: 12-14 the
// diagonal factors' first sub-block factors, row solves, and trailing
// updates with the next sub-block's factor, 15 what warps 4-7 spent
// waiting on counters.
extern "C" int hyperbo_chol_hbm_stamped(const float* a, float* l,
                                        float* panel, int* cnt, int n,
                                        int batch, long long* stamps,
                                        void* stream) {
  if (stamps == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(persistent_cholesky<true>, 1, a, l, panel, cnt, n, batch,
                stamps, stream);
}

// info[0..4] = blocks of the grid, blocks a multiprocessor, multiprocessors,
// dynamic shared memory bytes a block, threads a block, on the current
// device. Returns 0 or a cudaError_t.
extern "C" int hyperbo_chol_hbm_info(int* info) {
  const cudaError_t err = grid_size(persistent_cholesky<false>, 0, &info[0],
                                    &info[1], &info[2]);
  info[3] = kSmemBytes;
  info[4] = kThreads;
  return static_cast<int>(err);
}
