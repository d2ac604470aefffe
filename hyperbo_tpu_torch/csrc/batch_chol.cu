// Batched small-matrix Cholesky inverse-transpose on Hopper: K -> B = L^{-T}.
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_batch_chol.py
// (_sweep_kernel_3d / _sweep_kernel_2d, launched by _linv_t_tasks3d and
// _linv_t_grid2d from batched_linv_t). It computes what they compute: the
// outer-product (right-looking) Cholesky sweep run on the stacked working
// set W = [K; I]. Each step j scales column j by rp = rsqrt(W[j][j]) and
// subtracts its outer product with L[c][j] from the columns c > j; applied
// to the identity block as well, the column operations leave B = L^{-T}
// there.
//
// Here the sweep is blocked by 32-column panels, so that a task takes a
// handful of block barriers (2 a panel, 10 at n = 100) instead of two a
// step, and each entry of W is read and written in shared memory once a
// panel instead of once a step. For the panel [p0, p1):
//
//   1. factor: warp 0 runs the panel's steps on its diagonal tile, a row
//      of the tile a lane in registers, the pivot by a shuffle and the
//      scaled column through shared memory (lt, rpv): no block barrier;
//   2. solve: the n live rows below the tile (top rows p1 .. n-1 and the
//      identity rows 0 .. p1-1, stacked rows p1 .. n+p1-1) each run the
//      same steps on their panel entries, a row a thread in registers,
//      reading the tile's column j and rp as broadcasts;
//   3. update: every live row subtracts the panel's rank-32 product from
//      its columns p1 .. n-1, the panel steps in order (the sweep's order
//      of subtraction for each entry). Warp 0 takes the next panel's
//      diagonal tile, a row a lane, and goes straight on to factor it
//      (phase 1 of the next panel) while the 12 warps that do not share
//      its scheduler update the rest, a 4 x 4 patch of entries a thread.
//
// Each entry sees the unblocked sweep's operations in its order, so B is
// bitwise the unblocked sweep's. ops/batch_chol.py linv_t_steps is the
// float64 mirror of this schedule, and update_owners the map of phase 3 to
// threads (tests/test_torch_batch_chol_schedule.py holds both).
//
// The input is symmetrized as the batch is loaded: the kernel factors
// 0.5 (K[r][c] + K[c][r]), the float operations of 0.5 (K + K^T), so the
// caller needs no symmetric copy.
//
// No pivot clamp: rsqrt of a non-positive pivot gives NaN (or inf, then
// NaN), which propagates to B, so a matrix that is not positive definite
// comes out non-finite and the trainer's NaN-freeze trips, as on the TPU.
// Deterministic: no atomics, one fixed order of operations an entry.
//
// Layout. One 512-thread block per task; n <= 128 is a run-time argument.
// W lives in dynamic shared memory, its rows 16-byte aligned (row_stride):
// with lt and rpv, 136 KiB at n = 128, under the 227 KiB a block may use.
// Phases 1 and 2 run each step as the same code on a row held shifted in
// registers (shift_sub), so the kernel's code stays small.
//
// What bounds it on an H100. It reads K once and writes B once (80 KB a
// task at n = 100: 0.55 us for 23 tasks at 3.35 TB/s), and does n^3/2
// multiply-adds a task, but it is a chain of n dependent pivots: the
// time is the latency of that chain (a shuffle, an rsqrt, a shared-memory
// round trip and a multiply-add a pivot in phase 1, a multiply-add chain
// in phase 2) plus 2 barriers a panel. With one block per task, 23 tasks
// use 23 of the 132 SMs.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 512;
constexpr int kPanel = 32;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// Row stride of W: a multiple of 4 (16-byte rows, float4 reads along a
// row) with an odd quotient, so that a float4 from each of 8 consecutive
// rows hits 8 distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int row_stride(int n) {
  const int ld = (n + 3) & ~3;
  return (ld / 4) % 2 ? ld : ld + 4;
}

// x[c] <- x[c + 1] - y v[c] for c < 32, x[32] read as 0: one step of the
// sweep on a panel row held shifted (x[c] is the row's column j + c at
// step j), so that every step runs the same code; v is the step's column
// of L below the pivot, as 8 float4s from shared memory.
__device__ __forceinline__ void shift_sub(float* x, float y, const float* v) {
#pragma unroll
  for (int c4 = 0; c4 < kPanel / 4; ++c4) {
    const float4 u = reinterpret_cast<const float4*>(v)[c4];
    x[4 * c4 + 0] = fmaf(-y, u.x, x[4 * c4 + 1]);
    x[4 * c4 + 1] = fmaf(-y, u.y, x[4 * c4 + 2]);
    x[4 * c4 + 2] = fmaf(-y, u.z, x[4 * c4 + 3]);
    x[4 * c4 + 3] = c4 + 1 < kPanel / 4 ? fmaf(-y, u.w, x[4 * c4 + 4]) : 0.0f;
  }
}

// 32 floats of a 16-byte aligned shared row into registers.
__device__ __forceinline__ void load_row(float* x, const float* row) {
#pragma unroll
  for (int c4 = 0; c4 < kPanel / 4; ++c4) {
    const float4 u = reinterpret_cast<const float4*>(row)[c4];
    x[4 * c4 + 0] = u.x;
    x[4 * c4 + 1] = u.y;
    x[4 * c4 + 2] = u.z;
    x[4 * c4 + 3] = u.w;
  }
}

// Phase 1, warp 0: the panel's pw steps on its diagonal tile. Lane r holds
// row r of the tile in d, shifted (entries past the panel, or above the
// diagonal, never reach d[0] before the lane's row is done). Step j
// publishes lt[j][c] = L[p0 + j + 1 + c][p0 + j], the column below the
// pivot, and rpv[j] = rsqrt(pivot j).
__device__ __forceinline__ void factor_tile(float* d, int pw, float* lt,
                                            float* rpv) {
  const int lane = threadIdx.x % 32;
  for (int j = 0; j < pw; ++j) {
    const float rp = rsqrtf(__shfl_sync(kFull, d[0], j));
    const float l = d[0] * rp;  // L[p0 + lane][p0 + j] for lane > j
    if (lane > j) lt[j * kPanel + lane - j - 1] = l;
    if (lane == j) rpv[j] = rp;
    __syncwarp();
    shift_sub(d, l, lt + j * kPanel);
  }
}

// Phase 2: the panel's steps on one live row's entries p0 .. p1-1, the
// same shifted row; each step's result goes back to the row.
__device__ __forceinline__ void solve_row(float* row, int pw, const float* lt,
                                          const float* rpv) {
  float x[kPanel];
  load_row(x, row);
  for (int j = 0; j < pw; ++j) {
    const float y = x[0] * rpv[j];
    row[j] = y;
    shift_sub(x, y, lt + j * kPanel);
  }
}

// Phase 3 on the next panel's diagonal tile (rows and columns p1 ..
// p1 + 31), by warp 0: lane i's row p1 + i of it into d, minus the
// product of the panel [p0, p0 + 32), in registers only. Lanes past the
// next panel's width pw2 get d = 0.
__device__ __forceinline__ void update_tile(float* d, const float* w, int ld,
                                            int p0, int p1, int pw2) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < kPanel; ++c) d[c] = 0.0f;
  if (lane >= pw2) return;
  load_row(d, w + (p1 + lane) * ld + p1);
  const float* a = w + (p1 + lane) * ld + p0;
#pragma unroll 1
  for (int j = 0; j < kPanel; j += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + j);
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      const float4 bv =
          *reinterpret_cast<const float4*>(w + (p1 + c) * ld + p0 + j);
      d[c] = fmaf(-av.x, bv.x, d[c]);
      d[c] = fmaf(-av.y, bv.y, d[c]);
      d[c] = fmaf(-av.z, bv.z, d[c]);
      d[c] = fmaf(-av.w, bv.w, d[c]);
    }
  }
}

// Phase 3 on the rest, by the 12 warps that do not share warp 0's
// scheduler (warp % 4 != 0; warps 4, 8 and 12 wait, so that warp 0's
// chain of factor steps gets its scheduler's issue slots): live rows
// p1 + i (i < n) minus the product of the panel [p0, p0 + 32) on columns
// p1 .. n-1, skipping the next panel's diagonal tile (i, c < pw2), which
// warp 0 takes. Update thread u (u = 32 (warp - warp / 4 - 1) + lane)
// takes patches u, u + kUpdateThreads, ...; patch (rq, cq) holds rows
// i = rq + nrq a and columns p1 + cq + ncq b (a, b < 4), so consecutive
// lanes read consecutive rows' panel entries, four steps a float4.
constexpr int kUpdateThreads = kThreads * 3 / 4;

__device__ __forceinline__ void update_trailing(float* w, int ld, int n,
                                                int p0, int p1, int pw2) {
  const int warp = threadIdx.x / 32;
  if (warp % 4 == 0) return;
  const int nc = n - p1;
  const int nrq = (n + 3) / 4;
  const int ncq = (nc + 3) / 4;
  for (int t = 32 * (warp - warp / 4 - 1) + threadIdx.x % 32; t < nrq * ncq;
       t += kUpdateThreads) {
    const int rq = t / ncq;
    const int cq = t - rq * ncq;
    float* ar[4];
    const float* bc[4];
    bool ra[4], cb[4];
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      ra[a] = rq + nrq * a < n;
      cb[a] = cq + ncq * a < nc;
      ar[a] = w + (p1 + rq + nrq * a) * ld;
      bc[a] = w + (p1 + cq + ncq * a) * ld;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc[a][b] = ra[a] && cb[b] ? ar[a][p1 + cq + ncq * b] : 0.0f;
      }
    }
#pragma unroll 2
    for (int j = p0; j < p0 + kPanel; j += 4) {
      float4 av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        av[a] = ra[a] ? *reinterpret_cast<const float4*>(ar[a] + j) : z;
        bv[a] = cb[a] ? *reinterpret_cast<const float4*>(bc[a] + j) : z;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] = fmaf(-av[a].x, bv[b].x, acc[a][b]);
          acc[a][b] = fmaf(-av[a].y, bv[b].y, acc[a][b]);
          acc[a][b] = fmaf(-av[a].z, bv[b].z, acc[a][b]);
          acc[a][b] = fmaf(-av[a].w, bv[b].w, acc[a][b]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const bool tile_row = rq + nrq * a < pw2;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (ra[a] && cb[b] && !(tile_row && cq + ncq * b < pw2)) {
          ar[a][p1 + cq + ncq * b] = acc[a][b];
        }
      }
    }
  }
}

#ifdef HYPERBO_K1_LAPS
// Probe build (tools/probe_batch_chol.py): thread 0 of each block stamps
// clock64() after the load, the symmetrization, the first factor, each
// panel's solve and update, and the store.
constexpr int kLapSlots = 16;
__device__ long long* g_laps;
#define K1_LAP(slot) \
  if (threadIdx.x == 0) g_laps[blockIdx.x * kLapSlots + (slot)] = clock64()
#else
#define K1_LAP(slot)
#endif

// Copies from device to shared memory that no register waits on.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
linv_t_blocked(const float* __restrict__ kb, float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float smem[];
  float* lt = smem;                      // (32, 32): the tile's columns
  float* rpv = lt + kPanel * kPanel;     // (32,): the tile's rsqrt pivots
  float* w = rpv + kPanel;               // (2n, ld): [K; I]
  const int ld = row_stride(n);
  const long long task = blockIdx.x;
  const float* k = kb + task * n * n;
  float* b = out + task * n * n;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  constexpr int kWarps = kThreads / 32;
  // Rows of K and B as float4s where every row starts 16-byte aligned.
  const bool vec_in =
      n % 4 == 0 && reinterpret_cast<std::uintptr_t>(kb) % 16 == 0;
  const bool vec_out =
      n % 4 == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  K1_LAP(0);

  // K into the top half as it lies, a warp a row (every copy in flight at
  // once), and I into the bottom half meanwhile; then the top half's
  // lower triangle becomes 0.5 (K + K^T) in place. Nothing reads the
  // upper triangle's values into a result: a row's steps reach its
  // columns past the diagonal only after the row is done.
  for (int r = warp; r < n; r += kWarps) {
    if (vec_in) {
      for (int c = 4 * lane; c < n; c += 128) {
        cp_async16(w + r * ld + c, k + r * n + c);
      }
    } else {
      for (int c = lane; c < n; c += 32) {
        cp_async4(w + r * ld + c, k + r * n + c);
      }
    }
    for (int c = 4 * lane; c < ld; c += 128) {
      *reinterpret_cast<float4*>(w + (n + r) * ld + c) =
          make_float4(r == c, r == c + 1, r == c + 2, r == c + 3);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  K1_LAP(1);
  for (int r = warp; r < n; r += kWarps) {
    for (int c = lane; c < r; c += 32) {
      w[r * ld + c] = 0.5f * (w[r * ld + c] + w[c * ld + r]);
    }
  }
  __syncthreads();
  K1_LAP(2);

  float d[kPanel] = {};  // warp 0: the diagonal tile it factors
  if (warp == 0) {
    if (lane < min(kPanel, n)) load_row(d, w + lane * ld);
    factor_tile(d, min(kPanel, n), lt, rpv);
  }
  __syncthreads();
  K1_LAP(3);
  for (int p0 = 0; p0 < n; p0 += kPanel) {
    const int p1 = min(p0 + kPanel, n);
    if (tid < n) solve_row(w + (p1 + tid) * ld + p0, p1 - p0, lt, rpv);
    __syncthreads();
    K1_LAP(4 + 2 * (p0 / kPanel));
    if (p1 < n) {  // then this panel is kPanel wide
      const int pw2 = min(kPanel, n - p1);
      if (warp == 0) {
        update_tile(d, w, ld, p0, p1, pw2);
        factor_tile(d, pw2, lt, rpv);
      } else {
        update_trailing(w, ld, n, p0, p1, pw2);
      }
      __syncthreads();
    }
    K1_LAP(5 + 2 * (p0 / kPanel));
  }

  for (int r = warp; r < n; r += kWarps) {
    const float* src = w + (n + r) * ld;
    if (vec_out) {
      for (int c = 4 * lane; c < n; c += 128) {
        *reinterpret_cast<float4*>(b + r * n + c) =
            *reinterpret_cast<const float4*>(src + c);
      }
    } else {
      for (int c = lane; c < n; c += 32) b[r * n + c] = src[c];
    }
  }
  K1_LAP(kLapSlots - 1);
}

// lt, rpv, W, and a panel's width past W's end: the 32-float row reads of
// phases 1 and 2 may run past the last column of the last row.
size_t smem_bytes(int n) {
  return sizeof(float) * (kPanel * kPanel + kPanel +
                          static_cast<size_t>(2 * n) * row_stride(n) + kPanel);
}

// The kernel's dynamic shared-memory cap, raised once per device.
std::atomic<bool> g_smem_set[kMaxDevices];

cudaError_t ensure_smem_attribute() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && g_smem_set[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(linv_t_blocked,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxN)));
  if (err == cudaSuccess && dev < kMaxDevices) g_smem_set[dev].store(true);
  return err;
}

}  // namespace

// B = L^{-T} of 0.5 (K + K^T) for t positive definite n x n float32
// matrices K. kb and out are device pointers to (t, n, n) contiguous
// arrays; stream is a cudaStream_t. Returns 0 on success, else the
// cudaError_t of the launch (an n outside [1, 128] returns
// cudaErrorInvalidValue without launching).
extern "C" int hyperbo_batched_linv_t(const float* kb, float* out, int t,
                                      int n, void* stream) {
  if (n < 1 || n > kMaxN || t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = ensure_smem_attribute();
  if (err != cudaSuccess) return static_cast<int>(err);
  linv_t_blocked<<<t, kThreads, smem_bytes(n),
                   static_cast<cudaStream_t>(stream)>>>(kb, out, n);
  return static_cast<int>(cudaGetLastError());
}

#ifdef HYPERBO_K1_LAPS
// Where the probe build stamps its laps: (t, kLapSlots) int64 on the card.
extern "C" int hyperbo_batched_linv_t_laps(long long* laps) {
  return static_cast<int>(cudaMemcpyToSymbol(g_laps, &laps, sizeof(laps)));
}
#endif
