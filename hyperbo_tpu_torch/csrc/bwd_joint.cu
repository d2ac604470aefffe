// Joint fused-NLL backward on Hopper (kernel K8): every adjoint of the fused
// NLL from the factor L, in one launch.
//
// Replaces the Pallas kernel of hyperbo_tpu/ops/pallas_bwd_joint.py,
// mll_bwd_joint (pallas_call at :272). It computes what K3 (tri_inv.cu),
// alpha = T^T (T delta) and K4 (mll_bwd.cu) compute one after another:
//
//   T = L^{-1},  u = T delta,  alpha = T^T u = K^{-1} delta,
//   P = [W x | W 1],  d_sv_raw = sum G o Kf,  d_da = tr G
//
// (G, W and Kf as in mll_bwd.cu). The caller forms d_x = 2 (Wx - (W1) o x).
//
// One persistent cooperative grid (cudaLaunchCooperativeKernel, two blocks
// a multiprocessor) runs its phases one after another, separated by
// grid-wide barriers; blocks loop over each phase's items:
//
//   1. level 0 of K3's recursive block inverse: T_jj = D_j and zeros above
//      the diagonal tiles, a float4 an item (tri_inv_core.cuh);
//   2. K3's levels 1 .. ceil(log2 nb), each two phases: the block tiles of
//      W = L[C, A] T_A for every merge of the level, then those of
//      T[C, A] = -T_C W. The same bodies, tile shapes and k ranges as K3's
//      launches, so T is bitwise K3's;
//   3. u = T delta: a warp a row over T's lower half, lanes' sums added in
//      a fixed order;
//   4. alpha_c = sum_{r >= c} T_rc u_r, one 32-column slab an item, reading
//      only the nonzero half of T;
//   5. the SYRK consumption on 64 x 64 tile pairs (bwd_core.cuh syrk_pair),
//      alpha from phase 4's buffer, into per-pair partials of P, d_sv and
//      d_da;
//   6. the fixed-order reductions of those partials.
//
// In phases 2 and 5 a block that finishes an item takes the next from a
// counter (for_each_item), heaviest first, as the hardware hands out the
// blocks of K3's and K4's launches; a level's tiles go heaviest first
// across all its merges. Which block runs an item changes nothing in its
// arithmetic.
//
// Every load of data that an earlier phase of the launch wrote goes
// through L2 (cp.async.cg in the products, __ldcg elsewhere), never through
// the non-coherent L1 path. What the TPU kernel's design was for does not
// carry over: the lane-127 packing of delta and u, the MXU
// transpose-by-ones, the panel-major layout and the tile knobs. L and T use
// the dense row-major (n, n) layout of tile_common.cuh, with 64-bit offsets
// and no limit on n. The result is deterministic (no float atomics, fixed
// summation orders), and a NaN anywhere in L reaches T, then u and alpha,
// then every output.
//
// What bounds it on an H100: the n^3/6 FP32 FMAs of K3's levels and the
// n^3/6 of K4's SYRK (n^3 * 2/3 float32 operations, 5.5 ms at n = 8192 at
// 67 TFLOP/s). One launch saves the host K3's 2 ceil(log2 nb) + 1
// launches, K4's two and alpha's two matrix-vector passes over all of T;
// the two chains stay. One kernel takes the registers of its largest
// phase: unbounded, the 128 x 128 products held it at 215 registers and one
// block a multiprocessor, where the SYRK pairs ran 1.5x slower than in a
// launch of their own, which fit two. __launch_bounds__(kThreads, 2) caps
// it at 128 registers (a few spills, in the products' copy addressing) for
// two blocks a multiprocessor (tools/probe_bwd_joint.py; PERF.md).
//
// Built with -DHYPERBO_JOINT_LAPS (tools/probe_bwd_joint.py), thread 0 of
// each block also stamps clock64() at the end of each phase's work and
// after each barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bwd_core.cuh"
#include "tile_common.cuh"
#include "tri_inv_core.cuh"

namespace {

using namespace hyperbo;
namespace cg = cooperative_groups;

// Shared floats of the largest work item: a 128 x 128 product or a pair.
constexpr int kJointSmem = gemm_smem_floats<128, 128>() > kPairSmem
                               ? gemm_smem_floats<128, 128>()
                               : kPairSmem;
// Work counters: two for each level (at most 31 levels for an int n), the
// last for the SYRK pairs.
constexpr int kCounters = 64;

#ifdef HYPERBO_JOINT_LAPS
constexpr int kLapSlots = 64;
__device__ long long* g_laps;

// Lap k of this block; the last slot holds the block's multiprocessor.
__device__ __forceinline__ void lap(int* k) {
  __syncthreads();
  long long* laps = g_laps + static_cast<long long>(blockIdx.x) * kLapSlots;
  if (threadIdx.x == 0 && *k < kLapSlots - 1) laps[*k] = clock64();
  if (threadIdx.x == 0 && *k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    laps[kLapSlots - 1] = sm;
  }
  ++*k;
}
#else
__device__ __forceinline__ void lap(int*) {}
#endif

// Runs body(item) for items 0 .. items - 1 of one phase across the grid.
// Block b takes item b first; then each block takes its next item from
// *counter when it finishes one, so items given heaviest first end
// together, as the blocks of a launch do. The next ticket is fetched while
// the block works. *slot is one shared word.
template <class Body>
__device__ __forceinline__ void for_each_item(unsigned* counter,
                                              unsigned items,
                                              unsigned* slot, Body body) {
  const bool lead = threadIdx.x == 0;
  unsigned item = blockIdx.x;
  while (item < items) {
    unsigned next = 0;
    if (lead) next = gridDim.x + atomicAdd(counter, 1u);
    body(item);
    __syncthreads();  // every thread has read *slot
    if (lead) *slot = next;
    __syncthreads();
    item = *slot;
  }
}

// One level of K3 (halves of `half` tiles): its W tiles, heaviest first
// across the level's merges (by column tile, which sets W's k range, then
// merge, then row tile), a barrier, its T tiles (by row tile from the
// last, which sets T_C W's k range, then merge, then column tile), a
// barrier.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void joint_level(cg::grid_group& grid,
                                            const float* __restrict__ l,
                                            float* t, float* w, int n,
                                            int half, unsigned* counters,
                                            float* smem, unsigned* slot,
                                            int* laps) {
  const LevelShape s = level_shape<BM, BN>(n / kTile, half);
  const unsigned rows = s.rows;
  const unsigned cols = s.cols;
  const unsigned merges = s.merges;
  const unsigned items = rows * cols * merges;
  for_each_item(counters, items, slot, [&](unsigned item) {
    level_w_tile<BM, BN, TM, TN>(l, t, w, n, half, item % rows,
                                 item / (rows * merges), item / rows % merges,
                                 smem);
  });
  lap(laps);
  grid.sync();
  lap(laps);
  for_each_item(counters + 1, items, slot, [&](unsigned item) {
    level_t_tile<BM, BN, TM, TN>(w, t, n, half,
                                 rows - 1 - item / (cols * merges),
                                 item % cols, item / cols % merges, smem);
  });
  lap(laps);
  grid.sync();
  lap(laps);
}

__global__ void __launch_bounds__(kThreads, 2)
bwd_joint(const float* __restrict__ l, const float* __restrict__ dinv,
          const float* __restrict__ x, const float* __restrict__ delta,
          const float* __restrict__ valid, const float* __restrict__ sv,
          int n, int d, int fam, float* t, float* w, float* u, float* alpha,
          float* p_part, double* s_part, unsigned* counters,
          float* __restrict__ p, float* __restrict__ out) {
  __shared__ __align__(16) float smem[kJointSmem];
  __shared__ double red[2 * kThreads];
  __shared__ unsigned slot;
  cg::grid_group grid = cg::this_grid();
  const int nb = n / kTile;
  const int tid = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + tid;
  int laps = 0;
  lap(&laps);

  if (blockIdx.x == 0 && tid < kCounters) counters[tid] = 0;
  const long long quads = static_cast<long long>(n) * (n / 4);
  for (long long q = first; q < quads; q += stride) {
    level_diag_quad(dinv, t, n, q);
  }
  lap(&laps);
  grid.sync();
  lap(&laps);
  unsigned* level_counters = counters;
  for (int half = 1; half < nb; half *= 2, level_counters += 2) {
    if (half >= kBigHalf) {
      joint_level<128, 128, 8, 8>(grid, l, t, w, n, half, level_counters,
                                  smem, &slot, &laps);
    } else {
      joint_level<64, 64, 4, 4>(grid, l, t, w, n, half, level_counters, smem,
                                &slot, &laps);
    }
  }

  // u_r = sum_{c <= r} T_rc delta_c, through row r's diagonal tile: a warp
  // a row, lane k summing the float4s k, k + 32, ... in order, then a fixed
  // butterfly over the lanes.
  const int lane = tid % 32;
  const long long warps = stride / 32;
  for (long long r = first / 32; r < n; r += warps) {
    const long long width = (r / kTile + 1) * kTile;
    const float* row = t + r * n;
    float s = 0.0f;
    for (long long c = 4 * lane; c < width; c += 128) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(row + c));
      s = fmaf(v.x, delta[c], s);
      s = fmaf(v.y, delta[c + 1], s);
      s = fmaf(v.z, delta[c + 2], s);
      s = fmaf(v.w, delta[c + 3], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if (lane == 0) u[r] = s;
  }
  lap(&laps);
  grid.sync();
  lap(&laps);

  // alpha over one 32-column slab: 8 row groups of 32 threads, each thread
  // one column; the groups' sums added in order.
  constexpr int kGroups = kThreads / kSlab;
  const unsigned slabs = nb * kSlabs;
  const int c = tid % kSlab;
  const int g = tid / kSlab;
  for (unsigned item = blockIdx.x; item < slabs; item += gridDim.x) {
    const long long col0 = static_cast<long long>(item) * kSlab;
    const long long top = static_cast<long long>(item / kSlabs) * kTile;
    float acc = 0.0f;
    for (long long r = top + g; r < n; r += kGroups) {
      acc = fmaf(__ldcg(t + r * n + col0 + c), __ldcg(u + r), acc);
    }
    __syncthreads();  // the previous item's reads of smem are done
    smem[g * kSlab + c] = acc;
    __syncthreads();
    if (g == 0) {
      float s = 0.0f;
      for (int k = 0; k < kGroups; ++k) s += smem[k * kSlab + c];
      alpha[col0 + c] = s;
    }
  }
  lap(&laps);
  grid.sync();
  lap(&laps);

  const long long pairs = static_cast<long long>(nb) * (nb + 1) / 2;
  for_each_item(counters + kCounters - 1, static_cast<unsigned>(pairs),
                &slot, [&](unsigned pair) {
                  syrk_pair<true>(t, x, alpha, valid, sv, n, d, fam, pair,
                                  smem, red, p_part, s_part);
                });
  lap(&laps);
  grid.sync();
  lap(&laps);

  const long long total = static_cast<long long>(n) * (d + 1);
  for (long long idx = first; idx < total; idx += stride) {
    reduce_p_entry<true>(p_part, n, d, idx, p);
  }
  if (blockIdx.x == gridDim.x - 1) {
    reduce_scalars<true>(s_part, pairs, out, red);
  }
  lap(&laps);
}

// The cooperative grid: blocks a multiprocessor at once (occupancy), the
// multiprocessors, and their product.
cudaError_t joint_grid(int* per_sm, int* sms, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, bwd_joint,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = *per_sm * *sms;
  return cudaSuccess;
}

}  // namespace

// l: (n, n) lower-triangular factor; dinv: (n/64, 64, 64) inverses of its
// diagonal tiles; x: (n, d) scaled inputs; delta: (n,); valid: (n,) 0/1
// mask or null; sv: one float; fam: 0 SE, 1 Matern-3/2, 2 Matern-5/2.
// Scratch: t (n, n), w (ops/tri_inv.scratch_floats(n) floats, at most
// n^2/4), u (n,), p_part (n/64, n/64, 64, d + 1), s_part (2 n/64 (n/64 + 1)
// / 2,) float64, counters (64,) unsigned (zeroed by the kernel). Outputs:
// alpha (n,), p (n, d + 1), out (2,) = (d_sv_raw, d_da). Device pointers,
// float32 unless stated, t and w 16-byte aligned; stream: a cudaStream_t;
// the current device is the tensors'. n must be a positive multiple of 64.
// Returns 0 or the cudaError_t of the first failed call
// (cudaErrorInvalidValue, without launching, for arguments it does not
// take; cudaErrorNotSupported where the device cannot launch a cooperative
// grid).
extern "C" int hyperbo_mll_bwd_joint(const float* l, const float* dinv,
                                     const float* x, const float* delta,
                                     const float* valid, const float* sv,
                                     int n, int d, int fam, float* t,
                                     float* w, float* u, float* alpha,
                                     float* p_part, double* s_part,
                                     unsigned* counters, float* p,
                                     float* out, void* stream) {
  if (n < kTile || n % kTile != 0 || d < 1 || fam < kSe || fam > kMatern52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int per_sm = 0, sms = 0, blocks = 0;
  err = joint_grid(&per_sm, &sms, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&l,     &dinv,   &x,      &delta,    &valid, &sv, &n,
                  &d,     &fam,    &t,      &w,        &u,     &alpha,
                  &p_part, &s_part, &counters, &p,     &out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bwd_joint),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// info[0 .. 5]: the grid's blocks, blocks a multiprocessor, multiprocessors,
// registers a thread, bytes of local memory a thread (spills) and of static
// shared memory a block. For tools/probe_bwd_joint.py.
extern "C" int hyperbo_mll_bwd_joint_info(int* info) {
  cudaError_t err = joint_grid(&info[1], &info[2], &info[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, bwd_joint);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[3] = attr.numRegs;
  info[4] = static_cast<int>(attr.localSizeBytes);
  info[5] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

#ifdef HYPERBO_JOINT_LAPS
// Where the next launches write their laps: (grid blocks, 64) int64.
extern "C" int hyperbo_mll_bwd_joint_laps(long long* laps) {
  return static_cast<int>(cudaMemcpyToSymbol(g_laps, &laps, sizeof(laps)));
}
#endif
