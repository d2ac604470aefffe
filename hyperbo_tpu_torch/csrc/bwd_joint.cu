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
// One persistent cooperative grid (cudaLaunchCooperativeKernel, as many
// blocks as fit on the card at once) runs five phases separated by grid-wide
// barriers; blocks loop over each phase's work items:
//
//   1. T by K3's block forward substitution, one 32-column slab an item,
//      heaviest first (bwd_core.cuh tri_inv_slab). Each finished tile of T
//      also multiplies delta's slab, as on the TPU, where u = T delta rode
//      the sweep: the products go to a per-slab partial of u (n / 32 x n
//      floats, 8 MiB at n = 8192), not to float atomics;
//   2. u: each row's slab partials summed in a fixed order;
//   3. alpha_c = sum_{r >= c} T_rc u_r, one 32-column slab an item, reading
//      only the nonzero half of T;
//   4. K4's tile-pair SYRK consumption (bwd_core.cuh syrk_pair), alpha from
//      phase 3's buffer, into per-pair partials of P, d_sv and d_da;
//   5. K4's fixed-order reductions of those partials.
//
// What the TPU kernel's design was for does not carry over: the lane-127
// packing of delta and u, the MXU transpose-by-ones, the panel-major layout
// and the tile knobs. L and T use the dense row-major (n, n) layout of
// tile_common.cuh, with 64-bit offsets and no limit on n. The result is
// deterministic (no atomics, fixed summation orders), and a NaN anywhere in
// L reaches T, then u and alpha, then every output.
//
// What bounds it on an H100. The two n^3/6 chains of K3 and K4 are still
// there: phase 1 is panel 0's chain of (n/64)^2/2 dependent tile steps
// (K3's time) and phase 4 the SYRK's n^3/6 FP32 FMAs (K4's). One launch
// saves the host a few launches and alpha's two matrix-vector passes over
// all of T; it does not shorten either chain.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bwd_core.cuh"
#include "tile_common.cuh"

namespace {

using namespace hyperbo;
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(kThreads)
bwd_joint(const float* __restrict__ l, const float* __restrict__ dinv,
          const float* __restrict__ x, const float* __restrict__ delta,
          const float* __restrict__ valid, const float* __restrict__ sv,
          int n, int d, int fam, float* t, float* u_part, float* u,
          float* alpha, float* p_part, double* s_part,
          float* __restrict__ p, float* __restrict__ out) {
  __shared__ float smem[kPairSmem];
  __shared__ double red[2 * kThreads];
  cg::grid_group grid = cg::this_grid();
  const int nb = n / kTile;
  const unsigned slabs = nb * kSlabs;
  const int tid = threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + tid;

  for (unsigned item = blockIdx.x; item < slabs; item += gridDim.x) {
    tri_inv_slab<true>(l, dinv, t, n, item, smem, smem + kTile * kLd, delta,
                       u_part);
  }
  grid.sync();

  // u_r: the slabs of panels 0 .. r / 64 wrote row r.
  for (long long r = first; r < n; r += stride) {
    const long long rows_slabs = (r / kTile + 1) * kSlabs;
    float s = 0.0f;
    for (long long q = 0; q < rows_slabs; ++q) {
      s += __ldcg(u_part + q * n + r);
    }
    u[r] = s;
  }
  grid.sync();

  // alpha over one 32-column slab: 8 row groups of 32 threads, each thread
  // one column; the groups' sums added in order.
  constexpr int kGroups = kThreads / kSlab;
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
  grid.sync();

  const long long pairs = static_cast<long long>(nb) * (nb + 1) / 2;
  for (long long pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    syrk_pair<true>(t, x, alpha, valid, sv, n, d, fam, pair, smem, red,
                    p_part, s_part);
  }
  grid.sync();

  const long long total = static_cast<long long>(n) * (d + 1);
  for (long long idx = first; idx < total; idx += stride) {
    reduce_p_entry<true>(p_part, n, d, idx, p);
  }
  if (blockIdx.x == gridDim.x - 1) {
    reduce_scalars<true>(s_part, pairs, out, red);
  }
}

}  // namespace

// l: (n, n) lower-triangular factor; dinv: (n/64, 64, 64) inverses of its
// diagonal tiles; x: (n, d) scaled inputs; delta: (n,); valid: (n,) 0/1
// mask or null; sv: one float; fam: 0 SE, 1 Matern-3/2, 2 Matern-5/2.
// Scratch: t (n, n), u_part (n/32, n), u (n,), p_part (n/64, n/64, 64,
// d + 1), s_part (2 n/64 (n/64 + 1) / 2,) float64. Outputs: alpha (n,),
// p (n, d + 1), out (2,) = (d_sv_raw, d_da). Device pointers, float32 unless
// stated; stream: a cudaStream_t; the current device is the tensors'. n must
// be a positive multiple of 64. Returns 0 or the cudaError_t of the first
// failed call (cudaErrorInvalidValue, without launching, for arguments it
// does not take; cudaErrorNotSupported where the device cannot launch a
// cooperative grid).
extern "C" int hyperbo_mll_bwd_joint(const float* l, const float* dinv,
                                     const float* x, const float* delta,
                                     const float* valid, const float* sv,
                                     int n, int d, int fam, float* t,
                                     float* u_part, float* u, float* alpha,
                                     float* p_part, double* s_part, float* p,
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
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_joint,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&l,     &dinv,  &x,      &delta,  &valid, &sv,
                  &n,     &d,     &fam,    &t,      &u_part, &u,
                  &alpha, &p_part, &s_part, &p,     &out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bwd_joint),
                                    dim3(per_sm * sms), dim3(kThreads), args,
                                    0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
