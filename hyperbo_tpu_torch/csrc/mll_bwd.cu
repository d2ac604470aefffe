// Fused NLL backward on Hopper (kernel K4): the adjoints of the fused NLL
// from T = L^{-1}, with K^{-1}, G and W never written to device memory.
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_mll_bwd.py,
// mll_bwd_fused (pallas_calls at :417 and :459). With alpha = K^{-1} delta
// and r2 the squared distances of the scaled inputs x (n, d):
//
//   K^{-1} = T^T T,  G = (K^{-1} - alpha alpha^T) / 2,  W = G o N(r2)
//   P = [W x | W 1]          (n, d + 1)
//   d_sv_raw = sum G o Kf    (Kf = sv k(r2), without the diagonal add)
//   d_da = tr G
//
// (N and Kf per family: tile_common.cuh km_nm; with a valid mask both are
// multiplied by valid_i valid_j.) The caller forms d_x = 2 (Wx - (W1) o x)
// and d_sv = d_sv_raw / sv.
//
// What bounds it on an H100. The SYRK: n^3/6 FP32 FMAs (9.2e10 at
// n = 8192, 2.7 ms at the data sheet's 67 TFLOP/s, 3.5 ms at the ~52
// TFLOP/s a float32 matmul reaches on the card). The epilogue is
// O(128 (128 + d)) a pair and the bytes are T's lower half once (0.13 GB).
// So it is the FMA rate, and the design is about feeding it: 8 x 8 outputs
// a thread read 16 shared floats for 64 FMA (a 64 x 64 tile with 4 x 4 a
// thread read 8 for 16, which held the SIMT cores to half their rate), and
// the copies of later chunks overlap the products of this one.
//
// Design: two launches.
//   pairs   one block (256 threads, two a multiprocessor) per lower pair
//           (I, J), J <= I, of 128-wide tiles (the last 64 wide where n / 64
//           is odd): syrk128_core.cuh pair_block. The SYRK reads T's rows
//           k >= 128 I of tiles I and J, k-major as they lie in T, through a
//           four-stage cp.async ring of 16-row chunks, 8 x 8 outputs a
//           thread from float4 shared reads, the chunk loop fully unrolled
//           (127 registers, no spills; unrolled 8 deep, a throwaway build
//           spilled and ran slower); then r2, G, W, the P partials and the
//           float64 scalar partials of the pair.
//   reduce  P's entries from the partials, each a sum over the other tile
//           in ascending order, and one last block for (d_sv_raw, d_da)
//           from the pairs' scalar partials in a fixed order
//           (bwd_core.cuh reduce_scalars).
// Order and balance: pair (I, J) costs n - 128 I rows of T, and the grid
// takes the pairs in decode_pair's order, I ascending: heaviest first. The
// hardware hands a freed slot the next block in that order, which is the
// greedy longest-first list a persistent launch would walk (at n = 8192,
// 2,080 pairs over 264 slots, the last ones a 128-row product each), and
// the other block of the multiprocessor runs its SYRK while one block is in
// its epilogue. So a plain grid: tools/probe_mll_bwd.py finds the blocks
// busy 99.3% of the slots' time over the launch's span, which leaves a
// persistent launch (a task list, its own prefetch across pairs) nothing
// to win in balance.
//
// Deterministic, no atomics: each entry of K^{-1} is one sum in ascending k
// by one thread; every pair writes its own slots of the partials,
// p_part[(row tile, other tile)] and s_part[2 pair ..], each written
// exactly once; the reduction sums them in a fixed order. Two calls are
// bitwise equal. No limit on n: offsets are 64-bit and the partials live in
// device memory (ns^2 128 (d + 1) floats, ns = ceil(n / 128): 19 MB at
// n = 8192, d = 8).
//
// Built with -DHYPERBO_BWD_LAPS (tools/probe_mll_bwd.py), thread 0 of each
// block stamps its start and end, its multiprocessor and the cycles of its
// parts (syrk128_core.cuh Slot) into the array hyperbo_mll_bwd_laps names.

#include <cuda_runtime.h>

#include <atomic>

#include "bwd_core.cuh"
#include "syrk128_core.cuh"
#include "tile_common.cuh"

namespace {

using namespace hyperbo;
using syrk128::kSmemBytes;

constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads, 2)
bwd_pairs(const float* __restrict__ t, const float* __restrict__ x,
          const float* __restrict__ alpha, const float* __restrict__ valid,
          const float* __restrict__ sv_ptr, int n, int d, int fam,
          float* __restrict__ p_part, double* __restrict__ s_part) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[2 * syrk128::kWarps];
  syrk128::pair_block(t, x, alpha, valid, sv_ptr, n, d, fam, blockIdx.x,
                      smem, red, p_part, s_part);
}

// Blocks 0 .. gridDim.x - 2 take P's entries, the last block the scalars;
// in the laps build each writes its start and end at row `pairs` + block.
__global__ void __launch_bounds__(kThreads)
bwd_reduce(const float* __restrict__ p_part,
           const double* __restrict__ s_part, int n, int d, long long pairs,
           float* __restrict__ p, float* __restrict__ out) {
  __shared__ double red[2 * kThreads];
  const long long row = pairs + blockIdx.x;
  syrk128::lap(row, syrk128::kSlotStart, syrk128::global_ns());
  if (blockIdx.x + 1 == gridDim.x) {
    reduce_scalars<false>(s_part, pairs, out, red);
  } else {
    syrk128::reduce_p_entry(
        p_part, n, d,
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x, p);
  }
  syrk128::lap(row, syrk128::kSlotEnd, syrk128::global_ns());
}

std::atomic<bool> g_ready[kMaxDevices];

// Once a device: allow bwd_pairs its dynamic shared memory.
cudaError_t prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && g_ready[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(bwd_pairs,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess && cached) g_ready[dev].store(true);
  return err;
}

}  // namespace

// t: (n, n) T = L^{-1}, lower; x: (n, d) scaled inputs; alpha: (n,);
// valid: (n,) 0/1 mask or null; sv: one float; p_part: (ns, ns, 128,
// d + 1) scratch, ns = ceil(n / 128); s_part: (ns (ns + 1),) float64
// scratch; p: (n, d + 1) output; out: (2,) = (d_sv_raw, d_da). Device
// pointers, float32 unless stated; fam: 0 SE, 1 Matern-3/2, 2 Matern-5/2;
// stream: a cudaStream_t. n must be a positive multiple of 64. Returns 0 or
// the cudaError_t of the first failed call (cudaErrorInvalidValue, without
// launching, for arguments it does not take).
extern "C" int hyperbo_mll_bwd(const float* t, const float* x,
                               const float* alpha, const float* valid,
                               const float* sv, int n, int d, int fam,
                               float* p_part, double* s_part, float* p,
                               float* out, void* stream) {
  if (n < kTile || n % kTile != 0 || d < 1 || fam < kSe || fam > kMatern52) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ns = (n + syrk128::kW - 1) / syrk128::kW;
  const long long pairs = ns * (ns + 1) / 2;
  bwd_pairs<<<static_cast<unsigned>(pairs), kThreads, kSmemBytes, s>>>(
      t, x, alpha, valid, sv, n, d, fam, p_part, s_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(n) * (d + 1);
  bwd_reduce<<<static_cast<unsigned>((total + kThreads - 1) / kThreads + 1),
               kThreads, 0, s>>>(p_part, s_part, n, d, pairs, p, out);
  return static_cast<int>(cudaGetLastError());
}

// info[0..3] = blocks of bwd_pairs a multiprocessor, multiprocessors,
// dynamic shared memory bytes a block, threads a block, on the current
// device. Returns 0 or a cudaError_t.
extern "C" int hyperbo_mll_bwd_info(int* info) {
  cudaError_t err = prepare();
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[0], bwd_pairs, kThreads, kSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&info[1], cudaDevAttrMultiProcessorCount,
                                 dev);
  }
  info[2] = kSmemBytes;
  info[3] = kThreads;
  return static_cast<int>(err);
}

#ifdef HYPERBO_BWD_LAPS
// Where the next launches write their laps: (pairs + reduce blocks,
// syrk128::kLapSlots) int64, a row a block (syrk128_core.cuh Slot).
extern "C" int hyperbo_mll_bwd_laps(long long* laps) {
  return static_cast<int>(
      cudaMemcpyToSymbol(syrk128::g_laps, &laps, sizeof(laps)));
}
#endif
