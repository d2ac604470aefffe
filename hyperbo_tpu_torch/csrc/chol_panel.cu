// Batched Cholesky of small SPD matrices (n <= 512) on Hopper, one block a
// matrix (kernel K7).
//
// Replaces the Pallas kernels of hyperbo_tpu/ops/pallas_chol.py:
// cholesky_panel (its pallas_call at :121, an outer-product sweep of the
// whole matrix held in VMEM) and cholesky_panel_blocked (:109, the
// left-looking blocked sweep). Both first symmetrize the input as
// 0.5 (A + A^T); so does this kernel.
//
// A 512 x 512 float32 matrix is 1 MiB, beyond the 227 KB of shared memory a
// block may use, so the kernel takes cholesky_panel_blocked's left-looking
// form with 64-wide column panels. For panel c0 .. c0 + w - 1 (w <= 64):
//   load      P = 0.5 (A + A^T)[c0:n, c0:c0+w] into shared memory
//             (n x 64 floats, 130 KB at n = 512);
//   correct   P -= L[c0:n, 0:c0] L[c0:c0+w, 0:c0]^T, with the finished
//             columns read back from the output in device memory (they
//             stay in L2), 64 rows x 32 columns of both at a time;
//   sweep     for each column j of the panel: the pivot, the scaled
//             column, and the rank-1 update of the panel's later columns
//             (two barriers a column);
//   store     the panel's columns of L, zeros above the diagonal.
//
// No pivot clamp: the square root and reciprocal square root of a
// non-positive pivot give NaN (or inf, then NaN), so a matrix that is not
// positive definite comes out non-finite; the wrapper (ops/chol_panel.py)
// makes that matrix's whole factor NaN.
//
// What bounds it on an H100. n^3/3 operations a matrix (4.5e7 at n = 512,
// 0.7 us of the card's 67 TFLOP/s) and 8 n^2 bytes in and out (2 MB,
// 0.6 us): neither. The sweep's chain of n columns, each two block-wide
// barriers with O(n) work a thread between them, on one SM per matrix, sets
// the time; a batch of matrices fills up to one SM each.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 512;
constexpr int kW = 64;             // panel width
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPld = kW + 1;       // panel row stride: conflict-free columns
constexpr int kKc = 32;            // correction depth per staging
constexpr int kKld = kKc + 1;

size_t smem_bytes(int n) {
  return sizeof(float) *
         (static_cast<size_t>(n) * kPld + 2 * kW * kKld + kW);
}

__global__ void __launch_bounds__(kThreads)
panel_cholesky(const float* __restrict__ a_all, float* __restrict__ l_all,
               int n) {
  extern __shared__ float smem[];
  float* pan = smem;                           // (n - c0, kPld)
  float* lr = pan + static_cast<size_t>(n) * kPld;   // (kW, kKld)
  float* lc = lr + kW * kKld;                  // (kW, kKld)
  float* ldiag = lc + kW * kKld;               // (kW,)
  const long long offset = static_cast<long long>(blockIdx.x) * n * n;
  const float* a = a_all + offset;
  float* l = l_all + offset;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int c0 = 0; c0 < n; c0 += kW) {
    const int w = min(kW, n - c0);
    const int nr = n - c0;                     // panel rows: c0 .. n - 1
    for (int idx = tid; idx < nr * kW; idx += kThreads) {
      const int i = idx / kW;
      const int j = idx % kW;
      float v = 0.0f;
      if (j < w) {
        const long long r = c0 + i;
        const long long c = c0 + j;
        v = 0.5f * (a[r * n + c] + a[c * n + r]);
      }
      pan[i * kPld + j] = v;
    }

    // P -= L[c0 + i, :c0] L[c0 + j, :c0]^T, one 64-row tile of P at a time;
    // thread (ty, tx) owns rows ty + 16 p and columns tx + 16 q.
    for (int i0 = 0; i0 < nr && c0 > 0; i0 += kW) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < c0; k0 += kKc) {
        __syncthreads();
        for (int idx = tid; idx < kW * kKc; idx += kThreads) {
          const int r = idx / kKc;
          const int kk = idx % kKc;
          const int k = k0 + kk;
          const bool kin = k < c0;
          lr[r * kKld + kk] =
              (kin && i0 + r < nr) ? l[(c0 + i0 + r) * static_cast<long long>(n) + k]
                                   : 0.0f;
          lc[r * kKld + kk] =
              (kin && r < w) ? l[(c0 + r) * static_cast<long long>(n) + k] : 0.0f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kKc; ++kk) {
          float u[4], v[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            u[p] = lr[(ty + 16 * p) * kKld + kk];
            v[p] = lc[(tx + 16 * p) * kKld + kk];
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(u[p], v[q], acc[p][q]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i = i0 + ty + 16 * p;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx + 16 * q;
          if (i < nr && j < w) pan[i * kPld + j] -= acc[p][q];
        }
      }
    }
    __syncthreads();

    // Column sweep of the panel. Column j: rows i > j take P_ij / sqrt(p),
    // the diagonal goes to ldiag (P_jj itself is not read again), then the
    // later columns c of the panel lose P_ic P_cj on rows i >= c.
    for (int j = 0; j < w; ++j) {
      const float p = pan[j * kPld + j];
      const float rp = rsqrtf(p);
      for (int i = j + 1 + tid; i < nr; i += kThreads) pan[i * kPld + j] *= rp;
      if (tid == 0) ldiag[j] = sqrtf(p);
      __syncthreads();
      for (int i = j + 1 + warp; i < nr; i += kWarps) {
        const float ci = pan[i * kPld + j];
        const int cend = min(w - 1, i);
        for (int c = j + 1 + lane; c <= cend; c += 32) {
          pan[i * kPld + c] -= ci * pan[c * kPld + j];
        }
      }
      __syncthreads();
    }

    // Columns c0 .. c0 + w - 1 of L: zeros above the diagonal.
    for (int idx = tid; idx < n * w; idx += kThreads) {
      const int r = idx / w;
      const int j = idx % w;
      const int i = r - c0;
      float v = 0.0f;
      if (i > j) v = pan[i * kPld + j];
      else if (i == j) v = ldiag[j];
      l[static_cast<long long>(r) * n + c0 + j] = v;
    }
    // The next panel's correction reads these columns back.
    __syncthreads();
  }
}

}  // namespace

// a, l: (batch, n, n) float32 device pointers, contiguous; l gets the lower
// factor of each 0.5 (A + A^T). stream: a cudaStream_t. Returns 0 or the
// cudaError_t of the launch (cudaErrorInvalidValue, without launching, for
// an n outside [1, 512] or an empty batch).
extern "C" int hyperbo_chol_panel(const float* a, float* l, int n, int batch,
                                  void* stream) {
  if (n < 1 || n > kMaxN || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      panel_cholesky, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  panel_cholesky<<<batch, kThreads, smem_bytes(n),
                   static_cast<cudaStream_t>(stream)>>>(a, l, n);
  return static_cast<int>(cudaGetLastError());
}
