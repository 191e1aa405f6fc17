// SpTRSV fused kernel for Hopper (sm_90a): the whole solve in one launch.
//
// Replaces the TPU kernels `fused_kernel` / `fused_solve` and
// `fused_kernel_batched` / `fused_solve_batched` of the JAX package
// (src/repro/kernels/sptrsv_fused/lowering_tpu.py).  On the TPU a
// sequential grid walks level-ordered chunks of C rows with x in VMEM.  A
// GPU grid gives no order between blocks, so this port runs ONE thread
// block that walks the layout's wavefront spans in order:
//
//     for each span (off, r_pad):            // one wavefront, chunk aligned
//         for p in [off, off + r_pad), j < m (threads stride over p, j):
//             x[p, j] = (bl[p, j] - sum_k vals[k, p] * x[cols[k, p], j]) / diag[p]
//         __syncthreads()
//
// `__syncthreads()` separates spans and makes the block's global writes
// visible to all of its threads, so x lives in global memory (L2 resident:
// 356,352 rows x 8 B = 2.9 MB at f64 for lung2) and the launch is a true
// single dispatch, as on the TPU.  Rows of one span are independent; a
// read at a position >= off can only be an ELL pad (val 0), which is
// skipped, as in the level kernel (ROADMAP C-ref 2).  Every position below
// off was written by an earlier span, so x needs no initialisation.
//
// Bound: one SM does all the work and every span costs a barrier plus a
// dependent cols -> x load chain from L2, so the solve is bound by span
// count x latency, far above its byte bound.  A multi-block design with
// per-span ready flags (Li, arXiv:1710.04985) is the planned redesign.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
fused_kernel(T* __restrict__ x, const T* __restrict__ bl,
             const int* __restrict__ cols, const T* __restrict__ vals,
             const T* __restrict__ diag, const int* __restrict__ spans,
             int nspans, int K, long long n_pad, int m, long long ldx,
             long long ldb) {
  const int mm = kBatched ? m : 1;
  for (int s = 0; s < nspans; ++s) {
    const long long off = spans[2 * s];
    const long long total = static_cast<long long>(spans[2 * s + 1]) * mm;
    for (long long t = threadIdx.x; t < total; t += blockDim.x) {
      const long long p = off + t / mm;
      const int j = static_cast<int>(t % mm);
      T acc = bl[p * ldb + j];
      for (int k = 0; k < K; ++k) {
        const long long e = static_cast<long long>(k) * n_pad + p;
        const long long c = cols[e];
        if (c < off) acc -= vals[e] * x[c * ldx + j];
      }
      x[p * ldx + j] = acc / diag[p];
    }
    __syncthreads();
  }
}

template <typename T>
int fused_launch(T* x, const T* bl, const int* cols, const T* vals,
                 const T* diag, const int* spans, int nspans, int K,
                 long long n_pad, int batched, int m, long long ldx,
                 long long ldb, cudaStream_t stream) {
  if (batched)
    fused_kernel<T, true><<<1, kThreads, 0, stream>>>(
        x, bl, cols, vals, diag, spans, nspans, K, n_pad, m, ldx, ldb);
  else
    fused_kernel<T, false><<<1, kThreads, 0, stream>>>(
        x, bl, cols, vals, diag, spans, nspans, K, n_pad, 1, ldx, ldb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sptrsv_fused_f32(float* x, const float* bl, const int* cols,
                                const float* vals, const float* diag,
                                const int* spans, int nspans, int K,
                                long long n_pad, int batched, int m,
                                long long ldx, long long ldb,
                                cudaStream_t stream) {
  return fused_launch<float>(x, bl, cols, vals, diag, spans, nspans, K, n_pad,
                             batched, m, ldx, ldb, stream);
}

extern "C" int sptrsv_fused_f64(double* x, const double* bl, const int* cols,
                                const double* vals, const double* diag,
                                const int* spans, int nspans, int K,
                                long long n_pad, int batched, int m,
                                long long ldx, long long ldb,
                                cudaStream_t stream) {
  return fused_launch<double>(x, bl, cols, vals, diag, spans, nspans, K,
                              n_pad, batched, m, ldx, ldb, stream);
}
