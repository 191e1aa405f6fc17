// SpTRSV level kernel for Hopper (sm_90a): one wavefront of the
// level-scheduled solve over an ELL slab in the permuted packed layout.
//
// Replaces the TPU kernels `level_kernel` / `level_solve_blocks` and
// `level_kernel_batched` / `level_solve_blocks_batched` of the JAX package
// (src/repro/kernels/sptrsv_level/lowering_tpu.py).  Per wavefront with
// write offset o, ELL width K and padded row count Rp:
//
//     x[o + r, j] = (bhat[o + r, j] - sum_k vals[k, r] * x[cols[k, r], j]) / diag[r]
//
// for r < Rp and every RHS column j < m.  Design:
//   * one thread per (row, RHS column); the m columns of a row sit on
//     neighbouring threads, so each gathered x row is read coalesced;
//   * the kernel reads bhat and writes x in place at the wavefront's
//     offset (the TPU kernel returned the slab and XLA stored it); a
//     wavefront reads only positions < o, which earlier launches wrote;
//   * the K loop runs in the TPU kernel's order (acc -= v * x, then one
//     divide); nvcc contracts it to FMA, so bits may differ from the plain
//     torch version by rounding;
//   * ELL pad entries (val 0) point at a real position.  A read at a
//     position >= o can only be such a pad, and it may race with this
//     launch's own writes, so it is skipped: where the plain version adds
//     0 * (old value), the kernel adds nothing.  The two differ only when
//     that old value is non-finite (see ROADMAP C-ref 2).
//
// A coarsened chain runs as `depth` launches, one per sub-step; the host
// walk below issues every launch of a solve from one call.
//
// Bound: each wavefront moves a few KB (nnz ~ 4.3 per row), so a launch is
// bound by launch latency and by the dependent load chain cols -> x, not
// by bytes or FLOPs.  A whole solve of lung2 (493 wavefronts) is launch
// bound; its byte bound is a few microseconds.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
level_kernel(T* __restrict__ x, const T* __restrict__ bhat,
             const int* __restrict__ cols, const T* __restrict__ vals,
             const T* __restrict__ diag, long long o, int K, int Rp, int m,
             long long ldx, long long ldb) {
  const int mm = kBatched ? m : 1;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(Rp) * mm) return;
  const int r = static_cast<int>(t / mm);
  const int j = static_cast<int>(t - static_cast<long long>(r) * mm);
  T acc = bhat[(o + r) * ldb + j];
  for (int k = 0; k < K; ++k) {
    const long long e = static_cast<long long>(k) * Rp + r;
    const long long c = cols[e];
    if (c < o) acc -= vals[e] * x[c * ldx + j];
  }
  x[(o + r) * ldx + j] = acc / diag[r];
}

// `steps` is a host array of (o, K, Rp, val_off, diag_off) per launch;
// val_off indexes both cols and vals, diag_off indexes diag.
template <typename T, bool kBatched>
int level_walk(T* x, const T* bhat, const int* cols, const T* vals,
               const T* diag, const long long* steps, int nsteps, int m,
               long long ldx, long long ldb, cudaStream_t stream) {
  for (int i = 0; i < nsteps; ++i) {
    const long long* s = steps + 5 * static_cast<long long>(i);
    const int K = static_cast<int>(s[1]);
    const int Rp = static_cast<int>(s[2]);
    const long long total = static_cast<long long>(Rp) * (kBatched ? m : 1);
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    level_kernel<T, kBatched><<<blocks, kThreads, 0, stream>>>(
        x, bhat, cols + s[3], vals + s[3], diag + s[4], s[0], K, Rp, m, ldx, ldb);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int level_walk_any(T* x, const T* bhat, const int* cols, const T* vals,
                   const T* diag, const long long* steps, int nsteps,
                   int batched, int m, long long ldx, long long ldb,
                   cudaStream_t stream) {
  if (batched)
    return level_walk<T, true>(x, bhat, cols, vals, diag, steps, nsteps, m,
                               ldx, ldb, stream);
  return level_walk<T, false>(x, bhat, cols, vals, diag, steps, nsteps, 1,
                              ldx, ldb, stream);
}

}  // namespace

extern "C" int sptrsv_level_walk_f32(float* x, const float* bhat,
                                     const int* cols, const float* vals,
                                     const float* diag, const long long* steps,
                                     int nsteps, int batched, int m,
                                     long long ldx, long long ldb,
                                     cudaStream_t stream) {
  return level_walk_any<float>(x, bhat, cols, vals, diag, steps, nsteps,
                               batched, m, ldx, ldb, stream);
}

extern "C" int sptrsv_level_walk_f64(double* x, const double* bhat,
                                     const int* cols, const double* vals,
                                     const double* diag, const long long* steps,
                                     int nsteps, int batched, int m,
                                     long long ldx, long long ldb,
                                     cudaStream_t stream) {
  return level_walk_any<double>(x, bhat, cols, vals, diag, steps, nsteps,
                                batched, m, ldx, ldb, stream);
}
