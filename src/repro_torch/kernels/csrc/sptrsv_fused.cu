// SpTRSV fused kernels for Hopper (sm_90a): the whole solve in one launch.
//
// Replace the TPU kernels `fused_kernel` / `fused_solve` and
// `fused_kernel_batched` / `fused_solve_batched` of the JAX package
// (src/repro/kernels/sptrsv_fused/lowering_tpu.py).  On the TPU a
// sequential grid walks level-ordered chunks of C rows with x in VMEM.  A
// GPU grid gives no order between blocks, so both kernels walk the layout's
// wavefront spans in order and separate them by a barrier:
//
//     for each span (off, r_pad):            // one wavefront, chunk aligned
//         for p in [off, off + r_pad), j < m:
//             x[p, j] = (bl[p, j] - sum_k vals[k, p] * x[cols[k, p], j]) / diag[p]
//         barrier
//
// x lives in global memory (L2 resident: 356,352 rows x 8 B = 2.9 MB at
// f64 for lung2) and the launch is a true single dispatch, as on the TPU.
// Rows of one span are independent; a read at a position >= off can only
// be an ELL pad (val 0), which is skipped, as in the level kernel (ROADMAP
// C-ref 2).  Every position below off was written by an earlier span, so
// x needs no initialisation.
//
// Single RHS (sptrsv_fused_*, batched = 0): ONE block of 1024 threads
// strides over each span's rows with `__syncthreads()` between spans.  On
// lung2 most spans hold 2 real rows, so a grid barrier per span would cost
// more than one SM's work; the kernel is bound by span count x the
// latency of a dependent cols -> x load chain from L2.
//
// Many RHS (batched = 1, x of shape (n_pad, m)): a persistent grid that
// fills every SM.  The host sizes it as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count and launches
// it with cudaLaunchCooperativeKernel, which guarantees that every block is
// resident (a spinning barrier in a plain launch can deadlock); a refused
// cooperative launch returns its error, and there is no fallback.  Within
// a span the r_pad x m items, column fastest, are spread over every thread
// of the grid: at m = 32 one warp takes one row, its lanes read that row's
// 32 RHS values coalesced and the row's cols / vals entries are one
// broadcast.  Spans are separated by the hand-written generation-counting
// grid barrier of grid_barrier.cuh, on one arrival counter in global
// scratch that the wrapper zeroes for every launch.
//
// The bug to expect: x is read after a barrier through L2
// (`__ldcg`, ld.global.cg), never through L1.  L1 is not coherent across
// SMs, and a line of x read in an earlier span may still hold positions
// that another SM wrote since; read through L1 it would be stale.
//
// Bound: bytes at best (each factor entry and b read once, x written once),
// but the spans are dependent, so both kernels pay span count x (barrier +
// dependent load latency); the grid kernel divides each wide level's work
// by the SM count, pays a grid barrier instead of a block barrier, and
// issues kUnroll of a row's entries at a time to shorten its load chain.
// Still open: per-row ready flags instead of barriers (Li,
// arXiv:1710.04985) and a per-span ELL width (ROADMAP B3/B4).
#include <cuda_runtime.h>

#include "grid_barrier.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;  // ELL entries of a row in flight (batched kernel)

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(T* __restrict__ x, const T* __restrict__ bl,
                   const int* __restrict__ cols, const T* __restrict__ vals,
                   const T* __restrict__ diag, const int* __restrict__ spans,
                   int nspans, int K, long long n_pad) {
  for (int s = 0; s < nspans; ++s) {
    const long long off = spans[2 * s];
    const long long r_pad = spans[2 * s + 1];
    for (long long t = threadIdx.x; t < r_pad; t += blockDim.x) {
      const long long p = off + t;
      T acc = bl[p];
      for (int k = 0; k < K; ++k) {
        const long long e = static_cast<long long>(k) * n_pad + p;
        const long long c = cols[e];
        if (c < off) acc -= vals[e] * x[c];
      }
      x[p] = acc / diag[p];
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_grid_kernel(T* __restrict__ x, const T* __restrict__ bl,
                  const int* __restrict__ cols, const T* __restrict__ vals,
                  const T* __restrict__ diag, const int* __restrict__ spans,
                  int nspans, int K, long long n_pad, int m, long long ldx,
                  long long ldb, unsigned* bar) {
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int s = 0; s < nspans; ++s) {
    const long long off = __ldg(spans + 2 * s);
    const long long total = static_cast<long long>(__ldg(spans + 2 * s + 1)) * m;
    for (long long t = first; t < total; t += stride) {
      const long long p = off + t / m;
      const int j = static_cast<int>(t % m);
      const T d = __ldg(diag + p);
      T acc = __ldg(bl + p * ldb + j);
      // kUnroll entries at a time: their index and value loads issue
      // together, then their x loads, so a row waits about 2 K / kUnroll
      // load latencies instead of 2 K; the sum keeps the order of k
      for (int k0 = 0; k0 < K; k0 += kUnroll) {
        long long c[kUnroll];
        T a[kUnroll], xv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long e = static_cast<long long>(k0 + u) * n_pad + p;
          c[u] = k0 + u < K ? __ldg(cols + e) : off;
          a[u] = k0 + u < K ? __ldg(vals + e) : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          xv[u] = c[u] < off ? __ldcg(x + c[u] * ldx + j) : T(0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (c[u] < off) acc -= a[u] * xv[u];
      }
      x[p * ldx + j] = acc / d;
    }
    if (s + 1 < nspans) grid_barrier(bar, (s + 1u) * gridDim.x);
  }
}

// Blocks of the batched grid: as many as can be resident at once.
template <typename T>
int grid_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_grid_kernel<T>, kThreads, 0);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

template <typename T>
int fused_launch(T* x, const T* bl, const int* cols, const T* vals,
                 const T* diag, const int* spans, int nspans, int K,
                 long long n_pad, int batched, int m, long long ldx,
                 long long ldb, unsigned* bar, cudaStream_t stream) {
  if (!batched) {
    fused_block_kernel<T><<<1, kThreads, 0, stream>>>(x, bl, cols, vals, diag,
                                                      spans, nspans, K, n_pad);
    return static_cast<int>(cudaGetLastError());
  }
  int blocks = 0;
  int err = grid_blocks<T>(&blocks);
  if (err != 0) return err;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (static_cast<long long>(nspans) * blocks > 0xffffffffLL)  // the count's range
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&x, &bl, &cols, &vals, &diag, &spans, &nspans, &K,
                  &n_pad, &m, &ldx, &ldb, &bar};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_grid_kernel<T>), dim3(blocks),
      dim3(kThreads), args, 0, stream));
}

}  // namespace

extern "C" int sptrsv_fused_f32(float* x, const float* bl, const int* cols,
                                const float* vals, const float* diag,
                                const int* spans, int nspans, int K,
                                long long n_pad, int batched, int m,
                                long long ldx, long long ldb, unsigned* bar,
                                cudaStream_t stream) {
  return fused_launch<float>(x, bl, cols, vals, diag, spans, nspans, K, n_pad,
                             batched, m, ldx, ldb, bar, stream);
}

extern "C" int sptrsv_fused_f64(double* x, const double* bl, const int* cols,
                                const double* vals, const double* diag,
                                const int* spans, int nspans, int K,
                                long long n_pad, int batched, int m,
                                long long ldx, long long ldb, unsigned* bar,
                                cudaStream_t stream) {
  return fused_launch<double>(x, bl, cols, vals, diag, spans, nspans, K,
                              n_pad, batched, m, ldx, ldb, bar, stream);
}

// The block count of the batched grid on the current device.
extern "C" int sptrsv_fused_grid_f32(int* blocks) { return grid_blocks<float>(blocks); }
extern "C" int sptrsv_fused_grid_f64(int* blocks) { return grid_blocks<double>(blocks); }
