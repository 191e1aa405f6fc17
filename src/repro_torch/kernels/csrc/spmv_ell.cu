// ELL SpMV for Hopper (sm_90a): y = M v over the transposed (K, n) ELL
// layout.
//
// Replaces the TPU kernel `spmv_kernel` / `spmv` of the JAX package
// (src/repro/kernels/spmv_ell/lowering_tpu.py).  For every row i < n and
// RHS column j < m:
//
//     y[i, j] = sum_k vals[k, i] * v[cols[k, i], j]
//
// It has two users in the port: the rewritten solve's per-solve RHS
// transform b' = E b (one launch per solve, E in the original row order),
// and the blocked executor's panel update s = Panel x (one launch per
// segment, over the permuted x).
//
// Design:
//   * one thread per output element (row, RHS column), the K loop inside
//     the thread in the TPU kernel's order (acc += v * x from k = 0); nvcc
//     contracts it to FMA, so bits may differ from the plain torch version
//     by rounding;
//   * the m columns of a row sit on neighbouring threads, so each gathered
//     row of v is read coalesced, and each k-plane of cols/vals is read
//     once per row, contiguous across neighbouring rows at m = 1;
//   * values keep the RHS dtype (f32 and f64 instantiations; the JAX
//     wrapper's f32 cast of the values is not copied);
//   * ELL pads keep col 0 and val 0, as in the JAX layout, and are gathered
//     like real entries (0 * v[0]), so a non-finite v[0] spreads exactly
//     as in the reference.  The caller checks on the host that every
//     column lies inside v: a CUDA gather does not clip.
//
// Bound: bytes.  Each output reads K (index, value) pairs and K gathered
// values and does 2K FLOPs, far below the FLOP/byte ratio of the card.  At
// the rewrite's shapes the ELL pads dominate the bytes read: E of the
// lung2 forward rewrite has 117,218 nonzeros over 110,258 rows but K = 16,
// so the slab is about 15x its true size.  The design keeps the reads
// coalesced and leaves the pad to a later layout change (a row-length
// array or a CSR slab); the bound counted beside its time is E's true
// nonzeros.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(T* __restrict__ y, const T* __restrict__ v,
            const int* __restrict__ cols, const T* __restrict__ vals, int K,
            long long n, int m, long long ldv, long long ldy) {
  const int mm = kBatched ? m : 1;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= n * mm) return;
  const long long i = t / mm;
  const int j = static_cast<int>(t - i * mm);
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const long long e = static_cast<long long>(k) * n + i;
    acc += vals[e] * v[static_cast<long long>(cols[e]) * ldv + j];
  }
  y[i * ldy + j] = acc;
}

template <typename T>
int spmv_any(T* y, const T* v, const int* cols, const T* vals, int K,
             long long n, int batched, int m, long long ldv, long long ldy,
             cudaStream_t stream) {
  const long long total = n * (batched ? m : 1);
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (batched)
    spmv_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        y, v, cols, vals, K, n, m, ldv, ldy);
  else
    spmv_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        y, v, cols, vals, K, n, 1, ldv, ldy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spmv_ell_f32(float* y, const float* v, const int* cols,
                            const float* vals, int K, long long n, int batched,
                            int m, long long ldv, long long ldy,
                            cudaStream_t stream) {
  return spmv_any<float>(y, v, cols, vals, K, n, batched, m, ldv, ldy, stream);
}

extern "C" int spmv_ell_f64(double* y, const double* v, const int* cols,
                            const double* vals, int K, long long n, int batched,
                            int m, long long ldv, long long ldy,
                            cudaStream_t stream) {
  return spmv_any<double>(y, v, cols, vals, K, n, batched, m, ldv, ldy, stream);
}
