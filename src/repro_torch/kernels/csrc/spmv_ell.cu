// ELL SpMV for Hopper (sm_90a): y = M v over the transposed (K, n) ELL
// layout.
//
// Replaces the TPU kernel `spmv_kernel` / `spmv` of the JAX package
// (src/repro/kernels/spmv_ell/lowering_tpu.py).  For every row i < n and
// RHS column j < m:
//
//     y[i, j] = sum_k vals[k, i] * v[cols[k, i], j]
//
// Its user in the port is the rewritten solve's per-solve RHS transform
// b' = E b (one launch per solve, E in the original row order).
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
//   * with a row-length array (row_len, int32 (n,)), the thread of row i
//     reads only its row_len[i] real entries, then, for a row shorter than
//     K, adds the pads' term 0 * v[0] once.  ELL pads hold col 0 and val 0,
//     so the K - len pad terms of the reference all equal that one; adding
//     a zero (or NaN) again does not change the sum, so the result is the
//     full-K loop's bit for bit, NaN rows for a non-finite v[0] included;
//   * without row lengths (row_len null) the thread walks all K slots,
//     pads gathered like real entries (0 * v[0]);
//   * the caller checks on the host that every column lies inside v: a
//     CUDA gather does not clip.
//
// Bound: bytes.  Each output reads its row's (index, value) pairs and
// gathered values and does 2 FLOPs per entry, far below the FLOP/byte
// ratio of the card.  E of the lung2 forward rewrite has 117,218 nonzeros
// over 110,258 rows (109,388 rows of one entry) but K = 16: the full-K loop
// reads a slab 15x E's size; with row lengths a thread reads its row's
// entries and one row length, and a warp waits for its longest row.  The
// bound counted beside its time is E's true nonzeros.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(T* __restrict__ y, const T* __restrict__ v,
            const int* __restrict__ cols, const T* __restrict__ vals,
            const int* __restrict__ row_len, int K, long long n, int m,
            long long ldv, long long ldy) {
  const int mm = kBatched ? m : 1;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= n * mm) return;
  const long long i = t / mm;
  const int j = static_cast<int>(t - i * mm);
  const int len = row_len ? row_len[i] : K;
  T acc = T(0);
  for (int k = 0; k < len; ++k) {
    const long long e = static_cast<long long>(k) * n + i;
    acc += vals[e] * v[static_cast<long long>(cols[e]) * ldv + j];
  }
  if (len < K) acc += T(0) * v[j];   // the pads' 0 * v[0], once
  y[i * ldy + j] = acc;
}

template <typename T>
int spmv_any(T* y, const T* v, const int* cols, const T* vals,
             const int* row_len, int K, long long n, int batched, int m,
             long long ldv, long long ldy, cudaStream_t stream) {
  const long long total = n * (batched ? m : 1);
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (batched)
    spmv_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        y, v, cols, vals, row_len, K, n, m, ldv, ldy);
  else
    spmv_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        y, v, cols, vals, row_len, K, n, 1, ldv, ldy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row_len: int32 (n,) real entries per row, or null for all K slots
extern "C" int spmv_ell_f32(float* y, const float* v, const int* cols,
                            const float* vals, const int* row_len, int K,
                            long long n, int batched, int m, long long ldv,
                            long long ldy, cudaStream_t stream) {
  return spmv_any<float>(y, v, cols, vals, row_len, K, n, batched, m, ldv,
                         ldy, stream);
}

extern "C" int spmv_ell_f64(double* y, const double* v, const int* cols,
                            const double* vals, const int* row_len, int K,
                            long long n, int batched, int m, long long ldv,
                            long long ldy, cudaStream_t stream) {
  return spmv_any<double>(y, v, cols, vals, row_len, K, n, batched, m, ldv,
                          ldy, stream);
}
