// Batched dense diagonal-block apply for Hopper (sm_90a): the blocked
// (supernodal) solve's x_blk = Dinv_blk @ (b_blk - s_blk).
//
// Replaces the TPU kernel `block_apply_kernel` / `block_apply` of the JAX
// package (src/repro/kernels/trsm_block/lowering_tpu.py), and the
// `dot_general` that its wrapper (trsm_block/ops.py) falls back to for a
// batched RHS.  For every block b < B, row i < T and RHS column j < m:
//
//     out[b, i, j] = sum_t Dinv[b, i, t] * rhs[b, t, j]
//
// with Dinv (B, T, T), rhs and out (B, T) or (B, T, m), all row-major.
//
// Design:
//   * one thread block per diagonal block; its threads first copy Dinv[b]
//     into shared memory (coalesced), with a row stride of T + 1 so that a
//     warp reading one column t across 32 rows i hits 32 different banks;
//   * the threads then stride over the T x m outputs, neighbouring threads
//     on neighbouring RHS columns j: at m >= 32 a warp shares one row of
//     Dinv (a shared-memory broadcast) and reads a row of rhs coalesced; at
//     m = 1 a warp takes 32 rows and every thread reads the same rhs value;
//   * the sum runs in the value dtype, t = 0 .. T-1 (f64 accumulates in
//     f64, as the reference `_dot_apply` does, not in f32 as the TPU kernel
//     does); nvcc contracts it to FMA, so bits may differ from the plain
//     torch version by rounding;
//   * no tensor cores: wgmma / DMMA tiles are for a later change.
//
// Bound: bytes.  Each block reads T*T Dinv values once and T*m rhs values
// and writes T*m outputs for 2*T*T*m FLOPs; at T = 64 in f64 that is below
// the card's FLOP/byte ratio for any m up to ~128.  Dinv is read from
// device memory exactly once, and rhs re-reads hit L1.  On the blocked
// solve of a band each launch holds one 64 x 64 block, so a launch is
// bound by launch latency, not by either.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
block_apply_kernel(T* __restrict__ out, const T* __restrict__ dinv,
                   const T* __restrict__ rhs, int Tb, int m) {
  extern __shared__ unsigned char smem_raw[];
  T* d = reinterpret_cast<T*>(smem_raw);
  const int mm = kBatched ? m : 1;
  const int ld = Tb + 1;
  const long long b = blockIdx.x;
  const T* dsrc = dinv + b * Tb * Tb;
  for (int e = threadIdx.x; e < Tb * Tb; e += blockDim.x)
    d[(e / Tb) * ld + e % Tb] = dsrc[e];
  __syncthreads();
  const T* r = rhs + b * Tb * mm;
  T* o = out + b * Tb * mm;
  for (int e = threadIdx.x; e < Tb * mm; e += blockDim.x) {
    const int i = e / mm;
    const int j = e - i * mm;
    const T* di = d + i * ld;
    T acc = T(0);
    for (int t = 0; t < Tb; ++t) acc += di[t] * r[t * mm + j];
    o[e] = acc;
  }
}

template <typename T, bool kBatched>
int launch(T* out, const T* dinv, const T* rhs, long long B, int Tb, int m,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Tb) * (Tb + 1) * sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_apply_kernel<T, kBatched>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  block_apply_kernel<T, kBatched><<<static_cast<unsigned>(B), kThreads, smem, stream>>>(
      out, dinv, rhs, Tb, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int block_apply_any(T* out, const T* dinv, const T* rhs, long long B, int Tb,
                    int batched, int m, cudaStream_t stream) {
  if (B == 0 || Tb == 0 || m == 0) return 0;
  if (batched) return launch<T, true>(out, dinv, rhs, B, Tb, m, stream);
  return launch<T, false>(out, dinv, rhs, B, Tb, 1, stream);
}

}  // namespace

extern "C" int trsm_block_apply_f32(float* out, const float* dinv,
                                    const float* rhs, long long B, int Tb,
                                    int batched, int m, cudaStream_t stream) {
  return block_apply_any<float>(out, dinv, rhs, B, Tb, batched, m, stream);
}

extern "C" int trsm_block_apply_f64(double* out, const double* dinv,
                                    const double* rhs, long long B, int Tb,
                                    int batched, int m, cudaStream_t stream) {
  return block_apply_any<double>(out, dinv, rhs, B, Tb, batched, m, stream);
}
