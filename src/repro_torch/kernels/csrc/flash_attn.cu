// Flash-attention forward for Hopper (sm_90a): causal / sliding-window
// attention with the online softmax, on the (B, S, H, hd) GQA layout.
//
// Replaces the TPU kernel `_fa_kernel` / `flash_fwd` of the JAX package
// (src/repro/kernels/flash_attn/kernel.py).  For every batch b, query head
// h and query position i < Sq (KV head h / (Hq / Hkv), as the JAX wrapper's
// KV-head repeat gives it):
//
//     o[b, i, h] = sum_j p_ij v[b, j, hk] / sum_j p_ij,
//     p_ij = exp(s_ij - max_j s_ij),   s_ij = (q[b, i, h] . k[b, j, hk]) hd^-0.5
//
// over the keys j that are live: j < valid_len, j <= i when causal, and
// j > i - window when window > 0.  Dead scores are the finite -1e30 of the
// reference, never -inf: a row whose first visited tile holds only dead
// keys takes p = exp(0) = 1 there, and the next tile's
// alpha = exp(-1e30 - m) clears it (with -inf, -inf - -inf is NaN).
//
// Design (right and simple first):
//   * one thread block of 256 threads per (64-row query tile, b * Hq + h);
//     query tiles are issued last-first, so the longest causal rows start
//     first;
//   * the TPU's sequential (ARBITRARY) KV grid axis becomes a loop inside
//     the block over 64-key tiles; a tile with no live entry is skipped
//     with the TPU kernel's `live` predicate, so causal prefill visits about
//     half of them;
//   * the query tile sits in shared memory as f32, the K and V tiles in
//     their input dtype (bf16 or f32); rows are padded by one 32-bit word so
//     that the 16 threads sharing a query row read 16 banks;
//   * thread (r, c) owns rows 4r..4r+3 of the tile, keys c + 16j of the
//     score tile and output columns c + 16j; the row max and row sum are
//     reduced over the row's 16 threads with warp shuffles;
//   * acc, m and l are f32 in registers across the KV loop; p stays f32 for
//     the P V product (the TPU kernel rounds p to v's dtype for its matrix
//     unit; the JAX model's flash attention and `attention_ref` do not);
//   * the ragged edges (Sq, Sk not multiples of 64) are masked here: rows
//     past Sq are computed on zeros and not stored, keys past Sk are neither
//     read nor live.
//
// Bound: operations.  Causal prefill at granite-3-8b's shape (S = 2048,
// 32 heads, hd = 128) does 2 S^2 hd Hq = 34 GFLOP per layer against 67 MB of
// q, k, v and o: about 500 FLOP per byte, above the card's ridge.  The
// bound is the bf16 tensor-core rate; this kernel runs its products as
// scalar f32 FMAs from shared memory (no mma.sync / wgmma, no TMA), so it
// is far from it.  The tensor-core, TMA-fed, warp-specialised redesign is
// later work; this one keeps every score tile out of device memory, which
// is what the TPU kernel was written for.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// K/V row stride in elements: hd plus one 32-bit word
template <typename T> __host__ __device__ constexpr int kv_pad() {
  return sizeof(T) == 4 ? 1 : 2;
}

template <typename T>
size_t smem_bytes(int hd) {
  return sizeof(float) * (kBQ * (hd + 1) + kBQ * (kBK + 1)) +
         sizeof(T) * 2 * kBK * (hd + kv_pad<T>());
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(T* __restrict__ o, const T* __restrict__ q,
                 const T* __restrict__ k, const T* __restrict__ v, int Sq,
                 int Sk, int Hq, int Hkv, int hd, int valid_len, int causal,
                 int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = hd + 1;
  const int ldp = kBK + 1;
  const int ldk = hd + kv_pad<T>();
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + kBQ * ldq;
  T* Ks = reinterpret_cast<T*>(Ps + kBQ * ldp);
  T* Vs = Ks + kBK * ldk;

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / 16;
  const int c = tid % 16;

  // element (b, s, h, d) of a contiguous (B, S, H, hd) tensor
  const long long q_row = static_cast<long long>(Hq) * hd;
  const long long kv_row = static_cast<long long>(Hkv) * hd;
  const T* qb = q + (static_cast<long long>(b) * Sq * Hq + h) * hd;
  const T* kb = k + (static_cast<long long>(b) * Sk * Hkv + hk) * hd;
  const T* vb = v + (static_cast<long long>(b) * Sk * Hkv + hk) * hd;
  T* ob = o + (static_cast<long long>(b) * Sq * Hq + h) * hd;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd;
    const int d = e - i * hd;
    const int s = q0 + i;
    Qs[i * ldq + d] = s < Sq ? to_f32(qb[s * q_row + d]) : 0.f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    // the TPU kernel's `live` (kernel.py), plus the valid_len bound
    bool live = k0 < valid_len;
    if (causal) live = live && k0 <= q0 + kBQ - 1;
    if (window > 0) live = live && k0 + kBK - 1 > q0 - window;
    if (!live) continue;  // uniform over the block

    __syncthreads();  // Qs written; the last tile's P V done with Ks, Vs, Ps
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int j = e / hd;
      const int d = e - j * hd;
      const int s = k0 + j;
      const bool in = s < Sk;
      Ks[j * ldk + d] = in ? kb[s * kv_row + d] : from_f32<T>(0.f);
      Vs[j * ldk + d] = in ? vb[s * kv_row + d] : from_f32<T>(0.f);
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * r + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f32(Ks[(c + 16 * j) * ldk + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * r + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + c + 16 * j;
        bool ok = kp < valid_len;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(4 * r + i) * ldp + c + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * r + i) * ldp + j];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int d = c + 16 * cc;
        if (d < hd) {
          const float vv = to_f32(Vs[j * ldk + d]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * r + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int d = c + 16 * cc;
      if (d < hd) ob[s * q_row + d] = from_f32<T>(acc[i][cc] / denom);
    }
  }
}

template <typename T, int kCols>
int launch(T* o, const T* q, const T* k, const T* v, int B, int Sq, int Sk,
           int Hq, int Hkv, int hd, int valid_len, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(hd);
  auto kern = flash_fwd_kernel<T, kCols>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(o, q, k, v, Sq, Sk, Hq, Hkv, hd,
                                         valid_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flash_any(T* o, const T* q, const T* k, const T* v, int B, int Sq, int Sk,
              int Hq, int Hkv, int hd, int valid_len, int causal, int window,
              float scale, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)
    return launch<T, 4>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len, causal,
                        window, scale, stream);
  if (hd <= 128)
    return launch<T, 8>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len, causal,
                        window, scale, stream);
  return launch<T, 16>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len, causal,
                       window, scale, stream);
}

}  // namespace

extern "C" int flash_attn_fwd_f32(float* o, const float* q, const float* k,
                                  const float* v, int B, int Sq, int Sk, int Hq,
                                  int Hkv, int hd, int valid_len, int causal,
                                  int window, float scale, cudaStream_t stream) {
  return flash_any<float>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len, causal,
                          window, scale, stream);
}

extern "C" int flash_attn_fwd_bf16(__nv_bfloat16* o, const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, int B, int Sq, int Sk,
                                   int Hq, int Hkv, int hd, int valid_len,
                                   int causal, int window, float scale,
                                   cudaStream_t stream) {
  return flash_any<__nv_bfloat16>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len,
                                  causal, window, scale, stream);
}
