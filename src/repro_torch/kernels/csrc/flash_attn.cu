// Flash-attention forward for Hopper (sm_90a): causal / sliding-window
// attention with the online softmax, on the (B, S, H, hd) GQA layout.
//
// Both entry points replace the TPU kernel `_fa_kernel` / `flash_fwd` of the
// JAX package (src/repro/kernels/flash_attn/kernel.py).  For every batch b,
// query head h and query position i < Sq (KV head h / (Hq / Hkv), as the JAX
// wrapper's KV-head repeat gives it):
//
//     o[b, i, h] = sum_j p_ij v[b, j, hk] / sum_j p_ij,
//     p_ij = exp(s_ij - max_j s_ij),   s_ij = (q[b, i, h] . k[b, j, hk]) hd^-0.5
//
// and, with a score softcap c > 0 (gemma3's 30), s_ij = c tanh(s_ij / c) on
// the scaled score, before the mask, as the JAX model's `softcap` step
// (src/repro/models/layers.py:206-208).  The cap is a template flag of both
// kernels: with c = 0 they do no extra work per score.
//
// over the keys j < Sk that are live: j < valid_len, j <= i when causal
// (or j < prefix_len: a bidirectional prefix, paligemma's prefix-LM mask
// (k <= q) | (k < prefix_len), src/repro/models/layers.py:126-127), and
// j > i - window when window > 0.  A prefix needs causal and no window.
// Dead scores are the finite -1e30 of the
// reference, never -inf: a row whose first visited tile holds only dead
// keys takes p = exp(0) = 1 there, and the next tile's
// alpha = exp(-1e30 - m) clears it (with -inf, -inf - -inf is NaN).  A row
// with no live key at all (valid_len = 0, or a window past valid_len) gets
// what the reference gives it: p = 1 for every key j < Sk, i.e. the mean
// of v.  A query tile holding such a row visits every KV tile, and keys
// past Sk score -inf so that they never count.
//
// Common to both kernels:
//   * one thread block per (64-row query tile, b * Hq + h), query tiles
//     issued last-first, so the longest causal rows start first;
//   * the TPU's sequential (ARBITRARY) KV grid axis becomes a loop inside
//     the block over 64-key tiles, over the range of tiles that the TPU
//     kernel's `live` predicate (plus the valid_len bound and the prefix)
//     keeps, so causal prefill visits about half of them; with a prefix
//     the range still starts at tile 0 and reaches the prefix's last tile
//     from every query tile;
//   * acc, m and l stay in f32 registers across the KV loop;
//   * the ragged edges (Sq, Sk not multiples of 64) are masked here: rows
//     past Sq are computed on zeros and not stored, keys past Sk are
//     zero-filled and score -inf.
//
// Bound: operations.  Causal prefill at granite-3-8b's shape (S = 2048,
// 32 heads, hd = 128) does 4 hd Hq S (S + 1) / 2 = 34 GFLOP per layer
// against 42 MB of q, k, v and o: about 800 FLOP per byte, above the
// card's ridge (295 bf16 FLOP per byte), so the bound is the bf16
// tensor-core rate (989 TFLOP/s).
//
// flash_attn_fwd_bf16, on tensor cores (FlashAttention-2 style, mma.sync):
//   * 4 warps (128 threads) per block; warp w owns query rows 16w..16w+15
//     of the tile.  The Q tile comes to shared memory once and its A
//     fragments to registers with ldmatrix (HD <= 128; at HD = 256 they
//     would cost 64 more registers on top of a 128-register accumulator,
//     so they are re-read from shared memory for every KV tile);
//   * K/V tiles reach shared memory by 16-byte cp.async in a 2-stage ring:
//     tile t + 1 loads while tile t computes.  Rows are padded by one
//     16-byte chunk, so the 8 row addresses of every ldmatrix phase fall in
//     8 different bank groups (no conflicts);
//   * S = Q K^T on mma.sync.m16n8k16 (bf16 in, f32 accumulators), K read
//     by ldmatrix as the column-major B operand;
//   * the online softmax runs on the accumulator fragments: a thread holds
//     two rows of each n8 tile, a row's max reduces over its 4-lane quad
//     with 2 shuffles, the row sum l is kept per thread (from the f32 p)
//     and reduced once at the end;
//   * the mask is evaluated only on tiles that cut the diagonal, the
//     window edge, valid_len or Sk; interior tiles skip it (a tile past the
//     diagonal that the prefix makes live is masked all the same: the test
//     stays the causal one, which is conservative);
//   * P is rounded to bf16 in registers and used directly as the A operand
//     of P V (the m16n8 accumulator layout of two n8 tiles is the k16 A
//     layout), which is what the TPU kernel does (`p.astype(v.dtype)`);
//     V comes through ldmatrix.trans;
//   * the head dim is a template HD in {64, 128, 256}; any hd <= HD
//     zero-fills the columns past hd, so every hd in 1..256 runs (an hd
//     that is not a multiple of 8, or a tensor that is not 16-byte
//     aligned, loads with plain loads instead of cp.async).
//   Left for later: wgmma, TMA and warp specialisation (ROADMAP B7).
//
// flash_attn_fwd_f32 keeps the scalar design of the port's first kernel
// (tensor cores would make it TF32 and lose the 1e-5 agreement; the LM
// runs bf16 on the card): 256 threads per block, Q in shared memory as
// f32, K/V tiles in shared memory padded by one 32-bit word, thread (r, c)
// owning rows 4r..4r+3 and keys / output columns c + 16j, products as
// scalar f32 FMAs, p kept in f32.  It is far from the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kNegInf = -1e30f;

// --------------------------------------------------------------------------
// Shared by both kernels: the KV tiles a query tile visits, and the mask.

// True when a row of the query tile at q0 has no live key below Sk.
__device__ bool tile_has_dead_row(int q0, int Sq, int valid_len, int causal,
                                  int window, int prefix_len) {
  const int end = min(q0 + kBQ, Sq);
  for (int i = q0; i < end; ++i) {
    const int lo = window > 0 ? max(0, i - window + 1) : 0;
    const int hi = causal ? min(max(i, prefix_len - 1), valid_len - 1)
                          : valid_len - 1;
    if (lo > hi) return true;
  }
  return false;
}

// The KV tiles [*lo, *hi] of the query tile at q0: the TPU kernel's `live`
// predicate plus the valid_len bound and the prefix, which keep a
// contiguous range; every tile when the query tile holds a dead row.
__device__ void kv_tiles(int q0, int Sq, int Sk, int valid_len, int causal,
                         int window, int prefix_len, int* lo, int* hi) {
  const int n_kt = (Sk + kBK - 1) / kBK;
  if (tile_has_dead_row(q0, Sq, valid_len, causal, window, prefix_len)) {
    *lo = 0;
    *hi = n_kt - 1;
    return;
  }
  *lo = n_kt;
  *hi = -1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    bool live = k0 < valid_len;
    if (causal) live = live && (k0 <= q0 + kBQ - 1 || k0 < prefix_len);
    if (window > 0) live = live && k0 + kBK - 1 > q0 - window;
    if (live) {
      *lo = min(*lo, kt);
      *hi = kt;
    }
  }
}

// Score s of query i and key j after the mask: s when live, -1e30 when
// dead, -inf past Sk (never counted, not even in a dead row's mean).
__device__ __forceinline__ float masked(float s, int i, int j, int Sk,
                                        int valid_len, int causal, int window,
                                        int prefix_len) {
  if (j >= Sk) return __int_as_float(0xff800000);  // -inf
  bool ok = j < valid_len;
  if (causal) ok = ok && (j <= i || j < prefix_len);
  if (window > 0) ok = ok && j > i - window;
  return ok ? s : kNegInf;
}

// --------------------------------------------------------------------------
// f32: scalar FMAs.

constexpr int kThreads = 256;

template <int kCols, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(float* __restrict__ o, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ v,
                     int Sq, int Sk, int Hq, int Hkv, int hd, int valid_len,
                     int causal, int window, int prefix_len, float scale,
                     float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = hd + 1;
  const int ldp = kBK + 1;
  const int ldk = hd + 1;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + kBQ * ldq;
  float* Ks = Ps + kBQ * ldp;
  float* Vs = Ks + kBK * ldk;

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
  const float* qb = q + (static_cast<long long>(b) * Sq * Hq + h) * hd;
  const float* kb = k + (static_cast<long long>(b) * Sk * Hkv + hk) * hd;
  const float* vb = v + (static_cast<long long>(b) * Sk * Hkv + hk) * hd;
  float* ob = o + (static_cast<long long>(b) * Sq * Hq + h) * hd;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd;
    const int d = e - i * hd;
    const int s = q0 + i;
    Qs[i * ldq + d] = s < Sq ? qb[s * q_row + d] : 0.f;
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

  int kt_lo, kt_hi;
  kv_tiles(q0, Sq, Sk, valid_len, causal, window, prefix_len, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Qs written; the last tile's P V done with Ks, Vs, Ps
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int j = e / hd;
      const int d = e - j * hd;
      const int s = k0 + j;
      const bool in = s < Sk;
      Ks[j * ldk + d] = in ? kb[s * kv_row + d] : 0.f;
      Vs[j * ldk + d] = in ? vb[s * kv_row + d] : 0.f;
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
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(c + 16 * j) * ldk + d];
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
        float s = sc[i][j] * scale;
        if constexpr (kCap) s = softcap * tanhf(s / softcap);
        sc[i][j] = masked(s, qp, k0 + c + 16 * j, Sk, valid_len, causal, window,
                          prefix_len);
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
          const float vv = Vs[j * ldk + d];
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
      if (d < hd) ob[s * q_row + d] = acc[i][cc] / denom;
    }
  }
}

size_t f32_smem_bytes(int hd) {
  return sizeof(float) * (kBQ * (hd + 1) + kBQ * (kBK + 1) + 2 * kBK * (hd + 1));
}

template <int kCols>
int launch_f32(float* o, const float* q, const float* k, const float* v, int B,
               int Sq, int Sk, int Hq, int Hkv, int hd, int valid_len,
               int causal, int window, int prefix_len, float scale,
               float softcap, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(hd);
  auto kern = softcap > 0.f ? flash_fwd_f32_kernel<kCols, true>
                            : flash_fwd_f32_kernel<kCols, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(o, q, k, v, Sq, Sk, Hq, Hkv, hd,
                                         valid_len, causal, window, prefix_len,
                                         scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// bf16: tensor cores.

typedef __nv_bfloat16 bf16;
constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;

// Shared-memory tile of 64 rows x HD columns: row stride HD + 8 elements
// (one 16-byte chunk of pad, for conflict-free ldmatrix).  The block holds
// the Q tile and two stages of K and V tiles.
template <int HD>
struct Tile {
  static constexpr int kLd = HD + 8;
  static constexpr int kElems = kBQ * kLd;
  static constexpr size_t kSmem = sizeof(bf16) * kElems * 5;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as bf16x2, lo in the low half (the lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [s0, s0 + 64) of a bf16 matrix whose row s starts at src + s * ld,
// columns [0, HD), into a padded shared tile; rows >= S and columns >= hd
// are zero.  kAsync: 16-byte cp.async (hd % 8 == 0, 16-byte aligned rows),
// else plain loads and stores.
template <int HD, bool kAsync>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long ld, int s0, int S, int hd) {
  constexpr int kLd = Tile<HD>::kLd;
  if constexpr (kAsync) {
    constexpr int kChunks = HD / 8;
#pragma unroll
    for (int it = 0; it < kBQ * kChunks / kMmaThreads; ++it) {
      const int c = it * kMmaThreads + threadIdx.x;
      const int r = c / kChunks;
      const int d = (c % kChunks) * 8;
      const bool in = s0 + r < S && d < hd;
      const bf16* g = in ? src + (s0 + r) * ld + d : src;
      cp_async16(smem_u32(tile + r * kLd + d), g, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kBQ * HD; e += kMmaThreads) {
      const int r = e / HD;
      const int d = e % HD;
      tile[r * kLd + d] = (s0 + r < S && d < hd) ? src[(s0 + r) * ld + d]
                                                 : __float2bfloat16(0.f);
    }
  }
}

// Scores reach the exp2 domain as s = qk * s_mul without a cap, and as
// s = tanh(qk * s_mul) * cap_log2 with one (s_mul = scale / cap,
// cap_log2 = cap * log2(e)): the cap sits between the scale and log2(e).
template <int HD, bool kAsync, bool kCap>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(bf16* __restrict__ o, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      int Sq, int Sk, int Hq, int Hkv, int hd, int valid_len,
                      int causal, int window, int prefix_len, float s_mul,
                      float cap_log2) {
  constexpr int kLd = Tile<HD>::kLd;
  constexpr int kTile = Tile<HD>::kElems;
  constexpr int kKC = HD / 16;           // k16 steps over the head dim
  constexpr int kDN = HD / 8;            // n8 tiles of the output row
  constexpr bool kQRegs = HD <= 128;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);
  bf16* Ks = Qs + kTile;                 // stages 0, 1
  bf16* Vs = Ks + 2 * kTile;             // stages 0, 1

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;               // fragment row (and row + 8)
  const int t = lane & 3;                // fragment column pair

  const long long q_row = static_cast<long long>(Hq) * hd;
  const long long kv_row = static_cast<long long>(Hkv) * hd;
  const bf16* qb = q + (static_cast<long long>(b) * Sq * Hq + h) * hd;
  const bf16* kb = k + (static_cast<long long>(b) * Sk * Hkv + hk) * hd;
  const bf16* vb = v + (static_cast<long long>(b) * Sk * Hkv + hk) * hd;
  bf16* ob = o + (static_cast<long long>(b) * Sq * Hq + h) * hd;

  // ldmatrix row addresses of this lane (element offsets in a tile):
  // Q as the A operand (matrices: rows 0-7 / 8-15 x cols 0-7 / 8-15 of the
  // warp's 16 rows), K as the B operand of two n8 key tiles (keys 0-7 /
  // 8-15 x d 0-7 / 8-15), V transposed as the B operand of two n8 d tiles.
  const int a_off = (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                    ((lane >> 4) & 1) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * kLd + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + ((lane >> 4) & 1) * 8;
  const int row0 = q0 + 16 * warp + g;   // this thread's rows: row0, row0 + 8

  float acc[kDN][4];
#pragma unroll
  for (int j = 0; j < kDN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  uint32_t qf[kQRegs ? kKC : 1][4];

  int kt_lo, kt_hi;
  kv_tiles(q0, Sq, Sk, valid_len, causal, window, prefix_len, &kt_lo, &kt_hi);
  if (kt_lo <= kt_hi) {
    load_tile<HD, kAsync>(Qs, qb, q_row, q0, Sq, hd);
    load_tile<HD, kAsync>(Ks, kb, kv_row, kt_lo * kBK, Sk, hd);
    load_tile<HD, kAsync>(Vs, vb, kv_row, kt_lo * kBK, Sk, hd);
    cp_async_commit();
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    const bf16* Kt = Ks + stage * kTile;
    const bf16* Vt = Vs + stage * kTile;
    if (kt < kt_hi) {  // prefetch the next tile into the other stage
      load_tile<HD, kAsync>(Ks + (stage ^ 1) * kTile, kb, kv_row, (kt + 1) * kBK, Sk, hd);
      load_tile<HD, kAsync>(Vs + (stage ^ 1) * kTile, vb, kv_row, (kt + 1) * kBK, Sk, hd);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and on the first tile, Q) has landed
    if constexpr (kQRegs) {
      if (kt == kt_lo) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc) ldsm_x4(smem_u32(Qs + a_off + kc * 16), qf[kc]);
      }
    }

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n8 tiles
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
      } else {
        ldsm_x4(smem_u32(Qs + a_off + kc * 16), a);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(Kt + k_off + np * 16 * kLd + kc * 16), kf);
        mma_bf16(sc[2 * np], a, kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // scale into the exp2 domain; mask only tiles that cut an edge (a tile
    // that the causal test calls an edge may lie in the prefix: masking it
    // changes nothing)
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK > valid_len || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e] * s_mul;
        if constexpr (kCap) s = tanhf(s) * cap_log2;
        sc[j][e] = edge ? masked(s, row0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1),
                                 Sk, valid_len, causal, window, prefix_len)
                        : s;
      }

    // online softmax on the fragments: rows row0 (e = 0, 1), row0 + 8 (2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - m[e >> 1]);
        l[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int j = 0; j < kDN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P V: P as bf16 A fragments straight from the S accumulators
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(smem_u32(Vt + v_off + kc * 16 * kLd + dp * 16), vf);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int s = row0 + 8 * r;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + s * q_row;
#pragma unroll
    for (int j = 0; j < kDN; ++j) {
      const int d = 8 * j + 2 * t;
      const float x0 = acc[j][2 * r] / denom;
      const float x1 = acc[j][2 * r + 1] / denom;
      if (d + 1 < hd && (hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < hd) orow[d] = __float2bfloat16(x0);
        if (d + 1 < hd) orow[d + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HD, bool kAsync>
int launch_bf16(bf16* o, const bf16* q, const bf16* k, const bf16* v, int B,
                int Sq, int Sk, int Hq, int Hkv, int hd, int valid_len,
                int causal, int window, int prefix_len, float scale,
                float softcap, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD>::kSmem;
  constexpr float kLog2e = 1.4426950408889634f;  // p = exp2(s log2(e) - m)
  const bool cap = softcap > 0.f;
  auto kern = cap ? flash_fwd_bf16_kernel<HD, kAsync, true>
                  : flash_fwd_bf16_kernel<HD, kAsync, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      o, q, k, v, Sq, Sk, Hq, Hkv, hd, valid_len, causal, window, prefix_len,
      cap ? scale / softcap : scale * kLog2e, softcap * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_bf16(bf16* o, const bf16* q, const bf16* k, const bf16* v, int B,
                  int Sq, int Sk, int Hq, int Hkv, int hd, int valid_len,
                  int causal, int window, int prefix_len, float scale,
                  float softcap, cudaStream_t stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  if (hd % 8 == 0 && aligned)
    return launch_bf16<HD, true>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len,
                                 causal, window, prefix_len, scale, softcap,
                                 stream);
  return launch_bf16<HD, false>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len,
                                causal, window, prefix_len, scale, softcap,
                                stream);
}

// A prefix in [0, Sk], and only on a causal mask without a window.
bool bad_shape(int Sq, int Sk, int Hkv, int Hq, int hd, int causal, int window,
               int prefix_len, float softcap) {
  return hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0 ||
         (Sq + kBQ - 1) / kBQ > 65535 || !(softcap >= 0.f) || prefix_len < 0 ||
         prefix_len > Sk || (prefix_len > 0 && (!causal || window > 0));
}

}  // namespace

extern "C" int flash_attn_fwd_f32(float* o, const float* q, const float* k,
                                  const float* v, int B, int Sq, int Sk, int Hq,
                                  int Hkv, int hd, int valid_len, int causal,
                                  int window, int prefix_len, float scale,
                                  float softcap, cudaStream_t stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (bad_shape(Sq, Sk, Hkv, Hq, hd, causal, window, prefix_len, softcap) ||
      B * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)
    return launch_f32<4>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len, causal,
                         window, prefix_len, scale, softcap, stream);
  if (hd <= 128)
    return launch_f32<8>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len, causal,
                         window, prefix_len, scale, softcap, stream);
  return launch_f32<16>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len, causal,
                        window, prefix_len, scale, softcap, stream);
}

extern "C" int flash_attn_fwd_bf16(__nv_bfloat16* o, const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, int B, int Sq, int Sk,
                                   int Hq, int Hkv, int hd, int valid_len,
                                   int causal, int window, int prefix_len,
                                   float scale, float softcap,
                                   cudaStream_t stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (bad_shape(Sq, Sk, Hkv, Hq, hd, causal, window, prefix_len, softcap))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64)
    return dispatch_bf16<64>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len,
                             causal, window, prefix_len, scale, softcap, stream);
  if (hd <= 128)
    return dispatch_bf16<128>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len,
                              causal, window, prefix_len, scale, softcap, stream);
  return dispatch_bf16<256>(o, q, k, v, B, Sq, Sk, Hq, Hkv, hd, valid_len,
                            causal, window, prefix_len, scale, softcap, stream);
}
