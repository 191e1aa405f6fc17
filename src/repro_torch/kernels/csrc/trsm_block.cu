// The blocked (supernodal) solve for Hopper (sm_90a): a batched dense
// diagonal-block apply, and the whole blocked solve in one launch.
//
// Both replace the TPU kernel `block_apply_kernel` / `block_apply` of the
// JAX package (src/repro/kernels/trsm_block/lowering_tpu.py), and the
// `dot_general` that its wrapper (trsm_block/ops.py) falls back to for a
// batched RHS.
//
// == trsm_block_apply: one batched apply per launch ==
//
// For every block b < B, row i < T and RHS column j < m:
//
//     out[b, i, j] = sum_t Dinv[b, i, t] * rhs[b, t, j]
//
// with Dinv (B, T, T), rhs and out (B, T) or (B, T, m), all row-major.
// The port's blocked solve no longer calls it (the walk below does the
// whole solve); it stays as the entry for a caller that applies one batch.
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
//   * no tensor cores.
//
// Bound: bytes.  Each block reads T*T Dinv values once and T*m rhs values
// and writes T*m outputs for 2*T*T*m FLOPs; at T = 64 in f64 that is below
// the card's FLOP/byte ratio for any m up to ~128.
//
// == trsm_block_walk: the whole blocked solve in one launch ==
//
// Walks every segment (super-level) of a packed blocked layout in order,
// in place into the permuted solution x (n, m), zero-filled by the caller:
//
//     for each segment (off, R, B, T, K, val_off, dinv_off, lane_off):
//         s[l, j]   = sum_k vals[k, l] * x[cols[k, l], j]   (panel, K x B*T)
//         rhs[l, j] = bhat[off + row[l], j] - s[l, j]  (real lane l)
//                   = -s[l, j]                          (pad lane, row -1)
//         xb[b*T+i, j] = sum_t Dinv[b, i, t] * rhs[b*T+t, j]
//         x[off + row[l], j] = xb[l, j]                 (real lanes)
//
// with row[l] = lane_row[lane_off + l].  It is what the per-segment loop of
// SpMV + index_add_ + apply + index_select computed, one launch for 3,456.
//
// Design: a segment depends on every earlier one, so the time per segment
// is what counts, not bytes.
//   * A work item is (a run of nb diagonal blocks, a group of up to kCols
//     RHS columns).  Its Dinv blocks, panel cols / vals, lane rows and
//     (where the item is its whole segment) bhat rows do not depend on x:
//     they reach shared memory by cp.async, 16-byte copies where aligned,
//     else element copies.  The copies of the items one or two ahead are
//     in flight while an item computes (two or three stages, as many as
//     fit in 227 KB; one where two do not).  nb shrinks where K makes a
//     stage large.
//   * A wide panel: where one diagonal block's stage with its panel does
//     not fit in the shared memory left beside the rhs buffer (f64 at
//     T = 64: K above ~232), the segment's items stage only Dinv, lane
//     rows and bhat, and the panel terms read cols / vals from global
//     memory.  A stage's size then does not grow with K, so any panel
//     width runs in the one launch.
//   * Per item: wait for its copies, __syncthreads() (the previous item is
//     then done with its buffer, rhs and x), start the copies of the item
//     a stage ahead, then the panel, __syncthreads(), the apply.  The
//     table row of the next segment is loaded one item early.
//   * RHS columns are independent for the whole solve: column group g of
//     every segment runs on the same block, which needs no other block.
//     Segments of one item (B = 1 at T = 64 on a band, or B <= nb) follow
//     each other with only __syncthreads(): the block's own global writes
//     are visible to it.  A launch whose segments are all such is a plain
//     launch of one block per column group.
//   * Segments of several items (lung2: B up to 3,770 at T = 1) spread
//     their items over a cooperative grid sized by the occupancy API (a
//     refused launch raises), with the grid barrier of grid_barrier.cuh
//     before and after them; x is then read through L2 (__ldcg).  At small
//     T an item holds up to (threads) / (T x kCols) blocks.
//   * The time per segment is latency and instruction count, not FLOPs: a
//     block of 1 or 2 columns runs 256 threads, from 4 columns 512; each
//     thread's place in an item is worked out once per item shape (a band
//     has one shape), not per segment.
//   * The panel: up to kSplitK threads share a (lane, column)'s K entries,
//     kUnroll of them in flight each, added with warp shuffles.  A term
//     whose column position is at or past the segment's offset is skipped:
//     only pads point there (real panel columns lie in earlier segments),
//     and the reference reads 0 there (x is zero-filled and not yet
//     written), so the skip changes at most the sign of a zero; pads below
//     the offset keep the reference's 0 * x[c] (ROADMAP C-ref 2).
//   * The apply sums in the value dtype; where a block has fewer outputs
//     than threads, `split` threads share an output's t-sum and add with
//     warp shuffles, else a thread takes two outputs at once.  No tensor
//     cores: f32 would lose its 1e-5 tolerance on TF32, and f64 DMMA was
//     not tried (ROADMAP B6).
//
// Bound: bytes read once (Dinv, the panel, bhat, x written once) against
// a dependent chain of segments: on the band 1,728 segments, each one
// round of x gathers plus the 64 x 64 apply on one SM.
#include <cstdint>

#include <cuda_runtime.h>

#include "grid_barrier.cuh"

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

// ---------------------------------------------------------------------------
// trsm_block_walk
// ---------------------------------------------------------------------------
namespace walk {

constexpr int kMaxThreads = 512;  // a block: 256 threads at mc < 4, else 512
constexpr int kCols = 8;          // RHS columns per column group
constexpr int kSplitK = 8;        // most threads sharing one lane's panel row
constexpr int kUnroll = 8;        // panel entries of a thread in flight
constexpr int kGeo = 8;           // table columns
constexpr long long kMaxSmem = 232448;   // a block's shared memory on Hopper
// One diagonal block's stage without its panel does not fit: the host
// refuses.  That stage is T * ((T + 2) * 8 + 68) + 96 bytes in f64 at 8
// columns (38,240 at the supernode detector's default max_block of 64), so
// only T above ~160 (f64) or ~230 (f32) meets it.
constexpr int kTooBig = -2;

// One row of the segment table.
struct Geo {
  long long off, voff, doff, loff;
  int R, B, T, K;
};

__host__ __device__ inline long long rup(long long a, long long b) {
  return (a + b - 1) / b * b;
}

// Row stride of a staged Dinv block: 16-byte rows where a row of T values
// is a multiple of 16 bytes (padded by 16 bytes against bank conflicts),
// else an odd stride.
__host__ __device__ inline int dinv_ld(int T, int sz) {
  return (T * sz) % 16 == 0 ? T + 16 / sz : T | 1;
}

// A stage holding nb diagonal blocks takes at most nb * per + fixed bytes
// (stage_at's layout, each of its five parts rounded up to 16 bytes).
__host__ __device__ inline long long stage_per(long long T, long long K,
                                               long long mc, int sz) {
  return T * (dinv_ld(static_cast<int>(T), sz) * sz + K * (4 + sz) + 4 + mc * sz);
}
__host__ __device__ inline long long stage_fixed(long long K, int sz) {
  return 3 * K * (4 + sz) + 96;
}

// A segment's stage size: *per bytes a diagonal block and *fixed bytes,
// with its panel where one block's stage with it fits in `pcap` bytes
// (*ks = K), else without it (*ks = 0: the panel is read from global
// memory).
__host__ __device__ inline void stage_size(long long T, int K, long long mc,
                                           int sz, long long pcap, long long* per,
                                           long long* fixed, int* ks) {
  *per = stage_per(T, K, mc, sz);
  *fixed = stage_fixed(K, sz);
  *ks = *per + *fixed <= pcap ? K : 0;
  if (*ks < K) {
    *per -= T * K * (4 + sz);
    *fixed = stage_fixed(0, sz);
  }
}

// Diagonal blocks per work item: a thread per (lane, column) where that
// fills the block, fewer where the stage would not fit; `ks` gets the
// panel rows the items stage (stage_size).  32-bit: the host refuses a
// table where one block's stage exceeds the shared memory.
__host__ __device__ inline int blocks_per_item(int B, int T, int K, int mc,
                                               int sz, int stage, int nt,
                                               long long pcap, int* ks) {
  int nb = nt / (T * mc);
  long long per, fixed;
  stage_size(T, K, mc, sz, pcap, &per, &fixed, ks);
  const int fit = (stage - static_cast<int>(fixed)) / static_cast<int>(per);
  if (nb > fit) nb = fit;
  if (nb > B) nb = B;
  return nb < 1 ? 1 : nb;
}

template <typename T>
struct Args {
  T* x;                      // (n, m), zero-filled; written in place
  const T* bhat;             // (n, m)
  const int* cols;           // panel positions, flat (K, B*T) per segment
  const T* vals;             // panel values, packed like cols
  const T* dinv;             // (B, T, T) per segment, flat
  const long long* tab;      // (S, kGeo) segment table
  const int* lane_row;       // lane -> row in its segment, -1 on pads
  unsigned* bar;             // grid barrier count (cooperative launch only)
  long long ldx, ldb;
  long long pcap;            // a panel is staged where a block's stage fits this
  int stage;                 // bytes per stage
  int S, m, mc, G, nstage;
  int nt;                    // threads per block
};

__device__ __forceinline__ Geo geo_of(const long long* tab, int s) {
  const long long* r = tab + static_cast<long long>(s) * kGeo;
  Geo g;
  g.off = __ldg(r);
  g.R = static_cast<int>(__ldg(r + 1));
  g.B = static_cast<int>(__ldg(r + 2));
  g.T = static_cast<int>(__ldg(r + 3));
  g.K = static_cast<int>(__ldg(r + 4));
  g.voff = __ldg(r + 5);
  g.doff = __ldg(r + 6);
  g.loff = __ldg(r + 7);
  return g;
}

// One work item: chunk c = t / G of segment s (blocks b0 .. b0 + nbc) for
// column group gi = t % G; its staged panel rows ks (K or 0).
struct Item {
  Geo g;
  int s, t, b0, nbc, gi, ks;
};

template <typename T>
__device__ __forceinline__ int items_of(const Args<T>& a, const Geo& g) {
  int ks;
  const int nb = blocks_per_item(g.B, g.T, g.K, a.mc, sizeof(T), a.stage, a.nt,
                                 a.pcap, &ks);
  return (g.B + nb - 1) / nb;
}

template <typename T>
__device__ __forceinline__ Item item_at(const Args<T>& a, int s, int t,
                                        const Geo& g) {
  Item it;
  it.g = g;
  it.s = s;
  it.t = t;
  const int nb = blocks_per_item(g.B, g.T, g.K, a.mc, sizeof(T), a.stage, a.nt,
                                 a.pcap, &it.ks);
  const int c = t / a.G;
  it.gi = t - c * a.G;
  it.b0 = c * nb;
  it.nbc = min(nb, g.B - it.b0);
  return it;
}

// The item after `it` of this block in a cooperative launch: tasks
// t = blockIdx.x, + gridDim.x, ... of each segment in turn.  False at the
// end.
template <typename T>
__device__ bool next_item(const Args<T>& a, const Item& it, Item* nx) {
  int s = it.s;
  int t = it.t + gridDim.x;
  Geo g = it.g;
  while (s < a.S) {
    if (t < items_of(a, g) * a.G) {
      *nx = item_at(a, s, t, g);
      return true;
    }
    if (++s < a.S) g = geo_of(a.tab, s);
    t = blockIdx.x;
  }
  return false;
}

// A barrier between segments s and s + 1 unless both are one chunk each:
// then column group g of both runs on one block.
template <typename T>
__device__ bool barrier_after(const Args<T>& a, int s) {
  return items_of(a, geo_of(a.tab, s)) > 1 || items_of(a, geo_of(a.tab, s + 1)) > 1;
}

template <int E>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (E == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(d), "l"(src), "n"(E) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows x cols elements of E bytes, global (row stride sld elements) to
// shared (row stride dld), by the block's threads: 16-byte copies where
// both sides are 16-byte aligned (a warp per row, or the whole tile at
// once where it is contiguous on both sides), else one copy per element.
template <int E>
__device__ void copy_tile(void* dst, int dld, const void* src, long long sld,
                          int rows, int cols) {
  auto* d = static_cast<unsigned char*>(dst);
  auto* s = static_cast<const unsigned char*>(src);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) & 15) == 0;
  if (dld == cols && sld == cols) {          // one contiguous run
    const int n = rows * cols;
    int done = 0;
    if (aligned) {
      const int chunks = n * E / 16;
      for (int e = threadIdx.x; e < chunks; e += blockDim.x)
        cp_async<16>(d + e * 16, s + e * 16);
      done = chunks * 16 / E;
    }
    for (int e = done + threadIdx.x; e < n; e += blockDim.x)
      cp_async<E>(d + e * E, s + e * E);
    return;
  }
  if (aligned && ((dld * E) & 15) == 0 && ((sld * E) & 15) == 0 &&
      ((cols * E) & 15) == 0) {
    const int per = cols * E / 16;
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5)
      for (int c = lane; c < per; c += 32)
        cp_async<16>(d + (static_cast<long long>(r) * dld * E + c * 16),
                     s + (r * sld * E + c * 16));
    return;
  }
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols;
    const int c = e - r * cols;
    cp_async<E>(d + (static_cast<long long>(r) * dld + c) * E,
                s + (r * sld + c) * E);
  }
}

// Where an item's staged data sits in its stage buffer.
template <typename T>
struct Stage {
  T* d;        // (L, ld) Dinv rows of the item's blocks
  int* cols;   // (Ks, Lp): the staged panel, Ks = K or 0
  T* vals;     // (Ks, Lp)
  int* rows;   // (L,) lane -> row, -1 on pads
  T* b;        // (R, mcw) bhat rows, where the item is its whole segment
  int L, Lp, ld;
};

template <typename T>
__device__ __forceinline__ Stage<T> stage_at(unsigned char* base, int L,
                                             int Tb, int K) {
  Stage<T> st;
  st.L = L;
  st.Lp = static_cast<int>(rup(L, 4));
  st.ld = dinv_ld(Tb, sizeof(T));
  int p = 0;
  st.d = reinterpret_cast<T*>(base);
  p += static_cast<int>(rup(static_cast<long long>(L) * st.ld * sizeof(T), 16));
  st.cols = reinterpret_cast<int*>(base + p);
  p += static_cast<int>(rup(static_cast<long long>(K) * st.Lp * 4, 16));
  st.vals = reinterpret_cast<T*>(base + p);
  p += static_cast<int>(rup(static_cast<long long>(K) * st.Lp * sizeof(T), 16));
  st.rows = reinterpret_cast<int*>(base + p);
  p += static_cast<int>(rup(static_cast<long long>(st.Lp) * 4, 16));
  st.b = reinterpret_cast<T*>(base + p);
  return st;
}

// Start the cp.async copies of item `it` into `base`.
template <typename T>
__device__ void stage_item(const Args<T>& a, const Item& it, unsigned char* base) {
  const Geo& g = it.g;
  const int Ks = it.ks;
  const Stage<T> st = stage_at<T>(base, it.nbc * g.T, g.T, Ks);
  const long long BT = static_cast<long long>(g.B) * g.T;
  const long long lane0 = static_cast<long long>(it.b0) * g.T;
  copy_tile<sizeof(T)>(st.d, st.ld, a.dinv + g.doff + lane0 * g.T, g.T, st.L, g.T);
  copy_tile<4>(st.cols, st.Lp, a.cols + g.voff + lane0, BT, Ks, st.L);
  copy_tile<sizeof(T)>(st.vals, st.Lp, a.vals + g.voff + lane0, BT, Ks, st.L);
  copy_tile<4>(st.rows, st.L, a.lane_row + g.loff + lane0, st.L, 1, st.L);
  if (it.nbc == g.B) {       // the whole segment: its rows are [off, off + R)
    const int j0 = it.gi * a.mc;
    const int mcw = min(a.mc, a.m - j0);
    copy_tile<sizeof(T)>(st.b, mcw, a.bhat + g.off * a.ldb + j0, a.ldb, g.R, mcw);
  }
}

template <bool kGrid, typename T>
__device__ __forceinline__ T load_x(const T* p) {
  if constexpr (kGrid) return __ldcg(p);
  return *p;
}

// Thread p's panel terms of one (lane, column) of a wide panel, read
// from device memory: entries k = p, p + ks, ... of the lane's K at
// pc[k * ld] / pv[k * ld], kUnroll of them in flight; a term whose
// position is at or past `off` is skipped.  Not inlined: the staged
// panel's loop in run_item keeps its shared-memory loads.
template <typename T, bool kGrid>
__device__ __noinline__ T panel_terms_global(const int* pc, const T* pv,
                                             long long ld, int K, int p, int ks,
                                             long long off, const T* xj,
                                             long long ldx) {
  T acc = T(0);
  for (int k0 = p; k0 < K; k0 += ks * kUnroll) {
    long long c[kUnroll];
    T v[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * ks;
      c[u] = k < K ? __ldg(pc + k * ld) : off;
      v[u] = k < K ? __ldg(pv + k * ld) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      xv[u] = c[u] < off ? load_x<kGrid>(xj + c[u] * ldx) : T(0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c[u] < off) acc += v[u] * xv[u];
  }
  return acc;
}

// A thread's place in an item of shape (L lanes, mcw columns, K panel
// entries, blocks of Tb): in the panel's first pass (ks threads per
// (lane, column)) and in the apply (split threads per output, else a pair
// of outputs, tid and tid + nt).  Items of one shape follow each
// other (every segment of a band), so it is made once per shape.
struct Map {
  int L = -1, mcw = 0, K = 0, Tb = 0;
  int ks = 1, split = 1;
  int pl = 0, pjj = 0, pp = 0;
  bool pvalid = false;
  int al = 0, ajj = 0, ap = 0;
  bool avalid = false;
  int al1 = 0, ajj1 = 0;
  bool avalid1 = false;
};

__device__ Map make_map(int L, int mcw, int K, int Tb, int nt) {
  Map mp;
  mp.L = L;
  mp.mcw = mcw;
  mp.K = K;
  mp.Tb = Tb;
  const int items = L * mcw;
  while (mp.ks < kSplitK && 2 * mp.ks * items <= nt && 2 * mp.ks <= K) mp.ks *= 2;
  while (mp.split < 32 && 2 * mp.split <= Tb && 2 * mp.split * items <= nt)
    mp.split *= 2;
  const int tid = threadIdx.x;
  int o = tid / mp.ks;
  mp.pp = tid - o * mp.ks;
  mp.pvalid = o < items;
  mp.pl = o / mcw;
  mp.pjj = o - mp.pl * mcw;
  o = tid / mp.split;
  mp.ap = tid - o * mp.split;
  mp.avalid = o < items;
  mp.al = o / mcw;
  mp.ajj = o - mp.al * mcw;
  const int o1 = tid + nt;
  mp.avalid1 = mp.split == 1 && o1 < items;
  mp.al1 = o1 / mcw;
  mp.ajj1 = o1 - mp.al1 * mcw;
  return mp;
}

// Item `it` from its data staged at `base`: panel and rhs into `rhs`
// (shared), then the apply, written to x on the real lanes.
template <typename T, bool kGrid>
__device__ void run_item(const Args<T>& a, const Item& it, unsigned char* base,
                         Map& mp, T* rhs) {
  const int Tb = it.g.T;
  const int K = it.g.K;
  const int Ks = it.ks;
  const Stage<T> st = stage_at<T>(base, it.nbc * Tb, Tb, Ks);
  const long long off = it.g.off;
  const int j0 = it.gi * a.mc;
  const int mcw = min(a.mc, a.m - j0);
  const int items = st.L * mcw;
  if (mp.L != st.L || mp.mcw != mcw || mp.K != K || mp.Tb != Tb)
    mp = make_map(st.L, mcw, K, Tb, a.nt);
  const bool whole = it.nbc == it.g.B;
  const T* x = a.x;
  // panel: ks threads share a (lane, column) item's K entries, kUnroll of
  // them in flight each, then add with warp shuffles
  const int ks = mp.ks;
  const int nt = a.nt;
  for (int w0 = 0; w0 < items * ks; w0 += nt) {
    int l = mp.pl, jj = mp.pjj, p = mp.pp;
    bool valid = mp.pvalid;
    if (w0 > 0) {
      const int e = w0 + threadIdx.x;
      const int o = e / ks;
      p = e - o * ks;
      valid = o < items;
      l = o / mcw;
      jj = o - l * mcw;
    }
    int row = -1;
    T bv = T(0), acc = T(0);
    if (valid) {
      row = st.rows[l];
      if (p == 0 && row >= 0)
        bv = whole ? st.b[row * mcw + jj]
                   : __ldg(a.bhat + (off + row) * a.ldb + j0 + jj);
      if (Ks < K) {
        // a wide panel stays in global memory: (K, B*T) from lane 0
        const long long lane = static_cast<long long>(it.b0) * Tb + l;
        acc = panel_terms_global<T, kGrid>(
            a.cols + it.g.voff + lane, a.vals + it.g.voff + lane,
            static_cast<long long>(it.g.B) * Tb, K, p, ks, off, x + j0 + jj,
            a.ldx);
      } else {
        for (int k0 = p; k0 < K; k0 += ks * kUnroll) {
          long long c[kUnroll];
          T v[kUnroll], xv[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int k = k0 + u * ks;
            c[u] = k < K ? st.cols[k * st.Lp + l] : off;
            v[u] = k < K ? st.vals[k * st.Lp + l] : T(0);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            xv[u] = c[u] < off ? load_x<kGrid>(x + c[u] * a.ldx + j0 + jj) : T(0);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (c[u] < off) acc += v[u] * xv[u];
        }
      }
    }
    for (int w = ks / 2; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (valid && p == 0) rhs[l * mcw + jj] = row >= 0 ? bv - acc : -acc;
  }
  __syncthreads();
  // apply: `split` threads share an output's t-sum where outputs are
  // fewer than threads, else a thread takes two outputs at once
  if (mp.split > 1) {
    const int split = mp.split;
    const int l = mp.al, jj = mp.ajj;
    T acc = T(0);
    if (mp.avalid) {
      const T* drow = st.d + l * st.ld;
      const T* rc = rhs + (l / Tb) * Tb * mcw + jj;
#pragma unroll 4
      for (int q = mp.ap; q < Tb; q += split) acc += drow[q] * rc[q * mcw];
    }
    for (int w = split / 2; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (mp.avalid && mp.ap == 0) {
      const int row = st.rows[l];
      if (row >= 0) a.x[(off + row) * a.ldx + j0 + jj] = acc;
    }
    return;
  }
  for (int o0 = threadIdx.x; o0 < items; o0 += 2 * nt) {
    int l0 = mp.al, jj0 = mp.ajj, l1 = mp.al1, jj1 = mp.ajj1;
    bool has1 = mp.avalid1;
    if (o0 != static_cast<int>(threadIdx.x)) {
      l0 = o0 / mcw;
      jj0 = o0 - l0 * mcw;
      has1 = o0 + nt < items;
      l1 = (o0 + nt) / mcw;
      jj1 = o0 + nt - l1 * mcw;
    }
    if (!has1) {
      l1 = l0;
      jj1 = jj0;
    }
    const T* d0 = st.d + l0 * st.ld;
    const T* d1 = st.d + l1 * st.ld;
    const T* r0 = rhs + (l0 / Tb) * Tb * mcw + jj0;
    const T* r1 = rhs + (l1 / Tb) * Tb * mcw + jj1;
    T acc0 = T(0), acc1 = T(0);
    if (has1) {
#pragma unroll 4
      for (int q = 0; q < Tb; ++q) {
        acc0 += d0[q] * r0[q * mcw];
        acc1 += d1[q] * r1[q * mcw];
      }
    } else {
#pragma unroll 4
      for (int q = 0; q < Tb; ++q) acc0 += d0[q] * r0[q * mcw];
    }
    const int row0 = st.rows[l0];
    if (row0 >= 0) a.x[(off + row0) * a.ldx + j0 + jj0] = acc0;
    const int row1 = st.rows[l1];
    if (has1 && row1 >= 0) a.x[(off + row1) * a.ldx + j0 + jj1] = acc1;
  }
}

// The item after `last` of this block: in a cooperative launch the task
// search of next_item; else the next segment, whose table row `ahead`
// holds (loaded one item early, so its latency hides behind the work in
// between), and `ahead` moves on.
template <typename T, bool kGrid>
__device__ __forceinline__ bool advance(const Args<T>& a, const Item& last,
                                        Geo& ahead, Item* out) {
  if constexpr (kGrid) {
    return next_item(a, last, out);
  } else {
    if (last.s + 1 >= a.S) return false;
    *out = item_at(a, last.s + 1, blockIdx.x, ahead);
    if (last.s + 2 < a.S) ahead = geo_of(a.tab, last.s + 2);
    return true;
  }
}

// The walk.  Items are staged nstage - 1 ahead of the one computing
// (cp.async groups, one per item): at each item, wait for its copies and
// __syncthreads() (the previous item is then done with its buffer, rhs
// and x), start the copies of the item nstage - 1 ahead into the buffer
// the previous item used, and compute.  With one stage the next item's
// copies wait for this one's work.
template <typename T, bool kGrid>
__global__ void __launch_bounds__(kMaxThreads) walk_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  T* rhs = reinterpret_cast<T*>(walk_smem + a.nstage * a.stage);
  const int ahead_n = a.nstage - 1;       // items staged ahead: 0, 1 or 2
  Geo ahead = geo_of(a.tab, a.S > 1 ? 1 : 0);
  Item it0, it1;                          // computing, and the next staged
  int b0 = 0, b1 = 1;                     // their buffers
  bool h0, h1 = false;
  if constexpr (kGrid) {
    Item before;
    before.s = 0;
    before.t = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x);
    before.g = geo_of(a.tab, 0);
    h0 = next_item(a, before, &it0);
  } else {
    // one item per segment and block (column group blockIdx.x)
    it0 = item_at(a, 0, blockIdx.x, geo_of(a.tab, 0));
    h0 = true;
  }
  if (h0) stage_item(a, it0, walk_smem);
  cp_async_commit();
  int slot = a.nstage > 1 ? 1 : 0;        // the buffer the next copies go to
  if (ahead_n == 2) {
    h1 = h0 && advance<T, kGrid>(a, it0, ahead, &it1);
    if (h1) stage_item(a, it1, walk_smem + a.stage);
    cp_async_commit();
    slot = 2;
  }
  unsigned nbar = 0;
  Map mp;
  for (int s = 0; s < a.S; ++s) {
    while (h0 && it0.s == s) {
      if (ahead_n == 2)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      Item nw;
      const int bn = slot;
      bool hn = false;
      if (ahead_n > 0) {
        hn = (ahead_n == 2 ? h1 : h0) &&
             advance<T, kGrid>(a, ahead_n == 2 ? it1 : it0, ahead, &nw);
        if (hn) stage_item(a, nw, walk_smem + bn * a.stage);
        cp_async_commit();
        slot = slot + 1 == a.nstage ? 0 : slot + 1;
        run_item<T, kGrid>(a, it0, walk_smem + b0 * a.stage, mp, rhs);
      } else {
        hn = advance<T, kGrid>(a, it0, ahead, &nw);
        run_item<T, kGrid>(a, it0, walk_smem, mp, rhs);
        __syncthreads();
        if (hn) stage_item(a, nw, walk_smem);
        cp_async_commit();
      }
      if (ahead_n == 2) {
        it0 = it1;
        b0 = b1;
        h0 = h1;
        it1 = nw;
        b1 = bn;
        h1 = hn;
      } else {
        it0 = nw;
        b0 = bn;
        h0 = hn;
      }
    }
    if (kGrid && s + 1 < a.S && barrier_after(a, s))
      grid_barrier(a.bar, (++nbar) * gridDim.x);
  }
}

// How a walk launches: out[] = {cooperative, grid, smem bytes, stages,
// grid barriers, column groups, threads per block, segments whose panel
// stays in global memory}.  A block of a few columns is latency bound and
// runs 256 threads (fewer instructions per segment); from 4 columns up it
// runs 512, with three stages where they fit.  A segment's panel is staged
// where one block's stage with it fits in all the shared memory beside the
// rhs buffer, so a table that ran before keeps its stages.
template <typename T>
int plan(const long long* tab, int S, int m, long long* out, int* stage_out,
         long long* pcap_out) {
  if (S < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int sz = sizeof(T);
  const int mc = m < kCols ? m : kCols;
  const int G = (m + mc - 1) / mc;
  const int nt = mc >= 4 ? kMaxThreads : kMaxThreads / 2;
  long long Tmax = 1;
  for (int s = 0; s < S; ++s) {
    const long long T_ = tab[static_cast<long long>(s) * kGeo + 3];
    if (T_ > Tmax) Tmax = T_;
  }
  const long long rhs = rup((nt > Tmax * mc ? nt : Tmax * mc) * sz, 16);
  const long long avail = kMaxSmem - rhs;
  const long long pcap = avail;
  long long want = 16, need1 = 16, global_panels = 0;
  for (int s = 0; s < S; ++s) {
    const long long* r = tab + static_cast<long long>(s) * kGeo;
    const long long B = r[2], T_ = r[3];
    const int K = static_cast<int>(r[4]);
    long long nb = nt / (T_ * mc);
    if (nb > B) nb = B;
    if (nb < 1) nb = 1;
    long long per, fixed;
    int Ks;
    stage_size(T_, K, mc, sz, pcap, &per, &fixed, &Ks);
    global_panels += Ks < K;
    if (nb * per + fixed > want) want = nb * per + fixed;
    if (per + fixed > need1) need1 = per + fixed;
  }
  want = rup(want, 16);
  need1 = rup(need1, 16);
  long long stage;
  int nstage;
  if (nt == kMaxThreads && 3 * want <= avail) {
    nstage = 3;
    stage = want;
  } else if (2 * want <= avail) {
    nstage = 2;
    stage = want;
  } else if (2 * need1 <= avail) {
    nstage = 2;
    stage = avail / 2 / 16 * 16;
  } else if (need1 <= avail) {
    nstage = 1;
    stage = want < avail ? want : avail / 16 * 16;
  } else {
    return kTooBig;
  }
  long long barriers = 0, max_tasks = G;
  bool coop = false, prev = false;
  for (int s = 0; s < S; ++s) {
    const long long* r = tab + static_cast<long long>(s) * kGeo;
    int ks;
    const int nb = blocks_per_item(static_cast<int>(r[2]), static_cast<int>(r[3]),
                                   static_cast<int>(r[4]), mc, sz,
                                   static_cast<int>(stage), nt, pcap, &ks);
    const long long chunks = (r[2] + nb - 1) / nb;
    const bool multi = chunks > 1;
    coop = coop || multi;
    if (chunks * G > max_tasks) max_tasks = chunks * G;
    if (s > 0 && (multi || prev)) ++barriers;
    prev = multi;
  }
  if (max_tasks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = coop;
  out[1] = coop ? max_tasks : G;   // the cooperative grid is capped below
  out[2] = nstage * stage + rhs;
  out[3] = nstage;
  out[4] = coop ? barriers : 0;
  out[5] = G;
  out[6] = nt;
  out[7] = global_panels;
  *stage_out = static_cast<int>(stage);
  *pcap_out = pcap;
  return 0;
}

template <typename T, bool kGrid>
int allow_smem(long long smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      walk_kernel<T, kGrid>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Fills out[] as plan() does, with out[1] the grid the launch uses.
template <typename T>
int config(const long long* tab, int S, int m, long long* out, int* stage,
           long long* pcap) {
  int rc = plan<T>(tab, S, m, out, stage, pcap);
  if (rc != 0 || !out[0]) return rc;
  rc = allow_smem<T, true>(out[2]);
  if (rc != 0) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, walk_kernel<T, true>, static_cast<int>(out[6]),
        static_cast<size_t>(out[2]));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (out[1] > resident) out[1] = resident;
  if (out[4] * out[1] > 0xffffffffLL)   // the barrier count's range
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int launch(T* x, const T* bhat, const int* cols, const T* vals, const T* dinv,
           const long long* tab_host, const long long* tab_dev,
           const int* lane_row, int S, int m, long long ldx, long long ldb,
           unsigned* bar, cudaStream_t stream) {
  if (S == 0 || m == 0) return 0;
  long long cfg[8], pcap = 0;
  int stage = 0;
  int rc = config<T>(tab_host, S, m, cfg, &stage, &pcap);
  if (rc != 0) return rc;
  Args<T> a{x, bhat, cols, vals, dinv, tab_dev, lane_row, bar, ldx, ldb, pcap,
            stage, S, m, m < kCols ? m : kCols, static_cast<int>(cfg[5]),
            static_cast<int>(cfg[3]), static_cast<int>(cfg[6])};
  if (!cfg[0]) {
    rc = allow_smem<T, false>(cfg[2]);
    if (rc != 0) return rc;
    walk_kernel<T, false><<<static_cast<unsigned>(cfg[1]),
                            static_cast<unsigned>(cfg[6]),
                            static_cast<size_t>(cfg[2]), stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(walk_kernel<T, true>),
      dim3(static_cast<unsigned>(cfg[1])), dim3(static_cast<unsigned>(cfg[6])), args,
      static_cast<size_t>(cfg[2]), stream));
}

}  // namespace walk

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

// The whole blocked solve: tab_host and tab_dev are one (S, 8) int64 table
// of rows (off, R, B, T, K, val_off, dinv_off, lane_off), on the host and
// on the card; bar one zeroed unsigned (the grid barrier's count).
extern "C" int trsm_block_walk_f32(float* x, const float* bhat, const int* cols,
                                   const float* vals, const float* dinv,
                                   const long long* tab_host,
                                   const long long* tab_dev, const int* lane_row,
                                   int S, int m, long long ldx, long long ldb,
                                   unsigned* bar, cudaStream_t stream) {
  return walk::launch<float>(x, bhat, cols, vals, dinv, tab_host, tab_dev,
                             lane_row, S, m, ldx, ldb, bar, stream);
}

extern "C" int trsm_block_walk_f64(double* x, const double* bhat, const int* cols,
                                   const double* vals, const double* dinv,
                                   const long long* tab_host,
                                   const long long* tab_dev, const int* lane_row,
                                   int S, int m, long long ldx, long long ldb,
                                   unsigned* bar, cudaStream_t stream) {
  return walk::launch<double>(x, bhat, cols, vals, dinv, tab_host, tab_dev,
                              lane_row, S, m, ldx, ldb, bar, stream);
}

// The launch a walk of this table at m columns makes on the current card:
// out = {cooperative, grid blocks, shared bytes, stages, grid barriers,
// column groups, threads per block, segments whose panel stays in global
// memory}.  Returns -2 where one diagonal block's Dinv stage does not fit.
extern "C" int trsm_block_walk_config_f32(const long long* tab, int S, int m,
                                          long long* out) {
  int stage;
  long long pcap;
  return walk::config<float>(tab, S, m, out, &stage, &pcap);
}

extern "C" int trsm_block_walk_config_f64(const long long* tab, int S, int m,
                                          long long* out) {
  int stage;
  long long pcap;
  return walk::config<double>(tab, S, m, out, &stage, &pcap);
}
